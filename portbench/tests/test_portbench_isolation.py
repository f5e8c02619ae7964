"""What the benchmark loads: never JAX, the JAX package or its
benchmarks, and the reference nothing of the program.

Each check imports in a fresh interpreter and reads ``sys.modules`` by
top-level name, compared whole (``repro_torch`` begins with ``repro``
and is not it)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def loaded_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` after ``code`` runs in a new
    interpreter with the checkout's root and ``src`` on the path."""
    prog = (f"import sys\nsys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_every_file_load_no_jax():
    code = """
import importlib
from portbench import spec
import portbench.run, portbench.loop, portbench.judge, portbench.devtrace
bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    spec.family(cell.config["family"])
    spec.reference(cell.config["family"])
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.metric_reader(m["name"])
for p in (spec.HERE / "metrics").glob("*.py"):
    spec.metric_reader(p.stem)
for p in (spec.HERE / "configs").glob("*.json"):
    spec.load_json(p)
for p in (spec.HERE / "workloads").glob("*.json"):
    spec.load_json(p)
for p in (spec.HERE / "traffic").glob("*.json"):
    spec.load_json(p)
# what a run imports of the program
import repro_torch.serve.engine, repro_torch.serve.queue
import repro_torch.models.registry, repro_torch.kernels.ops
"""
    loaded = loaded_after(code)
    assert "portbench" in loaded and "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"repro_torch", "portbench"} \
                    | FORBIDDEN, f"{path.name} imports {n}"
    loaded = loaded_after("import portbench.reference.transformer")
    assert "repro_torch" not in loaded
    assert not loaded & FORBIDDEN
