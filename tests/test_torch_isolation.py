"""The port stands alone: importing every ``repro_torch`` module (the
examples and the deprecated serving shims among them) pulls in neither
JAX nor the JAX package, ``chip_smoke.py`` imports neither, and every
entry point, each example too, runs on ``cuda`` unless told
``device="cpu"``."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = ("quickstart", "duplex_tour", "serve_offload",
            "multi_tenant_serve", "train_smollm")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        f"    if k.split('.')[0] in {FORBIDDEN!r})\n"
        "import json; print(json.dumps([mods, bad]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, check=True)
    mods, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(mods) >= 15
    assert bad == []
    # the tiered host pool, the fault layer, the simulator, the tracing
    # plane and the snapshot layer with its checkpoint writer are among
    # the scanned
    for m in ("repro_torch.core.prng", "repro_torch.core.faults",
              "repro_torch.serve.tiers", "repro_torch.core.scheduler",
              "repro_torch.core.metrics", "repro_torch.serve.trace",
              "repro_torch.serve.snapshot",
              "repro_torch.checkpoint.sharded"):
        assert m in mods
    # and the training slice: the data pipeline, the optimizers, the
    # trainer and its CLI
    for m in ("repro_torch.data.pipeline", "repro_torch.optim.adamw",
              "repro_torch.optim.host_offload", "repro_torch.runtime.train",
              "repro_torch.launch.train", "repro_torch.launch.steps"):
        assert m in mods
    # the examples and the deprecated serving shims
    for m in ("repro_torch.runtime.serve", "repro_torch.examples",
              *(f"repro_torch.examples.{name}" for name in EXAMPLES)):
        assert m in mods


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_port_imports_jax():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not _imports(f) & set(FORBIDDEN), f


def test_build_defaults_to_cuda():
    from repro_torch.models import registry
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.build("smollm-135m", smoke=True)
    assert registry.build("smollm-135m", smoke=True,
                          device="cpu").device.type == "cpu"


def test_cli_needs_a_gpu_unless_told_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    argv = ["serve", "--requests", "2", "--gen", "3", "--no-warmup"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main()
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    assert serve.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu"
    assert report["generated_tokens"] == 6
    assert report["paging"]["paged"] is True


def test_training_needs_a_gpu_unless_told_cpu(monkeypatch, capsys):
    """The trainer's entry points default to ``cuda``: the CLI and a
    ``Trainer`` over a default-built model raise without a GPU; with
    ``--device cpu`` / ``device="cpu"`` they train on the CPU."""
    from repro_torch.data import device_batch
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    argv = ["train", "--steps", "1", "--seq-len", "8", "--global-batch",
            "2"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main()
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    assert train.main() == 0
    assert capsys.readouterr().out.splitlines()[0].endswith("devices=1")
    import numpy as np
    batch = device_batch({"tokens": np.zeros((1, 2), np.int32)}, None,
                         "cpu")
    assert batch["tokens"].device.type == "cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_a_gpu_unless_told_cpu(name):
    """Each example's ``main`` raises without a GPU, as the CLIs do, before
    it prints anything; ``--device cpu`` is accepted (the examples' own
    test files run each one whole on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
    from repro_torch.examples import parse_device
    args, device = parse_device("", ["--device", "cpu"])
    assert args.device == "cpu" and device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
