"""``python -m repro_torch.examples.serve_offload`` against the
reference's ``examples/serve_offload.py``, imported by its file path and
run on the CPU beside it, both on llama3.2-3b's SMOKE config in float32
with the same weights (the reference's seed-0 init, converted by
``params_from_jax``), the same prompts and the same round-trip blocks
(the reference's ``jax.random`` draws).

Held exactly, as the printed lines: each request's arrival, admission
and done steps and its first tokens (float32: greedy tokens equal across
frameworks), the page-in / page-out and fused-call counts, the engine
steps, the modelled duplex and serial microseconds and their speedup,
and the check against the static-batch reference. The int8 round trip's
largest error: within one int8 step of the largest block's scale (the
port's int8 codes are within 1 LSB of the Pallas kernel's). Then the
port's example runs whole with ``--device cpu`` in a subprocess."""

import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as R  # noqa: E402
from repro_torch.examples import serve_offload as ex  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_offload", ROOT / "examples" / "serve_offload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    """Both examples' printed lines: the reference's ``main`` on its f32
    model, the port's ``serve`` and ``roundtrip`` on the same weights
    and inputs."""
    japi0 = R.build(ex.ARCH, smoke=True)
    japi = R._lm_api(ex.ARCH, dataclasses.replace(japi0.cfg,
                                                  dtype=jnp.float32))
    mod = _reference_example()
    mod.R = types.SimpleNamespace(build=lambda arch, smoke: japi)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    want = out.getvalue().splitlines()

    jp = japi.init(jax.random.PRNGKey(0))       # as the example draws it
    tcfg = dataclasses.replace(TR.build(ex.ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(ex.ARCH, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (6, 6), 0, japi.cfg.vocab))
    blocks = {b: torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(b), (8, 128)).astype(jnp.bfloat16),
        np.float32)).to(torch.bfloat16) for b in range(8)}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        served = ex.serve(tapi, tp, prompts)
        worst = ex.roundtrip(blocks, CPU)
        print("OK")
    return want, out.getvalue().splitlines(), served, worst, blocks


def test_schedule_paging_and_tokens_equal_the_reference(runs):
    want, got, served, _, _ = runs
    n = next(i for i, x in enumerate(want) if "int8 round-trip" in x)
    assert got[:n] == want[:n]
    assert served["ok"] and len(served["rids"]) == 6
    assert any(x.startswith("page-ins ") for x in got[:n])
    s = served["engine"].paging_stats()
    assert s["page_ins"] > 0 and s["page_outs"] > 0
    assert s["duplex_speedup"] > 1.0


def test_int8_roundtrip_within_one_step_of_the_reference(runs):
    want, got, _, worst, blocks = runs
    assert got[-1] == want[-1] == "OK"
    line = next(x for x in want if x.startswith("max int8-roundtrip"))
    ref_worst = float(line.rsplit(" ", 1)[1])
    step = max(float(x.float().abs().max()) for x in blocks.values()) / 127
    assert abs(worst - ref_worst) <= step
    assert 0 < worst <= step / 2 + 1e-2   # half an int8 step + bf16


def test_inputs_are_seeded():
    api = TR.build(ex.ARCH, smoke=True, device="cpu")
    np.testing.assert_array_equal(ex.prompts_for(api), ex.prompts_for(api))
    a, b = ex.roundtrip_blocks(CPU), ex.roundtrip_blocks(CPU)
    assert all(torch.equal(a[k], b[k]) for k in a) and len(a) == 8


def test_runs_whole_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")   # one thread beside the workers
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_offload",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "OK"
    assert "static-batch reference (first 2 reqs): True" in out.stdout
