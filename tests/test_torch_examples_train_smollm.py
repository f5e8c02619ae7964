"""``python -m repro_torch.examples.train_smollm`` against the
reference's ``examples/train_smollm.py``, imported by its file path and
run on the CPU beside it: its ``MID`` config (4 layers, d_model 192,
~2.36 M parameters) in float32, the same weights (the reference
trainer's seed-0 init, converted by ``params_from_jax``), ``STEPS``
steps of 4 x 32 tokens (``--steps 40 --seq-len 32 --global-batch 4``),
checkpoints into a temporary directory and the transient fault injected
at step ``STEPS // 2``.

Held: every step's loss, step 0 within 1e-4 relative and later steps
within 1e-3 (``tests/test_torch_train_cli.py``'s bounds); the fault's
retries exactly (``[20]``: the step is retried with the same batch and
no step is lost); the model line, and the first-10 / last-10 means
within the same 1e-3. Then the port's example runs whole with ``--device
cpu`` in a subprocess, loss falling, and prints ``OK``."""

import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import _lm_api as jlm_api  # noqa: E402
from repro_torch.examples import train_smollm as ex  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, BATCH = 40, 32, 4


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location(
        "reference_train_smollm", ROOT / "examples" / "train_smollm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.MID = dataclasses.replace(mod.MID, dtype=jnp.float32)
    trainers = []

    class Recording(mod.Trainer):
        def run(self, *args, **kw):
            out = super().run(*args, **kw)
            trainers.append((self, out[2]))
            return out

    mod.Trainer = Recording
    argv = sys.argv
    sys.argv = ["train_smollm", "--steps", str(STEPS), "--seq-len",
                str(SEQ), "--global-batch", str(BATCH)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    want_lines = out.getvalue().splitlines()
    (want_tr, want_hist), = trainers

    jp = jlm_api("smollm-135m", mod.MID).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(ex.MID, dtype=torch.float32)
    tapi = TR._lm_api("smollm-135m", tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    tr, hist = ex.train(tapi, STEPS, SEQ, BATCH, params=tp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        means = ex.report(tr, hist)
    return want_lines, want_tr, want_hist, tr, hist, means, \
        out.getvalue().splitlines()


def test_losses_near_the_reference(runs):
    _, _, want_hist, _, hist, _, _ = runs
    w = np.array([h["loss"] for h in want_hist])
    g = np.array([h["loss"] for h in hist])
    assert len(g) == len(w) == STEPS
    assert [h["step"] for h in hist] == [h["step"] for h in want_hist]
    assert g[0] == pytest.approx(w[0], rel=1e-4)
    np.testing.assert_allclose(g[1:], w[1:], rtol=1e-3)


def test_fault_retried_as_the_reference(runs):
    _, want_tr, _, tr, _, _, _ = runs
    assert tr.retried_steps == want_tr.retried_steps == [STEPS // 2]


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def test_report_near_the_reference(runs):
    want_lines, _, _, _, _, (first, last), got_lines = runs
    assert want_lines[0] == \
        f"model: {ex.MID.name}  params={ex.MID.param_count() / 1e6:.2f}M"
    assert want_lines[-1] == "OK"
    w = _numbers(next(x for x in want_lines if x.startswith("loss:")))
    g = _numbers(got_lines[0])
    np.testing.assert_allclose(g[:2], w[:2], rtol=1e-3)
    assert g[:2] == pytest.approx([first, last], abs=5e-4)
    assert last < first
    assert got_lines[1].startswith(f"fault retries: [{STEPS // 2}]")


def test_runs_whole_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")   # one thread beside the workers
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_smollm",
         "--device", "cpu", "--steps", "30", "--seq-len", "32",
         "--global-batch", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "model: smollm-10m  params=2.36M"
    assert lines[-1] == "OK"
    assert "fault retries: [15]" in out.stdout
