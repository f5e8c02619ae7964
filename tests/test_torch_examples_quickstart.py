"""``python -m repro_torch.examples.quickstart`` against the reference's
``examples/quickstart.py``, imported by its file path and run on the CPU
beside it, act for act.

* Act 1 (each preset's duplex benefit) is modelled arithmetic: the same
  lines, character for character.
* Act 2 (the ``cfs`` / ``timeseries`` A/B on 8 identical phased streams)
  runs both at 128 steps, where ``tests/test_torch_scheduler.py`` knows
  the tolerance of identical lockstep streams under ``timeseries``: every
  summary within ``LOCKSTEP_RTOL`` (5e-4), switches equal, the same
  lines; ``timeseries``' migration (weight moved between streams) is
  not held, since a slot handed to another of the identical streams is a
  move the other run does not make (30 against 28 here). At the act's own 1024 steps the jitted reference and the port
  part on ``timeseries`` by 1.07e-2 in GB/s (XLA's reciprocal multiplies
  and fused multiply-adds break the identical streams' ties another way;
  ROADMAP Queue 3); ``cfs`` agrees exactly.
* Act 3 trains smollm-135m's SMOKE config in float32 from the same
  weights (the reference trainer's seed-0 init, converted by
  ``params_from_jax``) for the act's 30 steps, then serves it: loss at
  step 0 within 1e-4 relative and later steps within 1e-3
  (``tests/test_torch_train_cli.py``'s bounds), the parameter line, the
  served tokens, steps and host dispatches equal.
* The port's example runs whole with ``--device cpu`` in a subprocess
  and prints its device line first and its closing line last.
"""

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

from repro.core import scheduler as jsched  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro_torch.examples import quickstart as qs  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOCKSTEP_RTOL = 5e-4
SIM_STEPS = 128


@pytest.fixture(scope="module")
def ref_qs():
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> tuple[list[str], object]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return out.getvalue().splitlines(), ret


def test_act1_prints_the_reference_lines(ref_qs):
    want, _ = _printed(ref_qs.act1_characterize)
    got, _ = _printed(qs.act1_characterize)
    assert got == want and len(got) == 6


def test_act2_near_the_reference(ref_qs, monkeypatch):
    """Both at SIM_STEPS; the reference's ``compare_policies`` results
    captured as its example calls it."""
    results = []

    def compare_policies(*args, **kw):
        results.append(jsched.compare_policies(*args, **kw))
        return results[-1]

    monkeypatch.setattr(ref_qs, "sched", types.SimpleNamespace(
        compare_policies=compare_policies, improvement=jsched.improvement,
        SimConfig=lambda steps: jsched.SimConfig(steps=SIM_STEPS)))
    want_lines, _ = _printed(ref_qs.act2_schedule)
    got_lines, got = _printed(qs.act2_schedule, torch.device("cpu"),
                              SIM_STEPS)
    assert got_lines == want_lines
    (want,) = results
    assert set(got) == set(want) == {"cfs", "timeseries"}
    for policy in want:
        assert got[policy]["switches"] == want[policy]["switches"]
        for key, value in want[policy].items():
            if key == "migration" and policy == "timeseries":
                continue        # another identical stream's slot: 30 / 28
            assert got[policy][key] == pytest.approx(
                value, rel=LOCKSTEP_RTOL, abs=1e-9), (policy, key)


@pytest.fixture(scope="module")
def act3(ref_qs):
    """Act 3 in both packages, float32, from the same weights."""
    japi0 = R.build(qs.ARCH, smoke=True)
    japi = R._lm_api(qs.ARCH, dataclasses.replace(japi0.cfg,
                                                  dtype=jnp.float32))
    hists = []

    class Recording(ref_qs.Trainer):
        def run(self, *args, **kw):
            out = super().run(*args, **kw)
            hists.append(out[2])
            return out

    saved = ref_qs.R, ref_qs.Trainer
    ref_qs.R = types.SimpleNamespace(build=lambda arch, smoke: japi)
    ref_qs.Trainer = Recording
    try:
        want_lines, _ = _printed(ref_qs.act3_train_and_serve)
    finally:
        ref_qs.R, ref_qs.Trainer = saved

    jp = japi.init(jax.random.PRNGKey(0))      # the trainer's seed-0 init
    tcfg = dataclasses.replace(TR.build(qs.ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(qs.ARCH, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    got_lines, got = _printed(qs.act3_train_and_serve, tapi, tp)
    return want_lines, hists[0], got_lines, got


def test_act3_losses_near_the_reference(act3):
    _, want, _, got = act3
    w = np.array([h["loss"] for h in want])
    g = np.array([h["loss"] for h in got["history"]])
    assert len(g) == len(w) == 30
    assert g[0] == pytest.approx(w[0], rel=1e-4)
    np.testing.assert_allclose(g[1:], w[1:], rtol=1e-3)
    assert g[-1] < g[0]


def test_act3_serves_the_reference_tokens(act3):
    want_lines, _, got_lines, got = act3
    assert got_lines[0] == want_lines[0]
    assert got_lines[1] == want_lines[1]            # the parameter line
    assert got_lines[-1] == want_lines[-1]          # tokens, steps
    assert got_lines[-1].startswith("  served 2x12 greedy tokens")
    np.testing.assert_array_equal(got["outs"][0], got["outs"][1])


def test_runs_whole_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")   # one thread beside the workers
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[-1].startswith("  served 2x12 greedy tokens")
