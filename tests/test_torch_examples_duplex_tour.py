"""``python -m repro_torch.examples.duplex_tour`` against the reference's
``examples/duplex_tour.py``, which is imported by its file path and runs
on the CPU beside it.

* Layers 0 and 3 (the channel curve, the moment-stream plans) are
  modelled arithmetic: the same lines, character for character.
* Layer 1 (the simulator on 8 identical phased streams) runs both at 128
  steps, where ``tests/test_torch_scheduler.py`` knows the tolerance of
  identical lockstep streams under ``timeseries``: GB/s within
  ``LOCKSTEP_RTOL`` (5e-4), the both-directions-busy share exactly, the
  same lines. At the example's own 1024 steps the jitted reference and
  the port part on ``timeseries`` (48.79 against 48.27 GB/s, 1.07e-2
  relative; both-busy 78.2 % against 73.9 %): XLA's reciprocal
  multiplies and fused multiply-adds break the identical streams' ties
  another way, as ROADMAP Queue 3 describes; the other three policies
  agree within 1e-6 there.
* Layer 2 gets the reference's own streams (its ``jax.random`` draws):
  the fused route equals the phase-separated pair, and the fused outputs
  equal the reference's within ``tests/test_kernels.py``'s tolerances
  (dequant exact, scales within rtol 1e-6, int8 within 1 LSB). Its first
  line is the reference's; the TPU sentence after it is not carried over
  (on a GPU the port prints both routes' device times instead).
* The port's example runs whole with ``--device cpu`` as a user runs it,
  in a subprocess, and prints its closing line.
"""

import contextlib
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.examples import duplex_tour as tour  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOCKSTEP_RTOL = 5e-4
SIM_STEPS = 128


@pytest.fixture(scope="module")
def ref_tour():
    spec = importlib.util.spec_from_file_location(
        "reference_duplex_tour", ROOT / "examples" / "duplex_tour.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> tuple[list[str], object]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*args)
    return out.getvalue().splitlines(), ret


@pytest.mark.parametrize("layer", ["layer0", "layer3"])
def test_modelled_layers_print_the_reference_lines(ref_tour, layer):
    want, _ = _printed(getattr(ref_tour, layer))
    got, _ = _printed(getattr(tour, layer))
    assert got == want and len(got) >= 3


def test_layer1_near_the_reference(ref_tour, monkeypatch):
    """Both at SIM_STEPS: the reference's ``simulate`` results captured
    as its example calls it."""
    results = []

    def simulate(*args, **kw):
        results.append(jsched.simulate(*args, **kw))
        return results[-1]

    monkeypatch.setattr(ref_tour, "sched", types.SimpleNamespace(
        simulate=simulate,
        SimConfig=lambda steps: jsched.SimConfig(steps=SIM_STEPS)))
    want_lines, _ = _printed(ref_tour.layer1)
    got_lines, got = _printed(tour.layer1, torch.device("cpu"), SIM_STEPS)
    assert got_lines == want_lines
    assert list(got) == list(tour.POLICIES) and len(results) == 4
    for policy, res in zip(tour.POLICIES, results):
        gbps, both = got[policy]
        assert gbps == pytest.approx(float(res.achieved_gbps()),
                                     rel=LOCKSTEP_RTOL)
        assert both == float(jnp.mean(jnp.logical_and(
            res.moved_read > 1, res.moved_write > 1)))
    # Algorithm 1's point: the duplex-aware policies keep both directions
    # busy far more often than CFS on the lockstep workload
    assert got["threshold"][1] > 10 * got["cfs"][1]


def test_layer2_fused_equals_split_and_the_reference(ref_tour):
    key = jax.random.PRNGKey(0)          # the reference's layer-2 streams
    in_x = jax.random.normal(key, (8, 64, 256))
    jq, js = jref.quantize_int8(in_x)
    jout = jax.random.normal(jax.random.fold_in(key, 1),
                             (8, 64, 256)).astype(jnp.bfloat16)
    want = jops.duplex_kv_stream(jq, js, jout, fused=True)
    streams = (torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)),
               torch.from_numpy(np.asarray(jout, np.float32)).to(
                   torch.bfloat16))
    assert tuple(streams[0].shape) == tour.STREAM_SHAPE
    ref_lines, _ = _printed(ref_tour.layer2)
    lines, got = _printed(tour.layer2, *streams)
    assert lines[:2] == ref_lines[:2]
    assert got["same"] and got["bytes"] == jq.nbytes + jout.nbytes
    deq, q, scale = got["fused"]
    np.testing.assert_array_equal(deq.float().numpy(),
                                  np.asarray(want[0], np.float32))
    np.testing.assert_allclose(scale.numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    assert np.abs(q.numpy().astype(np.int32)
                  - np.asarray(want[1]).astype(np.int32)).max() <= 1
    assert "not measured" in lines[2]


def test_stream_inputs_are_seeded_and_shaped():
    a = tour.stream_inputs(torch.device("cpu"))
    b = tour.stream_inputs(torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [t.dtype for t in a] == [torch.int8, torch.float32,
                                    torch.bfloat16]
    assert tuple(a[1].shape) == (*tour.STREAM_SHAPE[:2], 1)


def test_runs_whole_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")   # one thread beside the workers
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.duplex_tour",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("   64 GB of Adam moments: duplex")
    assert "fused == phase-separated: True" in out.stdout
