"""The port's stream simulator (``repro_torch.core.scheduler`` and the
simulator's half of ``core.channel``) against ``repro.core.scheduler``.

Tolerances, and why:

* ``effective_bandwidth``, ``duplex_benefit`` and the tape prefix sums are
  bit-equal. The prefix sums follow the order XLA's CPU backend adds a
  ``jnp.cumsum`` in (blocks of 16, block totals summed recursively); a
  sequential float32 sum differs in the last bits past 2^24.
* ``channel_step`` and ``simulate`` are bit-equal to the reference run op
  by op (``jax.disable_jit()``): the port does the reference's float32
  operations in its order. The one exception is ``exp``: XLA's and
  PyTorch's differ in the last bit, which shows only where weights stay
  continuous (``discrete_slots=False``) under the two policies that use it.
* Against the reference as it runs, one jitted program, the port is not
  bit-equal: XLA turns divisions by the channel's constant capacities into
  multiplies by their float32 reciprocals and contracts ``a * b + c`` into
  fused multiply-adds. ``channel_step`` stays within 4 float32 ulps. Over
  a run these last bits decide ties only where streams are identical and
  in lockstep (the phased microbenchmark under ``timeseries``): a run slot
  then goes to another of the identical streams, so the per-step series
  part while the run's totals stay within ``LOCKSTEP_RTOL``. Everywhere
  else the same streams run at every step (weights, migration and
  switches equal) and the series stay within ``SERIES_ATOL`` of their
  largest value, the summaries within ``SUMMARY_RTOL``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.llm_inference import _decode_specs, _prefill_specs  # noqa: E402
from benchmarks.microbench import RATIOS  # noqa: E402
from benchmarks.microbench import _specs as micro_specs  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import requests as jreq  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import requests as treq  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402

POLICIES = ("cfs", "ddr_batching", "round_robin", "threshold",
            "timeseries", "hinted")
SUMMARY_RTOL = 1e-5
SERIES_ATOL = 1e-4
LOCKSTEP_RTOL = 5e-4
FIELDS = ("name", "pattern", "offered_gbps", "read_fraction",
          "phase_steps", "block_bytes", "sequential")


def _port_specs(specs):
    return [treq.StreamSpec(**{f: getattr(s, f) for f in FIELDS})
            for s in specs]


def _port_sim(sim):
    return tsched.SimConfig(**dataclasses.asdict(sim))


def _ref_summary(res) -> dict:
    """``compare_policies``' fields of one reference result."""
    return {"gbps": float(res.achieved_gbps()),
            "read_gbps": float(res.read_gbps()),
            "write_gbps": float(res.write_gbps()),
            "mean_latency_us": float(res.mean_latency_us()),
            "p99_latency_us": float(res.p99_latency_us()),
            "switches": int(res.switches),
            "migration": float(jnp.sum(res.migration))}


def _run_both(channel, specs, policy, sim, jit=True):
    if jit:
        want = jsched.simulate(channel, specs, policy, sim=sim)
    else:
        with jax.disable_jit():
            want = jsched.simulate(channel, specs, policy, sim=sim)
    got = tsched.simulate(tch.PRESETS[channel.name], _port_specs(specs),
                          policy, sim=_port_sim(sim), device="cpu")
    return want, got


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps (signed zeros equal)."""
    def ordered(x):
        i = (np.asarray(x, np.float32) + np.float32(0)).view(np.int32)
        return np.where(i < 0, -(i.astype(np.int64) & 0x7FFFFFFF),
                        i.astype(np.int64))
    return int(np.max(np.abs(ordered(a) - ordered(b)), initial=0))


# -- the channel model --------------------------------------------------------

@pytest.mark.parametrize("name", list(jch.PRESETS))
def test_curves_equal_reference(name):
    rs = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    for seq in (False, True):
        want = np.asarray(jch.effective_bandwidth(jch.PRESETS[name], rs,
                                                  seq))
        got = tch.effective_bandwidth(tch.PRESETS[name],
                                      torch.from_numpy(rs), seq)
        np.testing.assert_array_equal(got.numpy(), want)
        assert tch.duplex_benefit(tch.PRESETS[name], seq) == \
            jch.duplex_benefit(jch.PRESETS[name], seq)
        assert tch.PRESETS[name].bytes_per_step(seq) == \
            jch.PRESETS[name].bytes_per_step(seq)
    assert tch.peak_read_fraction(tch.PRESETS[name]) == \
        jch.duplex_benefit(jch.PRESETS[name])["peak_read_fraction"]


@pytest.mark.parametrize("name", ["cxl-512gb", "cxl-256gb", "ddr5-local",
                                  "hbm-v5e"])
def test_channel_step_equals_reference(name):
    """Seeded demand, ties (want_read == want_write) and negative and
    zero demand included: bit-equal op by op, within 4 ulps of the jitted
    step (none for the half-duplex bus)."""
    rng = np.random.default_rng(5)
    for seq in (False, True):
        jp = jch.channel_params(jch.PRESETS[name], seq)
        tp = tch.channel_params(tch.PRESETS[name], seq)
        assert tp.duplex == jch.PRESETS[name].duplex
        jitted = jax.jit(lambda s, r, w: jch.channel_step(jp, s, r, w))
        js = jch.init_channel_state()
        ts = tch.init_channel_state()
        worst = 0
        for i in range(120):
            r, w = (rng.uniform(-2e4, 4e5, 2)
                    * (rng.uniform() < 0.9)).astype(np.float32)
            if i % 7 == 0:
                w = r
            with jax.disable_jit():
                js2, jr, jw = jch.channel_step(jp, js, jnp.float32(r),
                                               jnp.float32(w))
            _, kr, kw = jitted(js, jnp.float32(r), jnp.float32(w))
            ts, tr, tw = tch.channel_step(tp, ts, torch.tensor(r),
                                          torch.tensor(w))
            for a, b in zip(js2, ts):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
            worst = max(worst, _ulps(kr, tr), _ulps(kw, tw))
            js = js2
        assert worst <= (4 if jch.PRESETS[name].duplex else 0)


@pytest.mark.parametrize("make,steps", [
    (lambda: _decode_specs(120.0), 2304),
    (lambda: micro_specs("gaussian", 0.3), 3072),
    (lambda: _prefill_specs(), 100)])
def test_prefix_sums_equal_jnp_cumsum(make, steps):
    arr = np.asarray(jreq.generate(make(), steps, 0))
    want = np.asarray(jnp.cumsum(jnp.asarray(arr), 0))
    np.testing.assert_array_equal(tsched._prefix_sums(arr), want)
    assert not np.array_equal(np.cumsum(arr, 0, dtype=np.float32), want) \
        or steps < 2304


# -- the simulator, op by op --------------------------------------------------

MIXED = [jreq.StreamSpec(name=f"s{i}", pattern=p, offered_gbps=12.0,
                         read_fraction=rf, phase_steps=4)
         for i, (p, rf) in enumerate([("phased", 0.5), ("llm_decode", 0.5),
                                      ("gaussian", 0.3), ("uniform", 0.9)])]


@pytest.mark.parametrize("policy,channel,extra", [
    *[(p, "cxl-512gb", {}) for p in POLICIES],
    ("hinted", "ddr5-local", {}),
    ("threshold", "ddr5-local", {"closed_loop": False}),
    ("cfs", "cxl-512gb", {"closed_loop": False}),
    ("timeseries", "cxl-512gb", {"discrete_slots": False}),
])
def test_simulate_equals_reference_op_by_op(policy, channel, extra):
    sim = jsched.SimConfig(steps=4, **extra)
    want, got = _run_both(jch.PRESETS[channel], MIXED, policy, sim,
                          jit=False)
    for f in jsched.SimResult._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "weights" and not sim.discrete_slots:
            assert _ulps(w, g) <= 1, f      # XLA's exp against PyTorch's
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


# -- the simulator against the jitted reference --------------------------------

def _check_near(want, got, lockstep: bool):
    ws, gs = _ref_summary(want), tsched.summarize(got)
    assert gs["switches"] == ws["switches"]
    rtol = LOCKSTEP_RTOL if lockstep else SUMMARY_RTOL
    for key in ws:
        assert gs[key] == pytest.approx(ws[key], rel=rtol, abs=1e-9), key
    w, g = np.asarray(want.weights), got.weights.numpy()
    if lockstep:
        # another of the identical streams may run: as many slots a step
        np.testing.assert_array_equal(g.sum(1), w.sum(1))
        return
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.migration.numpy(),
                                  np.asarray(want.migration))
    for f in ("moved_read", "moved_write", "utilization", "backlog_total"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=SERIES_ATOL * np.abs(w).max(),
                                   err_msg=f)


@pytest.mark.parametrize("phase,steps", [("prefill", 256), ("decode", 256),
                                         ("decode", 768)])
def test_llm_inference_comparisons_near_reference(phase, steps):
    """``benchmarks/llm_inference.py``'s two policy A/Bs."""
    specs = _prefill_specs() if phase == "prefill" else _decode_specs(120.0)
    sim = jsched.SimConfig(steps=steps)
    for policy in ("cfs", "hinted"):
        _check_near(*_run_both(jch.CXL_512, specs, policy, sim), False)
    want = jsched.compare_policies(jch.CXL_512, specs, ("cfs", "hinted"),
                                   sim=sim)
    got = tsched.compare_policies(tch.CXL_512, _port_specs(specs),
                                  ("cfs", "hinted"), sim=_port_sim(sim),
                                  device="cpu")
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
    assert tsched.improvement(got, "hinted", "cfs") == pytest.approx(
        jsched.improvement(want, "hinted", "cfs"), rel=1e-3, abs=1e-6)


@pytest.mark.parametrize("pattern", ["phased", "gaussian"])
def test_microbench_sweep_near_reference(pattern):
    """``benchmarks/microbench.py``'s sweep over ``RATIOS``; its phased
    streams are identical and share one phase clock."""
    sim = jsched.SimConfig(steps=128, sequential=pattern == "phased")
    for rf in RATIOS:
        specs = micro_specs(pattern, rf)
        for policy in ("cfs", "timeseries"):
            _check_near(*_run_both(jch.CXL_512, specs, policy, sim),
                        pattern == "phased" and policy == "timeseries")


@pytest.mark.parametrize("name", list(jch.PRESETS))
def test_characterization_crosscheck_near_reference(name):
    """``benchmarks/characterization.py``'s simulator cross-check, for
    every preset: four overloading uniform streams under ``cfs``."""
    c = jch.PRESETS[name]
    specs = [jreq.StreamSpec(name=f"w{i}", pattern="uniform",
                             offered_gbps=c.read_bw, read_fraction=0.55)
             for i in range(4)]
    _check_near(*_run_both(c, specs, "cfs", jsched.SimConfig(steps=128)),
                False)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("extra", [{}, {"closed_loop": False},
                                   {"discrete_slots": False}])
def test_every_policy_near_reference(policy, extra):
    sim = jsched.SimConfig(steps=128, **extra)
    _check_near(*_run_both(jch.CXL_512, _decode_specs(120.0), policy, sim),
                False)


# -- the reference's own properties (tests/test_scheduler.py) -----------------

def _uniform(n, gbps, rf, pattern="uniform"):
    return [treq.StreamSpec(name=f"s{i}", pattern=pattern,
                            offered_gbps=gbps, read_fraction=rf)
            for i in range(n)]


def _sim(*args, **kw):
    return tsched.simulate(*args, device="cpu", **kw)


def _conservation(rng):
    for _ in range(4):
        n, gbps, rf = int(rng.integers(1, 7)), rng.uniform(1, 50), \
            rng.uniform()
        policy = ["cfs", "timeseries", "threshold",
                  "ddr_batching"][int(rng.integers(4))]
        sim = tsched.SimConfig(steps=128, closed_loop=False)
        res = _sim(tch.CXL_512, _uniform(n, gbps, rf), policy, sim=sim)
        served = float(torch.sum(res.moved_read + res.moved_write))
        offered = n * gbps * 1e3 * sim.steps
        assert served <= offered * 1.001
        assert abs(served + float(res.backlog_total[-1]) - offered) \
            / offered < 0.02


def _utilization_bounded(rng):
    for policy in ("cfs", "timeseries"):
        res = _sim(tch.CXL_512, _uniform(4, 30.0, rng.uniform()), policy,
                   sim=tsched.SimConfig(steps=128))
        assert float(res.utilization.max()) <= 1.001
        assert float(res.utilization.min()) >= 0.0


def _half_duplex_never_moves_both(rng):
    for rf in rng.uniform(0.1, 0.9, 3):
        res = _sim(tch.DDR5_LOCAL, _uniform(4, 30.0, rf), "cfs",
                   sim=tsched.SimConfig(steps=128, closed_loop=False))
        assert not bool(((res.moved_read > 0) & (res.moved_write > 0)).any())


def _light_load_is_served(rng):
    for policy in ("cfs", "timeseries", "threshold"):
        res = _sim(tch.CXL_512, _uniform(4, 2.0, 0.5), policy,
                   sim=tsched.SimConfig(steps=512))
        assert float(res.achieved_gbps()) > 0.9 * 8.0


def _peak_at_balanced_mix(rng):
    got = {rf: float(_sim(tch.CXL_512, _uniform(8, 20.0, rf), "timeseries",
                          sim=tsched.SimConfig(steps=512)).achieved_gbps())
           for rf in (0.0, 0.55, 1.0)}
    assert got[0.55] >= got[0.0]
    assert got[0.55] >= got[1.0] * 0.95


def _migration_charged(rng):
    res = _sim(tch.CXL_512, _uniform(8, 20.0, 0.5, pattern="phased"),
               "timeseries", sim=tsched.SimConfig(steps=256))
    assert float(torch.sum(res.migration)) >= 0.0


@pytest.mark.parametrize("prop", [
    _conservation, _utilization_bounded, _half_duplex_never_moves_both,
    _light_load_is_served, _peak_at_balanced_mix, _migration_charged],
    ids=lambda f: f.__name__.strip("_"))
def test_reference_properties_hold(prop):
    prop(np.random.default_rng(11))


# -- no fallback ---------------------------------------------------------------

def test_simulate_runs_on_the_cpu_only_when_asked():
    specs = _uniform(2, 10.0, 0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsched.simulate(tch.CXL_512, specs, "cfs",
                            sim=tsched.SimConfig(steps=8))
    with pytest.raises(ValueError, match="CUDA device"):
        tsched.simulate(tch.CXL_512, specs, "cfs",
                        sim=tsched.SimConfig(steps=8), device="cpu",
                        _graphs=True)
    res = tsched.simulate(tch.CXL_512, specs, "cfs",
                          sim=tsched.SimConfig(steps=8), device="cpu")
    assert res.moved_read.device.type == "cpu"
    assert res.weights.shape == (8, 2)
