"""Port's host-side core against the JAX package: channel presets and
the scalar bandwidth curve, duplex/serial paging plans and their modelled
microseconds (exactly equal), hint resolution, CAX attribution, and the
six admission policies of the registry (weights and state within rtol
1e-6, the same admission order) and ``migration_volume``."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jchannel  # noqa: E402
from repro.core import hints as jhints  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.serve import queue as jqueue  # noqa: E402
from repro_torch.core import channel, hints, offload, policies, telemetry  # noqa: E402
from repro_torch.serve import queue  # noqa: E402


# -- channel ----------------------------------------------------------------

def test_presets_equal_reference():
    for name, c in jchannel.PRESETS.items():
        assert dataclasses.asdict(channel.PRESETS[name]) == \
            dataclasses.asdict(c)
    for kind, c in jchannel.TIER_PRESETS.items():
        assert dataclasses.asdict(channel.TIER_PRESETS[kind]) == \
            dataclasses.asdict(c)
    assert channel.BYTES_PER_GB == jchannel.BYTES_PER_GB


@pytest.mark.parametrize("name", sorted(jchannel.PRESETS))
def test_bandwidth_curve_and_peak_equal_reference(name):
    jc, tc = jchannel.PRESETS[name], channel.PRESETS[name]
    for r in np.linspace(0.0, 1.0, 23):
        for seq in (False, True):
            assert channel.effective_bandwidth_scalar(tc, r, seq) == \
                jchannel.effective_bandwidth_scalar(jc, r, seq)
    assert channel.peak_read_fraction(tc) == \
        jchannel.duplex_benefit(jc)["peak_read_fraction"]


# -- offload plans ----------------------------------------------------------

def _plans(seed):
    """Random paging transactions: page-ins into free + evicted slots."""
    rng = np.random.default_rng(seed)
    n_out = int(rng.integers(0, 9))
    n_free = int(rng.integers(0, 5))
    slots = rng.permutation(32)
    evict = slots[:n_out].tolist()
    free = slots[n_out:n_out + n_free].tolist()
    n_in = int(rng.integers(0, n_out + n_free + 1))
    needed = rng.permutation(100)[:n_in].tolist()
    host_dst = rng.permutation(100)[:n_out].tolist()
    return dict(needed_host_blocks=needed, evict_hbm_blocks=evict,
                free_hbm_blocks=free, host_dst_blocks=host_dst,
                block_bytes=float(rng.choice([2048.0, 368640.0])))


def _slots(plan):
    def tr(t):
        return None if t is None else (t.direction, t.src_block,
                                       t.dst_block, t.nbytes, t.hint_path)
    return [(tr(s.page_in), tr(s.page_out)) for s in plan.slots]


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("path", ["/serve/kv_cache", "/serve/llm/prefill"])
def test_plan_kv_paging_equal_reference(seed, path):
    kw = _plans(seed)
    jeng = joffload.DuplexOffloadEngine(
        hints=jhints.default_serving_hints())
    teng = offload.DuplexOffloadEngine(hints=hints.default_serving_hints())
    jp = jeng.plan_kv_paging(**kw, hint_path=path)
    tp = teng.plan_kv_paging(**kw, hint_path=path)
    assert _slots(tp) == _slots(jp) and tp.policy == jp.policy
    assert tp.modelled_time_us() == jp.modelled_time_us()
    js = joffload.plan_serial([s.page_in for s in jp.slots if s.page_in],
                              [s.page_out for s in jp.slots if s.page_out],
                              jeng.link)
    ts = offload.plan_serial([s.page_in for s in tp.slots if s.page_in],
                             [s.page_out for s in tp.slots if s.page_out],
                             teng.link)
    assert _slots(ts) == _slots(js)
    assert ts.modelled_time_us() == js.modelled_time_us()


def test_channel_times_equal_reference():
    rng = np.random.default_rng(0)
    for name in jchannel.PRESETS:
        for _ in range(5):
            rb, wb = (float(x) for x in rng.integers(0, 10**7, 2))
            assert offload.channel_time_us(channel.PRESETS[name], rb, wb) \
                == joffload.channel_time_us(jchannel.PRESETS[name], rb, wb)
            assert offload.phase_separated_time_us(
                channel.PRESETS[name], rb, wb) == \
                joffload.phase_separated_time_us(
                    jchannel.PRESETS[name], rb, wb)


# -- hints & telemetry -------------------------------------------------------

def test_hint_resolutions_equal_reference():
    """Compare resolutions themselves (``tier`` stays None where no scope
    sets one: derive-at-placement semantics)."""
    jt, tt = jhints.default_serving_hints(), hints.default_serving_hints()
    paths = list(jt.paths()) + ["/", "/serve/kv_cache/page_in/x",
                                "/serve/llm/decode", "/unknown/scope"]
    assert list(tt.paths()) == list(jt.paths())
    for p in paths:
        jr, tr = jt.resolve(p).resolved(), tt.resolve(p).resolved()
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr), p
        assert hints.preferred_tier(tt.resolve(p)) == \
            jhints.preferred_tier(jt.resolve(p))
    assert tt.resolve("/").resolved().tier is None


def test_cax_attribution_equal_reference():
    jr, tr = jtelemetry.CaxRegistry(), telemetry.CaxRegistry()
    for path, rb, wb in [("/serve/kv_cache", 1e6, 2e6),
                         ("/serve/kv_cache/page_in", 5.0, 0.0),
                         ("/train/x/y", 0.0, 3.5)]:
        jr.attribute(path, read_bytes=rb, write_bytes=wb)
        tr.attribute(path, read_bytes=rb, write_bytes=wb)
    assert tr.to_dict() == jr.to_dict()


# -- policies -----------------------------------------------------------------

def _obs(rng, S, jax_side):
    """One random observation, the same numbers for both packages."""
    arr = {
        "backlog_read": rng.random(S) * (rng.random(S) > 0.3) * 1e6,
        "backlog_write": rng.random(S) * (rng.random(S) > 0.3) * 1e6,
        "arrival_read": rng.random(S) * 1e4,
        "arrival_write": rng.random(S) * 1e4,
        "head_read": rng.random(S) * (rng.random(S) > 0.5) * 1e5,
        "head_write": rng.random(S) * 1e5,
        "prev_weights": np.zeros(S),
        "hint_rf": rng.choice([0.05, 0.5, 0.85, 0.95], S),
        "hint_priority": rng.choice([0.5, 1.0, 2.0], S),
    }
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    opt_in = rng.random(S) > 0.3
    util, opt_r = np.float32(rng.random()), np.float32(0.5)
    if jax_side:
        return jpolicies.Obs(
            step=jnp.int32(0), prev_util=jnp.float32(util),
            opt_r=jnp.float32(opt_r), duplex=jnp.asarray(True),
            hint_opt_in=jnp.asarray(opt_in),
            **{k: jnp.asarray(v) for k, v in arr.items()})
    return policies.Obs(
        step=torch.tensor(0, dtype=torch.int32),
        prev_util=torch.tensor(util), opt_r=torch.tensor(opt_r),
        duplex=torch.tensor(True), hint_opt_in=torch.from_numpy(opt_in),
        **{k: torch.from_numpy(v) for k, v in arr.items()})


def _leaves(state):
    """A policy state's leaves: a tuple's members, or the state itself
    (``round_robin``'s bare int32 offset)."""
    return list(state) if isinstance(state, tuple) else [state]


def test_registry_equals_reference():
    assert list(policies.REGISTRY) == list(jpolicies.REGISTRY)


@pytest.mark.parametrize("name", list(jpolicies.REGISTRY))
def test_policy_weights_equal_reference(name):
    S = 12
    jpol, tpol = jpolicies.get_policy(name), policies.get_policy(name)
    jparams, tparams = jpolicies.PolicyParams(), policies.PolicyParams()
    js, ts = jpol.init(jparams, S), tpol.init(tparams, S)
    js = jpolicies.seed_read_fraction(js, 3, 0.95)
    ts = policies.seed_read_fraction(ts, 3, 0.95)
    jschedule = jax.jit(functools.partial(jpol.schedule, jparams))
    jfold = jax.jit(functools.partial(jpolicies.fold_feedback, jpol,
                                      jparams))
    for step in range(10):
        rng_j, rng_t = (np.random.default_rng(step) for _ in range(2))
        js, jw = jschedule(js, _obs(rng_j, S, True))
        ts, tw = tpol.schedule(tparams, ts, _obs(rng_t, S, False))
        jw, tw = np.asarray(jw), tw.numpy()
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
        # same admission order (weight desc, index as the FIFO stand-in)
        assert sorted(range(S), key=lambda i: (-tw[i], i)) == \
            sorted(range(S), key=lambda i: (-jw[i], i))
        moved = np.random.default_rng(100 + step).random((3, S)).astype(
            np.float32)
        jfb = [jpolicies.Feedback(moved_read=m, moved_write=m[::-1].copy(),
                                  utilization=np.float32(0.5))
               for m in moved]
        tfb = [policies.Feedback(moved_read=m, moved_write=m[::-1].copy(),
                                 utilization=np.float32(0.5))
               for m in moved]
        js = jfold(js, jpolicies.stack_feedbacks(jfb))
        ts = policies.fold_feedback(tpol, tparams, ts,
                                    policies.stack_feedbacks(tfb))
    jl, tl = _leaves(js), _leaves(ts)
    assert len(tl) == len(jl)
    for j, t in zip(jl, tl):
        assert np.asarray(t).dtype == np.asarray(j).dtype
        np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)


def test_round_robin_rotation_wraps_and_survives_slot_reset():
    """round_robin's offset: ``arange - state`` goes negative and must
    wrap as ``jnp``'s floored ``%`` does; the slot reset leaves the bare
    scalar state as it is."""
    S = 6
    tpol, jpol = policies.get_policy("round_robin"), \
        jpolicies.get_policy("round_robin")
    tparams, jparams = policies.PolicyParams(), jpolicies.PolicyParams()
    ts, js = tpol.init(tparams, S), jpol.init(jparams, S)
    for step in range(5):
        ts, tw = tpol.schedule(tparams, ts, _obs(
            np.random.default_rng(step), S, False))
        js, jw = jpol.schedule(jparams, js, _obs(
            np.random.default_rng(step), S, True))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert int(ts) == int(js) and ts.dtype == torch.int32
    mask = torch.zeros(S, dtype=torch.bool)
    mask[1] = True
    assert policies.reset_slots(tpol, tparams, S, ts, mask) is ts


@pytest.mark.parametrize("seed", range(4))
def test_migration_volume_equals_reference(seed):
    rng = np.random.default_rng(seed)
    prev, w = rng.random((2, 12)).astype(np.float32)
    got = policies.migration_volume(torch.from_numpy(prev),
                                    torch.from_numpy(w))
    want = jpolicies.migration_volume(jnp.asarray(prev), jnp.asarray(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("policy", list(jpolicies.REGISTRY))
def test_queue_admission_order_equal_reference(policy):
    """Random requests through both waiting rooms: the same admissions
    at the same steps, in the same order."""
    rng = np.random.default_rng(11)
    jq = jqueue.RequestQueue(8, policy=policy, kv_bytes_per_token=4096.0)
    tq = queue.RequestQueue(8, policy=policy, kv_bytes_per_token=4096.0)
    jreqs, treqs = {}, {}
    for i in range(14):
        plen, gen = int(rng.integers(1, 40)), int(rng.integers(1, 60))
        arrival = int(rng.integers(0, 10))
        path = str(rng.choice(["/serve/llm/prefill", "/serve/llm/decode",
                               "/serve/kv_cache"]))
        prompt = np.zeros(plen, np.int32)
        if len(jq) < 8:
            jr = jq.submit(jqueue.Request(prompt, gen, arrival, path))
            tr = tq.submit(queue.Request(prompt, gen, arrival, path))
            jreqs[jr.rid], treqs[tr.rid] = i, i
        for now in range(i // 2, i // 2 + 2):
            budget = int(rng.integers(0, 3))
            ja = [jreqs[r.rid] for r in jq.dispatch(now, budget)]
            ta = [treqs[r.rid] for r in tq.dispatch(now, budget)]
            assert ta == ja
        if ja:
            fb = [jpolicies.Feedback(np.zeros(8, np.float32),
                                     np.zeros(8, np.float32),
                                     np.float32(0.25))] * 2
            tfb = [policies.Feedback(np.zeros(8, np.float32),
                                     np.zeros(8, np.float32),
                                     np.float32(0.25))] * 2
            jq.note_service(jpolicies.stack_feedbacks(fb), mean_util=0.25)
            tq.note_service(policies.stack_feedbacks(tfb), mean_util=0.25)
    assert len(tq) == len(jq)
