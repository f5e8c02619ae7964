"""Port's fault layer against ``repro.core.faults`` and the reference
engine's fault hooks: ``parse_fault_plan``'s events and error messages,
``FaultEvent`` validation, ``random_plan`` for several seeds, the
injector's seeded retry draws, and the reference's fault scenarios
(``tests/test_faults.py``: transient retries, poison quarantine on tiered
and flat pools, offline evacuation, shedding, reclaim across migrations,
fixed-seed chaos schedules) served by the port and by the JAX engine with
smollm-135m in float32 on the same arguments: the same survivors' tokens,
failed records (submission index, kind, step and every field), fault
stats and ``paging_stats()``, all exactly. Survivors also equal the
port's fault-free run token for token."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.queue import FAILED  # noqa: E402

ARCH = "smollm-135m"
N_REQ, PROMPT_LEN, GEN = 4, 6, 12


# -- plans ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "offline:1@6,poison:3@4,degrade:0@2+8=0.5,transient:2@1+20=0.3",
    "crash:@7", " poison:0@0 ,, offline:2@40", "degrade:1@3+1=1"])
def test_parse_fault_plan_equals_reference(spec):
    got = tfaults.parse_fault_plan(spec)
    want = jfaults.parse_fault_plan(spec)
    assert [dataclasses.asdict(e) for e in got] == \
        [dataclasses.asdict(e) for e in want]


@pytest.mark.parametrize("bad", [
    "", "nonsense", "offline:@3", "degrade:0@2=0.5", "poison:1@2+3=0.5",
    "transient:0@1+5=1.5", "degrade:0@1+5=0", "crash:1@3", "crash:@3+2",
    "offline:x@2", "transient:0@4=0.2", "poison:-1@2", "offline:0@-1"])
def test_parse_fault_plan_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_fault_plan(bad)
    with pytest.raises(ValueError) as got:
        tfaults.parse_fault_plan(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(kind="poison", at_step=1), dict(kind="nope", at_step=1, channel=0),
    dict(kind="degrade", at_step=1, channel=0, factor=1.5, duration=4),
    dict(kind="transient", at_step=0, channel=1, p=1.0),
    dict(kind="offline", at_step=2), dict(kind="crash", at_step=-1)])
def test_fault_event_validation_equals_reference(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultEvent(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultEvent(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1, 7, 1347, 9021])
def test_random_plan_equals_reference(seed):
    for kw in (dict(n_channels=3, n_blocks=24, horizon=20, n_events=5),
               dict(n_channels=4, n_blocks=256, horizon=60),
               dict(n_channels=2, n_blocks=8, horizon=9, n_events=7,
                    kinds=jfaults.ALL_FAULT_KINDS)):
        got = tfaults.random_plan(seed, **kw)
        want = jfaults.random_plan(seed, **kw)
        assert [dataclasses.asdict(e) for e in got] == \
            [dataclasses.asdict(e) for e in want]
    assert tfaults.ALL_FAULT_KINDS == jfaults.ALL_FAULT_KINDS
    assert tfaults.fresh_fault_stats() == jfaults.fresh_fault_stats()


def test_injector_clock_and_retry_draws_equal_reference():
    """The same plan ticked side by side: armed windows, drains, the
    seeded retry draws and the shared stats, every transaction; a crash
    event raises ``CrashFault`` at its transaction in both."""
    spec = ("degrade:0@1+4=0.5,transient:1@2+30=0.45,poison:3@3,"
            "offline:2@5,transient:0@6+3=0.9,crash:@40")
    inj = {m: m.FaultInjector(m.parse_fault_plan(spec), seed=11)
           for m in (jfaults, tfaults)}
    for step in range(40):
        out = {}
        for m, fx in inj.items():
            fx.tick()
            out[m] = (fx.step, [fx.bandwidth_factor(c) for c in range(3)],
                      [fx.retry_penalty_us(c, 10.0 + step)
                       for c in range(3)],
                      [fx.is_offline(c) for c in range(3)],
                      fx.drain_offline(), fx.drain_poison(),
                      dict(fx.stats))
        assert out[tfaults] == out[jfaults]
    for m, fx in inj.items():
        with pytest.raises(m.CrashFault, match="transaction 40"):
            fx.tick()
    assert inj[tfaults].stats == inj[jfaults].stats


# -- the reference's scenarios on both engines ---------------------------------

@pytest.fixture(scope="module")
def models():
    japi0 = R.build(ARCH, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(0))
    japi = R._lm_api(ARCH, dataclasses.replace(japi0.cfg,
                                               dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(ARCH, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    return (JaxServeEngine, JaxEngineConfig, japi, jp32), \
        (ServeEngine, EngineConfig, tapi, tp)


PROMPTS = np.random.default_rng(77).integers(
    0, 256, (N_REQ, PROMPT_LEN)).astype(np.int32)


def _serve(side, faults_mod=None, spec=None, fault_seed=0, plan=None,
           max_steps=600, **kw):
    """The reference's chaos workload (``tests/test_faults.py``): N_REQ
    staggered greedy requests on a small pool, megastep 4, depth 2."""
    engine_cls, cfg_cls, api, params = side
    base = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
                prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=2)
    base.update(kw)
    if cfg_cls is EngineConfig:
        base["device"] = "cpu"
    if faults_mod is not None:
        events = plan if plan is not None else \
            faults_mod.parse_fault_plan(spec)
        base["faults"] = faults_mod.FaultInjector(events, seed=fault_seed)
    eng = engine_cls(api, params, cfg_cls(**base))
    reqs = [eng.submit(PROMPTS[i], GEN, arrival_step=2 * i)
            for i in range(N_REQ)]
    outs = eng.run(max_steps=max_steps)
    eng.pool.check_invariants()
    return eng, reqs, outs


def _outcome(eng, reqs, outs):
    """Survivors' tokens and failed records by submission index."""
    served = {i: np.asarray(outs[r.rid]).tolist()
              for i, r in enumerate(reqs) if r.rid in outs}
    failed = {i: (r.state, r.error, r.done_step, r.blocks_freed)
              for i, r in enumerate(reqs) if r.rid in eng.failed}
    return served, failed


@pytest.fixture(scope="module")
def oracle(models):
    eng, reqs, outs = _serve(models[1])
    return [np.asarray(outs[r.rid]).tolist() for r in reqs], eng


def _both(models, oracle, allowed, plan_fn=None, **kw):
    """The same fault run on both engines: equal outcomes, fault stats and
    paging stats; every survivor equals the fault-free run and every
    casualty carries a structured error of an allowed kind."""
    runs = {}
    for side, mod in ((models[0], jfaults), (models[1], tfaults)):
        plan = None if plan_fn is None else plan_fn(mod)
        runs[mod] = _serve(side, mod, plan=plan, **kw)
    (je, jr, jo), (te, tr, to) = runs[jfaults], runs[tfaults]
    assert _outcome(te, tr, to) == _outcome(je, jr, jo)
    assert te.stats() == je.stats()
    assert te.paging_stats() == je.paging_stats()
    served, failed = _outcome(te, tr, to)
    for i, toks in served.items():
        assert toks == oracle[0][i]
    for state, error, _, _ in failed.values():
        assert state == FAILED and error["kind"] in allowed
        assert "step" in error
    assert len(served) + len(failed) == N_REQ
    return te


def test_transient_retries_bit_exact_and_billed(models, oracle):
    te = _both(models, oracle, set(),
               spec="transient:0@1+80=0.5,degrade:0@4+40=0.25",
               fault_seed=3)
    f = te.stats()["faults"]
    assert f["injected"] == 2 and f["retried"] > 0 and f["retry_us"] > 0
    base = oracle[1].pool.stats
    assert te.pool.stats["duplex_us"] > base["duplex_us"]
    assert (te.pool.stats["page_ins"], te.pool.stats["page_outs"]) == \
        (base["page_ins"], base["page_outs"])


@pytest.mark.parametrize("tiers", ["ddr5:1,cxl:2", None])
def test_poison_fails_only_the_owner(models, oracle, tiers):
    te = _both(models, oracle, {"poisoned_block"},
               spec="poison:0@6,poison:1@7,poison:2@8", tiers=tiers)
    f = te.stats()["faults"]
    assert f["quarantined"] > 0 and f["failed"] == len(te.failed) > 0
    host = te.pool.host
    # a tiered pool retires the slot; a flat one scrubs it in place
    assert host.capacity_degraded == (tiers is not None)


def test_offline_channel_evacuates(models, oracle):
    te = _both(models, oracle, {"evacuation_casualty", "shed"},
               spec="offline:2@8", fault_seed=1, tiers="ddr5:1,cxl:2")
    f = te.stats()["faults"]
    assert f["offline_channels"] == [2] and f["evacuated"] > 0
    dead = te.pool.tier_stats()["channels"]["cxl:2"]
    assert dead["offline"] and dead["slots_used"] == 0 and dead["lost"] > 0
    assert te.pool.tier_stats()["migrate_us"] > 0


def test_offline_on_flat_pool_raises(models):
    for side, mod in ((models[0], jfaults), (models[1], tfaults)):
        with pytest.raises(RuntimeError, match="flat"):
            _serve(side, mod, spec="offline:0@2", max_steps=100)


def test_shedding_under_lost_capacity(models, oracle):
    te = _both(models, oracle, {"shed", "evacuation_casualty"},
               spec="offline:3@6", fault_seed=2, tiers="cxl:4",
               pool_blocks=16)
    f = te.stats()["faults"]
    assert f["shed"] > 0
    assert any(r.error["kind"] == "shed" for r in te.failed.values())
    assert te._committed_blocks() <= te.pool.host.live_capacity()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("megastep", [1, 4, 8])
def test_mixed_plan_at_each_width_and_depth(models, oracle, megastep, depth):
    """Every recoverable kind in one plan, at other megastep widths and
    depths: the fault clock ticks once per pool transaction in both
    engines, so the plan fires at the same transactions."""
    te = _both(models, oracle,
               {"poisoned_block", "evacuation_casualty", "shed"},
               spec="degrade:1@2+10=0.5,poison:0@5,offline:2@9,"
                    "transient:0@3+30=0.4", fault_seed=5,
               tiers="ddr5:1,cxl:2", megastep=megastep,
               pipeline_depth=depth)
    assert te.stats()["faults"]["injected"] == 4


def test_reclaim_across_tier_migrations(models, oracle):
    """A speculative free and its reclaim straddling boundary migrations
    on both engines: ownership round-trips and the tokens stay the
    fault-free run's."""
    got = {}
    for side in models:
        eng_cls, cfg_cls, api, params = side
        kw = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
                  prefill_chunk=3, max_queue=8, megastep=4,
                  pipeline_depth=2, tiers="ddr5:2,cxl:2", pool_blocks=32)
        if cfg_cls is EngineConfig:
            kw["device"] = "cpu"
        eng = eng_cls(api, params, cfg_cls(**kw))
        reqs = [eng.submit(PROMPTS[i], GEN, arrival_step=2 * i)
                for i in range(N_REQ)]
        eng.megastep(4)
        eng.megastep(4)
        pool = eng.pool
        victim = next(r for r in eng.active() if r.blocks)
        ids = list(victim.blocks)
        pool.free(ids)
        pool.migrate_tiers()
        pool.reclaim(ids)
        pool.migrate_tiers()
        pool.check_invariants()
        with pytest.raises(RuntimeError, match="reclaim"):
            pool.reclaim(ids)
        outs = eng.run(max_steps=600)
        got[cfg_cls] = ([np.asarray(outs[r.rid]).tolist() for r in reqs],
                        eng.paging_stats())
    assert got[EngineConfig] == got[JaxEngineConfig]
    assert got[EngineConfig][0] == oracle[0]


@pytest.mark.parametrize("seed", [0, 1347, 9021])
def test_chaos_schedules_equal_reference(models, oracle, seed):
    te = _both(models, oracle,
               {"poisoned_block", "evacuation_casualty", "shed"},
               plan_fn=lambda mod: mod.random_plan(
                   seed, n_channels=3, n_blocks=24, horizon=20,
                   n_events=5),
               fault_seed=seed, tiers="ddr5:1,cxl:2")
    f = te.stats()["faults"]
    assert f["injected"] >= 1 and f["failed"] == len(te.failed)


def test_crash_event_raises_out_of_run(models):
    """``crash:@S`` is process death: ``tick()`` raises ``CrashFault`` at
    transaction S inside the run, in both engines, and nothing catches
    it (recovery needs the snapshot layer, which the port has not)."""
    for side, mod in ((models[0], jfaults), (models[1], tfaults)):
        with pytest.raises(mod.CrashFault) as e:
            _serve(side, mod, spec="poison:1@2,crash:@5", tiers="cxl:2")
        assert e.value.at_step == 5


def test_faults_need_paging_and_cost_nothing_without(models, oracle):
    _, cfg_cls, api, params = models[1]
    fx = tfaults.FaultInjector(tfaults.parse_fault_plan("poison:0@2"))
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(api, params, EngineConfig(
            max_batch=3, cache_len=64, paging=False, faults=fx,
            device="cpu"))
    eng = oracle[1]
    assert eng.stats()["faults"] == tfaults.fresh_fault_stats()
    assert eng.pool._csum_data is None and eng._fx is None


def test_reset_stats_keeps_clocks(models):
    eng, _, _ = _serve(models[1], tfaults, spec="poison:0@6",
                       tiers="ddr5:1,cxl:1")
    steps = eng.step_count
    assert eng.stats()["faults"]["injected"] == 1
    eng.reset_stats()
    assert eng.step_count == steps
    assert eng.stats()["faults"] == tfaults.fresh_fault_stats()
    assert eng.pool.stats["page_ins"] == 0
    assert eng.pool.tier_stats()["channels"]["cxl:1"]["busy_us"] == 0.0
    assert all(c.samples == 0 for c in eng.telemetry._by_path.values())


@pytest.mark.parametrize("depth", [1, 2])
def test_graph_steps_equal_eager_under_faults(models, oracle, depth):
    """The graphs' static-buffer bookkeeping (``_graphs=True`` on the CPU)
    against the eager megastep under a plan that fails requests mid-flight
    (poison, evacuation, shedding): the same survivors, failed records,
    fault and paging stats, and no static tensor rebound — a failed
    request's slot is vacated on the host and rewritten in place when
    admission reuses it."""
    engine_cls, cfg_cls, api, params = models[1]
    runs = {}
    for graphs in (False, True):
        fx = tfaults.FaultInjector(tfaults.parse_fault_plan(
            "degrade:1@2+10=0.5,poison:0@5,poison:3@7,offline:2@8,"
            "transient:0@3+30=0.4"), seed=5)
        eng = ServeEngine(api, params, EngineConfig(
            max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
            prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=depth,
            tiers="ddr5:1,cxl:2", faults=fx, device="cpu"), _graphs=graphs)
        static = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
                  eng.pool.host_q, eng.pool.host_scale]
        reqs = [eng.submit(PROMPTS[i], GEN, arrival_step=2 * i)
                for i in range(N_REQ)]
        outs = eng.run(max_steps=600)
        eng.pool.check_invariants()
        now = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
               eng.pool.host_q, eng.pool.host_scale]
        # the eager megastep returns a new slot state; the graphs' static
        # inputs and the pool's tensors are never rebound
        keep = static if graphs else static[-3:]
        assert all(a is b for a, b in zip(keep, now[len(now) - len(keep):]))
        runs[graphs] = (_outcome(eng, reqs, outs), eng.stats(),
                        eng.paging_stats(), eng.decode_steps)
    assert runs[True] == runs[False]
    (served, failed), stats = runs[True][0], runs[True][1]
    assert failed and stats["faults"]["evacuated"] > 0
    for i, toks in served.items():
        assert toks == oracle[0][i]
