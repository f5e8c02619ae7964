"""Port's tiered host pool against ``repro.serve.tiers`` /
``repro.serve.kv_pool``: ``parse_tier_spec``'s channel sets and error
messages, pools under four channel sets driven through the same
transaction sequence (placement maps, free stacks, per-channel billing,
boundary migrations, ``tier_stats`` — every modelled number exactly equal;
host rows within 1 int8 LSB and scales within rtol 1e-6, the reference's
tolerances), and engine runs of smollm-135m in float32 beside a KV-store
tenant at K = 1/4/8 x pipeline depth 1/2, tiered with and without
migrations: the same tokens, tenant result and ``paging_stats()``, and the
same tokens as the flat pool."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jchannel  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro.core.hints import HintTree as JHintTree  # noqa: E402
from repro.core.hints import MemoryHint as JMemoryHint  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import KVStoreTenant as JaxKVStoreTenant  # noqa: E402
from repro.serve import PagedKVPool as JaxPagedKVPool  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import offload as toffload  # noqa: E402
from repro_torch.core.hints import HintTree, MemoryHint  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               PagedKVPool, ServeEngine)

ARCH = "smollm-135m"
SPECS = ["ddr5:1,cxl:1", "cxl:2", "ddr5:2", "ddr5:2,cxl:2"]


# -- the channel-set spec ----------------------------------------------------

@pytest.mark.parametrize("spec", ["ddr5:2,cxl:2", "cxl", " ddr5:1 , cxl:3",
                                  "cxl:2,ddr5:1,cxl:1"])
def test_parse_tier_spec_equals_reference(spec):
    want = jchannel.parse_tier_spec(spec)
    got = tchannel.parse_tier_spec(spec)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [dataclasses.asdict(c) for _, c in got] == \
        [dataclasses.asdict(c) for _, c in want]


@pytest.mark.parametrize("bad", ["", ",", "dd5:2", "ddr5:zero", "ddr5:0",
                                 "ddr5:1,hbm:1", "cxl:-1"])
def test_parse_tier_spec_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        jchannel.parse_tier_spec(bad)
    with pytest.raises(ValueError) as got:
        tchannel.parse_tier_spec(bad)
    assert str(got.value) == str(want.value)
    assert "known kinds" in str(got.value)


@pytest.mark.parametrize("factor", [1.0, 0.5, 0.25, 1e-3])
def test_degraded_channel_equals_reference(factor):
    for kind in ("ddr5", "cxl"):
        got = tchannel.TIER_PRESETS[kind].degraded(factor)
        want = jchannel.TIER_PRESETS[kind].degraded(factor)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match=r"\(0, 1\]"):
            tchannel.CXL_HOST.degraded(bad)


def test_migration_and_evacuation_transfers_equal_reference():
    args = ([3, 9, 1], [0, 5, 7], [12, 2, 14], 4096.0)
    for name in ("migration_transfers", "evacuation_transfers"):
        want = getattr(joffload, name)(*args)
        got = getattr(toffload, name)(*args)
        assert [dataclasses.asdict(t) for t in got] == \
            [dataclasses.asdict(t) for t in want]
        with pytest.raises(ValueError, match="src and dst"):
            getattr(toffload, name)([1], [2, 3], [4], 1.0)
    assert (toffload.MIGRATE, toffload.EVACUATE) == \
        (joffload.MIGRATE, joffload.EVACUATE)


# -- pools driven through the same transactions -------------------------------

SCOPES = {"/t/mix": dict(read_fraction=0.5),
          "/t/read": dict(read_fraction=0.95),
          "/t/write": dict(read_fraction=0.05),
          "/t/withdrawn": dict(read_fraction=0.5, duplex_opt_in=False)}
SHAPE = (8, 32)


def _tree(tree_cls, hint_cls):
    t = tree_cls()
    for path, kw in SCOPES.items():
        t.set(path, hint_cls(**kw))
    return t


def _data(rng, n):
    return rng.standard_normal((n,) + SHAPE).astype(np.float32)


def _drive(spec, make_pool, to_data, steps=40, seed=0):
    """A seeded transaction sequence: each step picks a scope and a set of
    blocks, pages them in, rewrites some, and every few steps runs a
    boundary migration. Returns the pool and the per-step reports."""
    rng = np.random.default_rng(seed)
    pool = make_pool(spec)
    paths = list(SCOPES)
    log = []
    for step in range(steps):
        path = paths[int(rng.integers(len(paths)))]
        ids = sorted(set(rng.integers(0, 24, int(rng.integers(1, 5)))
                         .tolist()))
        log.append(pool.step(ids, hint_path=path))
        w = ids[:int(rng.integers(0, len(ids) + 1))]
        data = _data(rng, len(w))
        if w:
            pool.write(w, to_data(data))
        if step % 3 == 2:
            log.append(pool.migrate_tiers())
        if step == 25:
            pool.free(ids[:1])
            pool.invalidate(ids[1:2])
        pool.check_invariants()
    return pool, log


def _jax_pool(spec):
    return JaxPagedKVPool(24, 5, SHAPE, hints=_tree(JHintTree, JMemoryHint),
                          tiers=spec)


def _torch_pool(spec):
    return PagedKVPool(24, 5, SHAPE, hints=_tree(HintTree, MemoryHint),
                       tiers=spec, device="cpu")


@pytest.mark.parametrize("spec", SPECS)
def test_pool_transactions_equal_reference(spec):
    jp, jlog = _drive(spec, _jax_pool, lambda d: jnp.asarray(d))
    tp, tlog = _drive(spec, _torch_pool, lambda d: torch.from_numpy(d))
    assert tlog == jlog
    jh, th = jp.host, tp.host
    for name in ("slot_of", "block_of", "pref", "channel_of_slot", "cap",
                 "base", "_wrr", "_win", "offline"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name),
                                      err_msg=name)
    assert th._free == jh._free
    assert th.totals == jh.totals
    assert (th.migrations, th.migrate_us) == (jh.migrations, jh.migrate_us)
    assert tp.stats == jp.stats
    assert tp.tier_stats() == jp.tier_stats()
    assert tp.tier_speedup() == jp.tier_speedup()
    for name in ("slot_of", "block_at", "last_use", "_dirty", "_has_host"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    live = np.flatnonzero(jp._has_host)
    hs = jh.slot_of[live]
    tq = tp.host_q.numpy()[hs].astype(np.int32)
    jq = np.asarray(jp.host_q)[hs].astype(np.int32)
    assert np.abs(tq - jq).max(initial=0) <= 1
    np.testing.assert_allclose(tp.host_scale.numpy()[hs],
                               np.asarray(jp.host_scale)[hs], rtol=1e-6)
    if jh.tiered:
        assert jp.stats["tier_us"] > 0
    if spec == "ddr5:2,cxl:2":
        assert jh.migrations > 0


def test_bill_transaction_and_baseline_equal_reference():
    """One hand-placed transaction per co-issue mode on every spec: the
    per-channel byte split, both time views and the all-DDR5
    counterfactual."""
    for spec in SPECS:
        jp, tp = _jax_pool(spec), _torch_pool(spec)
        for pool in (jp, tp):
            pool.host.place(np.arange(6), 0)
            pool.host.place(np.arange(6, 12), len(pool.host.kind_names) - 1)
        for co in (True, False):
            ins, outs = np.arange(0, 12, 2), np.arange(1, 12, 3)
            jr = jp.host.bill_transaction(jp.host.slot_of[ins],
                                          jp.host.slot_of[outs], co)
            tr = tp.host.bill_transaction(tp.host.slot_of[ins],
                                          tp.host.slot_of[outs], co)
            np.testing.assert_array_equal(tr[0], jr[0])
            np.testing.assert_array_equal(tr[1], jr[1])
            assert tr[2:] == jr[2:]
            assert tp.host.ddr5_baseline_us(tr[0], tr[1]) == \
                jp.host.ddr5_baseline_us(jr[0], jr[1])
        assert tp.host.stats() == jp.host.stats()


def test_migration_moves_rows_verbatim_in_place():
    """A boundary migration copies the quantized rows and scales bit for
    bit to their new slots and leaves ``host_q`` / ``host_scale`` the
    same tensors (a captured CUDA graph may hold them)."""
    pool = _torch_pool("ddr5:1,cxl:1")
    rng = np.random.default_rng(4)
    pool.step(range(5), hint_path="/t/mix")
    pool.write(range(5), torch.from_numpy(_data(rng, 5)))
    pool.step(range(5, 10), hint_path="/t/mix")       # 0..4 spill -> cxl
    pool.step([0, 1], hint_path="/t/read")            # pref -> ddr5
    q0, s0 = pool.host_q, pool.host_scale
    before = {b: (pool.host_q[pool.host.slot_of[b]].clone(),
                  pool.host_scale[pool.host.slot_of[b]].clone())
              for b in range(2, 5)}
    slots = pool.host.slot_of.copy()
    assert pool.migrate_tiers()["migrations"] >= 1
    assert pool.host_q is q0 and pool.host_scale is s0
    moved = [b for b in before if pool.host.slot_of[b] != slots[b]]
    for b in before:
        s = pool.host.slot_of[b]
        assert torch.equal(pool.host_q[s], before[b][0])
        assert torch.equal(pool.host_scale[s], before[b][1])
    pool.check_invariants()
    assert moved or pool.host.migrations > 0


def test_flat_pool_keeps_identity_placement_and_schema():
    jp = JaxPagedKVPool(16, 4, SHAPE)
    tp = PagedKVPool(16, 4, SHAPE, device="cpu")
    rng = np.random.default_rng(5)
    d = _data(rng, 4)
    for pool, conv in ((jp, jnp.asarray), (tp, torch.from_numpy)):
        pool.step(range(4))
        pool.write(range(4), conv(d))
        pool.step(range(4, 8))
        assert pool.migrate_tiers() == {"migrations": 0}
    np.testing.assert_array_equal(tp.host.slot_of[:4], np.arange(4))
    assert tp.tier_stats() == jp.tier_stats()
    assert tp.tier_speedup() == 1.0
    tp.reset_stats()
    jp.reset_stats()
    assert tp.stats == jp.stats and tp.tier_stats() == jp.tier_stats()


# -- engine runs beside the reference engine ----------------------------------

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
    return (japi, jp32), (tapi, tp)


def _serve(engine_cls, cfg_cls, kv_cls, model, **kw):
    """The reference's tiered workload (``tests/test_tiers.py``): LLM
    requests beside a KV-store tenant whose gaussian and read-heavy
    scopes prefer different tiers, so blocks change tiers and migrate."""
    base = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=10,
                pool_blocks=64, prefill_chunk=3, max_queue=16)
    base.update(kw)
    if cfg_cls is EngineConfig:
        base["device"] = "cpu"
    eng = engine_cls(*model, cfg_cls(**base))
    kv = eng.add_tenant(kv_cls(n_slots=2, ops_per_step=2, store_blocks=12))
    kv.preload(12)
    kv.submit("gaussian", n_steps=24)
    kv.submit("read_heavy", n_steps=24, arrival_step=4)
    prompts = np.random.default_rng(31).integers(
        0, 256, (4, 6)).astype(np.int32)
    rids = [eng.submit(prompts[i], 10, arrival_step=2 * i).rid
            for i in range(4)]
    outs = eng.run(max_steps=400)
    eng.pool.check_invariants()
    return [outs[r].tolist() for r in rids], kv, eng


@pytest.mark.parametrize("megastep", [1, 4, 8])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("migrate", [True, False])
def test_tiered_engine_equals_reference(models, megastep, depth, migrate):
    jmodel, tmodel = models
    kw = dict(megastep=megastep, pipeline_depth=depth,
              tiers="ddr5:2,cxl:2", tier_migrate=migrate)
    jt, jkv, je = _serve(JaxServeEngine, JaxEngineConfig, JaxKVStoreTenant,
                         jmodel, **kw)
    tt, tkv, te = _serve(ServeEngine, EngineConfig, KVStoreTenant, tmodel,
                         **kw)
    assert tt == jt
    assert te.paging_stats() == je.paging_stats()
    assert tkv.ops_done == jkv.ops_done > 0
    np.testing.assert_allclose(tkv.result(), jkv.result(), rtol=1e-4)
    ts = te.paging_stats()["tiers"]
    assert ts["tiered"] and ts["tier_speedup"] > 1.0
    assert (ts["migrations"] > 0) == migrate
    # bit-exact moves: the same tokens as the flat pool
    ft, fkv, _ = _serve(ServeEngine, EngineConfig, KVStoreTenant, tmodel,
                        megastep=megastep, pipeline_depth=depth)
    assert ft == tt
    assert fkv.result() == tkv.result()


@pytest.mark.parametrize("depth", [1, 2])
def test_graph_steps_equal_eager_under_tiers(models, depth):
    """The graphs' static-buffer bookkeeping (``_graphs=True`` on the CPU:
    "replays" are direct calls on the static tensors) against the eager
    megastep with boundary migrations between the steps: the same tokens,
    tenant result and stats, and neither the slot state, the cache nor
    the pool's tensors are rebound."""
    runs = {}
    for graphs in (False, True):
        eng = ServeEngine(*models[1], EngineConfig(
            max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=10,
            pool_blocks=64, prefill_chunk=3, max_queue=16, megastep=4,
            pipeline_depth=depth, tiers="ddr5:2,cxl:2", device="cpu"),
            _graphs=graphs)
        static = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
                  eng.pool.host_q, eng.pool.host_scale]
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=12))
        kv.preload(12)
        kv.submit("gaussian", n_steps=24)
        kv.submit("read_heavy", n_steps=24, arrival_step=4)
        prompts = np.random.default_rng(31).integers(
            0, 256, (4, 6)).astype(np.int32)
        rids = [eng.submit(prompts[i], 10, arrival_step=2 * i).rid
                for i in range(4)]
        outs = eng.run(max_steps=400)
        now = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
               eng.pool.host_q, eng.pool.host_scale]
        # the eager megastep returns a new slot state; the graphs' static
        # inputs and the pool's tensors are never rebound
        keep = static if graphs else static[-3:]
        assert all(a is b for a, b in zip(keep, now[len(now) - len(keep):]))
        runs[graphs] = ([outs[r].tolist() for r in rids], kv.result(),
                        eng.stats(), eng.paging_stats(), eng.decode_steps)
    assert runs[True] == runs[False]
    assert runs[True][3]["tiers"]["migrations"] > 0


def test_a_block_released_twice_frees_its_slot_once():
    """A fault of the reference, kept out of the port (ROADMAP Queue 3):
    ``TieredHostPool.release`` given one block twice pushes its host slot
    twice onto the free stack, so two blocks later share the slot. The
    port releases it once; its free stacks and invariants hold."""
    jp, tp = _jax_pool("ddr5:1,cxl:1"), _torch_pool("ddr5:1,cxl:1")
    for pool in (jp, tp):
        pool.host.place(np.array([5, 6]), 0)
    s = int(tp.host.slot_of[5])
    c = int(tp.host.channel_of_slot[s])
    assert s == int(jp.host.slot_of[5])
    for pool in (jp, tp):
        pool.host.release(np.array([5, 5]))
    assert jp.host._free[c].count(s) == 2
    with pytest.raises(AssertionError, match="duplicates"):
        jp.host.check_invariants()
    assert tp.host._free[c].count(s) == 1
    tp.host.check_invariants()


def test_kv_store_rewrites_keep_the_tiered_pool_consistent(models):
    """The KV-store tenant invalidates a block twice in a step that SETs
    the same key twice: on the reference's tiered pool two blocks end up
    sharing one host slot, on the port's every invariant holds, and the
    LLM requests beside the store get the same tokens from both."""
    out = {}
    for side, (engine_cls, cfg_cls, kv_cls) in zip(models, (
            (JaxServeEngine, JaxEngineConfig, JaxKVStoreTenant),
            (ServeEngine, EngineConfig, KVStoreTenant))):
        kw = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=10,
                  pool_blocks=64, prefill_chunk=3, max_queue=16,
                  megastep=4, pipeline_depth=2, tiers="ddr5:1,cxl:2")
        if cfg_cls is EngineConfig:
            kw["device"] = "cpu"
        eng = engine_cls(*side, cfg_cls(**kw))
        kv = eng.add_tenant(kv_cls(n_slots=2, ops_per_step=2,
                                   store_blocks=12))
        kv.preload(12)
        kv.submit("gaussian", n_steps=24)
        kv.submit("sequential", n_steps=24, phase="read")
        prompts = np.random.default_rng(1).integers(
            0, 256, (6, 7)).astype(np.int32)
        rids = [eng.submit(p, 9, arrival_step=2 * i).rid
                for i, p in enumerate(prompts)]
        outs = eng.run(max_steps=400)
        out[cfg_cls] = ([outs[r].tolist() for r in rids], eng)
    with pytest.raises(AssertionError, match="share one host slot"):
        out[JaxEngineConfig][1].pool.check_invariants()
    out[EngineConfig][1].pool.check_invariants()
    assert out[EngineConfig][0] == out[JaxEngineConfig][0]
