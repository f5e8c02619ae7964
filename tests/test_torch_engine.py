"""Port's ServeEngine: token-exact against the port's ``reference_decode``
at K = 1/4/8 x pipeline depth 1/2, the ``host_blocked`` contract, and one
run on the same arguments as the JAX engine (float32 weights) with equal
tokens, admission and completion steps, ``paging_stats`` and
``duplex_speedup``; the same for a recurrent cache (rwkv6-7b, paging
gated off): slot reuse, staggered arrivals with chunked prefill and
unequal prompts."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as R  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, ServeEngine,  # noqa: E402
                               reference_decode)

ARCH = "smollm-135m"
BASE = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
            prefill_chunk=3, max_queue=8)


@pytest.fixture(scope="module")
def api():
    return TR.build(ARCH, smoke=True, device="cpu")


@pytest.fixture(scope="module")
def params(api):
    return api.init(torch.Generator().manual_seed(0))


def _reference(api, params, prompts, n, cache_len, batch):
    """Static-batch oracle in batches of the engine's width, so both see
    the same matmul shapes (bf16 rounding must not depend on batch)."""
    return np.concatenate([
        reference_decode(api, params, prompts[i:i + batch], n,
                         cache_len=cache_len).numpy()
        for i in range(0, len(prompts), batch)])


@pytest.mark.parametrize("megastep", [1, 4, 8])
@pytest.mark.parametrize("depth", [1, 2])
def test_token_exact_vs_reference(api, params, megastep, depth):
    """Staggered arrivals, more requests than slots (recycled rows) and
    an oversubscribed pool that pages both ways."""
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (5, 6)).astype(np.int32)
    ref = _reference(api, params, prompts, 10, 64, BASE["max_batch"])
    eng = ServeEngine(api, params, EngineConfig(
        **BASE, megastep=megastep, pipeline_depth=depth, device="cpu"))
    rids = [eng.submit(prompts[i], 10, arrival_step=2 * i).rid
            for i in range(5)]
    outs = eng.run(max_steps=300)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    ps = eng.paging_stats()
    assert ps["page_ins"] > 0 and ps["page_outs"] > 0
    eng.pool.check_invariants()
    # host_blocked: every boundary at depth 1, only the final drain at 2
    st = eng.stats()
    assert st["host_blocked"] == (st["megasteps"] if depth == 1 else 1)
    if megastep > 1:
        assert st["host_dispatches"] < st["steps"]


def test_without_paging_still_exact(api, params):
    prompts = np.random.default_rng(2).integers(
        0, api.cfg.vocab, (4, 5)).astype(np.int32)
    ref = _reference(api, params, prompts, 7, 64, 2)
    eng = ServeEngine(api, params, EngineConfig(
        **dict(BASE, max_batch=2), paging=False, megastep=4,
        pipeline_depth=2, device="cpu"))
    rids = [eng.submit(prompts[i], 7).rid for i in range(4)]
    outs = eng.run(max_steps=200)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    assert eng.paging_stats()["paged"] is False


def test_same_run_as_the_jax_engine():
    """Same weights (float32), prompts and config: same tokens, the same
    admission and completion steps, the same paging stats (modelled
    microseconds included, exactly) and duplex_speedup."""
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

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(rng.integers(4, 9))).astype(
        np.int32) for _ in range(6)]
    kw = dict(BASE, megastep=4, pipeline_depth=2)
    je = JaxServeEngine(japi, jp32, JaxEngineConfig(**kw))
    te = ServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"))
    jr = [je.submit(p, 9, arrival_step=2 * i).rid
          for i, p in enumerate(prompts)]
    tr = [te.submit(p, 9, arrival_step=2 * i).rid
          for i, p in enumerate(prompts)]
    jo, to = je.run(max_steps=300), te.run(max_steps=300)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(to[b], jo[a])
        assert te.completed[b].admitted_step == je.completed[a].admitted_step
        assert te.completed[b].done_step == je.completed[a].done_step
    assert te.paging_stats() == je.paging_stats()
    assert te.pool.duplex_speedup() == je.pool.duplex_speedup() > 1.0
    assert te.stats() == je.stats()


def test_engine_defaults_to_cuda(api, params):
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(api, params, EngineConfig())


def _tenant_engine(api, params, megastep, depth):
    from repro_torch.serve import KVStoreTenant, VectorSearchTenant
    eng = ServeEngine(api, params, EngineConfig(
        **dict(BASE, hbm_blocks=12, max_queue=12), megastep=megastep,
        pipeline_depth=depth, device="cpu"))
    kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=1,
                                      store_blocks=10))
    kv.preload(8)
    vec = eng.add_tenant(VectorSearchTenant(n_slots=1, n_queries=2,
                                            visits_per_step=1,
                                            data_blocks=4))
    kv.submit("sequential", n_steps=30)
    kv.submit("read_heavy", n_steps=36, arrival_step=3)
    vec.submit(n_steps=40, arrival_step=1)
    return eng, kv, vec


@pytest.mark.parametrize("megastep", [1, 8])
@pytest.mark.parametrize("depth", [1, 2])
def test_token_exact_with_tenants_attached(api, params, megastep, depth):
    """KV-store and vector tenants share the pool, the paging transaction
    and the admission queue; LLM tokens stay exact. The tenants outlive
    the LLM requests, so the run ends in tenant-only megasteps: they run
    their paging and compute with no program dispatch and no readback,
    and never count as a blocked boundary. At depth 2 even the last LLM
    readback has one of them dispatched ahead of it, so no boundary
    blocks at all."""
    prompts = np.random.default_rng(4).integers(
        0, api.cfg.vocab, (4, 6)).astype(np.int32)
    ref = _reference(api, params, prompts, 8, 64, BASE["max_batch"])
    eng, kv, vec = _tenant_engine(api, params, megastep, depth)
    rids = [eng.submit(prompts[i], 8, arrival_step=2 * i).rid
            for i in range(4)]
    outs = eng.run(max_steps=300)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    assert kv.ops_done > 0 and vec.queries_done > 0
    assert not eng.pending()
    eng.pool.check_invariants()
    st = eng.stats()
    assert st["megasteps"] > st["host_dispatches"]   # tenant-only ones
    assert st["host_blocked"] == (st["host_dispatches"] if depth == 1
                                  else 0)
    assert eng.paging_stats()["tenants"] == {
        "redis": kv.stats(), "vectordb": vec.stats()}


# ---------------------------------------------------------------------------
# a recurrent cache: RWKV6 (paging gated off, frozen-row keep)
# ---------------------------------------------------------------------------

RWKV = "rwkv6-7b"


@pytest.fixture(scope="module")
def rwkv_api():
    return TR.build(RWKV, smoke=True, device="cpu")


@pytest.fixture(scope="module")
def rwkv_params(rwkv_api):
    return rwkv_api.init(torch.Generator().manual_seed(7))


def _rwkv_engine(api, params, **kw):
    eng = ServeEngine(api, params, EngineConfig(
        **{"max_batch": 2, "cache_len": 32, "device": "cpu", **kw}))
    assert not eng.paged and eng.pool is None
    return eng


def test_recurrent_state_reset_on_slot_reuse(rwkv_api, rwkv_params):
    """More requests than slots, all at once: a recycled slot's recurrent
    state (wkv, shift tokens) is wiped at admission
    (tests/test_serve_engine.py:70-85)."""
    prompts = np.random.default_rng(8).integers(
        0, rwkv_api.cfg.vocab, (4, 5)).astype(np.int32)
    ref = _reference(rwkv_api, rwkv_params, prompts, 6, 32, 2)
    eng = _rwkv_engine(rwkv_api, rwkv_params)
    rids = [eng.submit(prompts[i], 6).rid for i in range(4)]
    outs = eng.run(max_steps=200)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    assert eng.paging_stats()["paged"] is False


@pytest.mark.parametrize("megastep", [1, 4, 8])
@pytest.mark.parametrize("depth", [1, 2])
def test_recurrent_token_exact_vs_reference(rwkv_api, rwkv_params, megastep,
                                            depth):
    """Staggered arrivals with chunked prefill (``prefill_chunk=3``) put
    decoding rows beside chunk-prefilling rows, whose extra micro-steps
    must not advance the decoding rows' state; five requests on two
    slots recycle rows. Token-exact at every K and depth
    (tests/test_megastep.py:71)."""
    prompts = np.random.default_rng(9).integers(
        0, rwkv_api.cfg.vocab, (5, 7)).astype(np.int32)
    ref = _reference(rwkv_api, rwkv_params, prompts, 8, 32, 2)
    eng = _rwkv_engine(rwkv_api, rwkv_params, prefill_chunk=3,
                       megastep=megastep, pipeline_depth=depth)
    rids = [eng.submit(prompts[i], 8, arrival_step=2 * i).rid
            for i in range(5)]
    outs = eng.run(max_steps=300)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    st = eng.stats()
    assert st["host_blocked"] == (st["megasteps"] if depth == 1 else 1)
    if megastep > 1:
        assert st["host_dispatches"] < st["steps"]


@pytest.mark.parametrize("megastep", [1, 4])
def test_recurrent_unequal_prompts_exact(rwkv_api, rwkv_params, megastep):
    """Unequal prompt lengths desynchronize the batch further
    (tests/test_serve_engine.py:87-110); each request against its own
    static decode."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, rwkv_api.cfg.vocab, n).astype(np.int32)
               for n in (3, 7, 5)]
    refs = [reference_decode(rwkv_api, rwkv_params, p[None], 6,
                             cache_len=32).numpy()[0] for p in prompts]
    eng = _rwkv_engine(rwkv_api, rwkv_params, prefill_chunk=3,
                       megastep=megastep)
    rids = [eng.submit(p, 6, arrival_step=2 * i).rid
            for i, p in enumerate(prompts)]
    outs = eng.run(max_steps=200)
    for rid, want in zip(rids, refs):
        np.testing.assert_array_equal(outs[rid], want)


def test_recurrent_same_run_as_the_jax_engine():
    """rwkv6-7b smoke in float32 on the reference's weights: the port's
    engine and the JAX engine give the same tokens, admission and
    completion steps and stats under staggered arrivals, unequal prompts
    and chunked prefill."""
    from repro_torch.models import rwkv6 as TW
    japi0 = R.build(RWKV, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(9))
    japi = R._rwkv_api(RWKV, dataclasses.replace(japi0.cfg,
                                                 dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(RWKV, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._rwkv_api(RWKV, tcfg, "cpu")
    tp = TW.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 9))).astype(
        np.int32) for _ in range(5)]
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=3, megastep=4,
              pipeline_depth=2)
    je = JaxServeEngine(japi, jp32, JaxEngineConfig(**kw))
    te = ServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"))
    jr = [je.submit(p, 7, arrival_step=2 * i).rid
          for i, p in enumerate(prompts)]
    tr = [te.submit(p, 7, arrival_step=2 * i).rid
          for i, p in enumerate(prompts)]
    jo, to = je.run(max_steps=300), te.run(max_steps=300)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(to[b], jo[a])
        assert te.completed[b].admitted_step == je.completed[a].admitted_step
        assert te.completed[b].done_step == je.completed[a].done_step
    assert te.paging_stats() == je.paging_stats()
    assert te.stats() == je.stats()
