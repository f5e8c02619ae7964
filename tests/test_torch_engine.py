"""Port's ServeEngine: token-exact against the port's ``reference_decode``
at K = 1/4/8 x pipeline depth 1/2, the ``host_blocked`` contract, and one
run on the same arguments as the JAX engine (float32 weights) with equal
tokens, admission and completion steps, ``paging_stats`` and
``duplex_speedup``; the same for a recurrent cache (rwkv6-7b and
zamba2-7b, whose cache nests Mamba state beside attention rings; paging
gated off): slot reuse, staggered arrivals with chunked prefill and
unequal prompts; the nested caches of zamba2-7b and whisper-base against
the JAX engine, pristine on recycled slots, and the frozen-row keep;
mixtral-8x7b (MoE routing, a wrapping sliding window) through the paged
pool against ``reference_decode`` and against the JAX engine at a batch
of 4 and of 16, where capacity drops couple the rows."""

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
from repro_torch.models import layers as nn  # noqa: E402
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
# recurrent caches: RWKV6 and Zamba2 (paging gated off, frozen-row keep)
# ---------------------------------------------------------------------------

RWKV = "rwkv6-7b"
# rwkv6-7b's flat cache; zamba2-7b's nested one (Mamba state kept, the
# shared attention's rings written in place)
RECURRENT = [RWKV, "zamba2-7b"]


@pytest.fixture(scope="module", params=RECURRENT)
def rwkv_api(request):
    return TR.build(request.param, smoke=True, device="cpu")


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
    state (wkv and shift tokens; Mamba state and attention rings) is wiped
    at admission (tests/test_serve_engine.py:70-85)."""
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


# ---------------------------------------------------------------------------
# nested caches: zamba2-7b (recurrent) and whisper-base (ring)
# ---------------------------------------------------------------------------

NESTED = {"zamba2-7b": "_hybrid_api", "whisper-base": "_encdec_api"}


@pytest.mark.parametrize("arch", list(NESTED))
def test_nested_cache_same_run_as_the_jax_engine(arch):
    """The smoke model in float32 on the reference's weights: the port's
    engine and the JAX engine give the same tokens, admission and
    completion steps and stats under staggered arrivals, unequal prompts
    and chunked prefill, with slots recycled."""
    from repro_torch.models import encdec as TE
    from repro_torch.models import hybrid as TH
    convert = {"zamba2-7b": TH.params_from_jax,
               "whisper-base": TE.params_from_jax}[arch]
    japi0 = R.build(arch, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(9))
    japi = getattr(R, NESTED[arch])(arch, dataclasses.replace(
        japi0.cfg, dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = getattr(TR, NESTED[arch])(arch, tcfg, "cpu")
    tp = convert(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                 tcfg)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 9))).astype(
        np.int32) for _ in range(5)]
    kw = dict(max_batch=2, cache_len=32, prefill_chunk=3, megastep=4,
              pipeline_depth=2)
    je = JaxServeEngine(japi, jp32, JaxEngineConfig(**kw))
    te = ServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"))
    assert not te.paged
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


@pytest.mark.parametrize("arch", list(NESTED))
def test_recycled_slots_get_pristine_nested_rows(arch, monkeypatch):
    """Four requests on two slots: at every admission into a recycled
    slot, every leaf of the nested cache (zamba2: Mamba conv window and
    SSM state, attention rings; whisper: self rings, cross K/V) holds the
    pristine row of ``_cache0`` in that slot, after the slot's earlier
    request had dirtied it; the other slot's rows are untouched."""
    api = TR.build(arch, smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(5))
    eng = ServeEngine(api, params, EngineConfig(max_batch=2, cache_len=32,
                                                device="cpu"))
    real = eng._admit
    checked, used = [], set()

    def admit(now):
        before = [r for r in eng.slots]
        old = [t.clone() for t in nn.tree_leaves(eng.cache)]
        n = real(now)
        for slot, (was, req) in enumerate(zip(before, eng.slots)):
            leaves = zip(nn.tree_leaves(eng.cache),
                         nn.tree_leaves(eng._cache0), old)
            if req is not was and req is not None:
                dirty = False
                for leaf, leaf0, prev in leaves:
                    assert torch.equal(leaf[:, slot], leaf0[:, slot])
                    dirty |= not torch.equal(prev[:, slot], leaf0[:, slot])
                checked.append((slot, slot in used, dirty))
                used.add(slot)
            else:
                for leaf, _, prev in leaves:
                    assert torch.equal(leaf[:, slot], prev[:, slot])
        return n

    monkeypatch.setattr(eng, "_admit", admit)
    prompts = np.random.default_rng(6).integers(0, 256, (4, 5))
    for p in prompts:
        eng.submit(p.astype(np.int32), 4)
    eng.run(max_steps=200)
    assert len(eng.completed) == 4
    # both slots were recycled with state left by their first request
    recycled = [c for c in checked if c[1]]
    assert len(recycled) == 2 and all(dirty for _, _, dirty in recycled)


def test_keep_leaves_non_mover_mamba_rows_byte_for_byte():
    """One engine step of zamba2-7b on a cache filled with noise: row 0 is
    prefilling (a mover), row 1 is empty (a non-mover fed the dummy
    token). After the keep, row 1's Mamba leaves are unchanged byte for
    byte and row 0's advanced; the attention rings are the same tensors,
    written at each row's write position."""
    from repro_torch.serve.engine import _engine_step_math
    from repro_torch.serve.queue import S_EMPTY, S_PREFILL
    api = TR.build("zamba2-7b", smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(2))
    cache = api.init_cache(2, 16)
    gen = torch.Generator().manual_seed(3)
    for leaf in nn.tree_leaves(cache["mamba"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    rings = list(nn.tree_leaves(cache["attn"]))
    before = nn.tree_map(torch.clone, cache)
    dev = {"state": torch.tensor([S_PREFILL, S_EMPTY], dtype=torch.int32),
           "tok": torch.tensor([7, 9], dtype=torch.int32),
           "consumed": torch.tensor([3, 0], dtype=torch.int32),
           "n_gen": torch.zeros(2, dtype=torch.int32),
           "prompt_len": torch.tensor([6, 0], dtype=torch.int32),
           "max_new": torch.tensor([4, 0], dtype=torch.int32),
           "prompt": torch.zeros((2, 16), dtype=torch.int32)}
    step = _engine_step_math(api, 1, None)
    new_dev, staged = step(params, cache, dev, 1)
    assert staged is None and new_dev["consumed"].tolist() == [4, 0]
    def bits(t):
        return t.contiguous().view(torch.uint8)

    for key in ("conv", "ssm"):
        leaf, old = cache["mamba"][key], before["mamba"][key]
        assert torch.equal(bits(leaf[:, 1]), bits(old[:, 1]))
        assert not torch.equal(leaf[:, 0], old[:, 0])
    assert [t for t in nn.tree_leaves(cache["attn"])] == rings
    assert torch.all(cache["attn"]["pos"][:, 0, 3] == 3)


# ---------------------------------------------------------------------------
# the MoE family: mixtral-8x7b through the paged pool
# ---------------------------------------------------------------------------

MOE = "mixtral-8x7b"


@pytest.fixture(scope="module")
def moe_api():
    return TR.build(MOE, smoke=True, device="cpu")


@pytest.fixture(scope="module")
def moe_params(moe_api):
    return moe_api.init(torch.Generator().manual_seed(5))


@pytest.mark.parametrize("megastep", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_moe_token_exact_vs_reference(moe_api, moe_params, megastep, depth):
    """mixtral-8x7b's smoke model (8 experts' routing, a sliding window of
    16 that the 8 + 14 positions of each request wrap) through the
    oversubscribed paged pool, staggered, with recycled slots. At a batch
    of 3 the capacity (8) exceeds the tokens, so no slot is dropped and
    the rows do not interact: token for token the static-batch oracle."""
    prompts = np.random.default_rng(7).integers(
        0, moe_api.cfg.vocab, (5, 8)).astype(np.int32)
    ref = _reference(moe_api, moe_params, prompts, 14, 64,
                     BASE["max_batch"])
    eng = ServeEngine(moe_api, moe_params, EngineConfig(
        **BASE, megastep=megastep, pipeline_depth=depth, device="cpu"))
    assert eng.paged and eng.cache["k"].shape[2] == 16
    rids = [eng.submit(prompts[i], 14, arrival_step=2 * i).rid
            for i in range(5)]
    outs = eng.run(max_steps=300)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], ref[i])
    ps = eng.paging_stats()
    assert ps["page_ins"] > 0 and ps["page_outs"] > 0
    eng.pool.check_invariants()


@pytest.mark.parametrize("max_batch", [4, 16])
def test_moe_same_run_as_the_jax_engine(max_batch):
    """mixtral-8x7b's smoke model in float32 on the reference's weights:
    the port's engine and the JAX engine give the same tokens, admission
    and completion steps, stats and paging stats. At a batch of 16 the
    capacity (10) is below the tokens a step, so slots are dropped and a
    non-mover row's dummy token can take a live token's slot: the rows
    couple, in both packages alike."""
    japi0 = R.build(MOE, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(3))
    japi = R._lm_api(MOE, dataclasses.replace(japi0.cfg, dtype=jnp.float32))
    jp32 = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "router" else
        a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(MOE, smoke=True, device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(MOE, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    assert (nn.moe_capacity(max_batch, tcfg.moe) < max_batch) == \
        (max_batch > 8)
    rng = np.random.default_rng(13)
    n = 6 if max_batch == 4 else 20
    prompts = [rng.integers(0, 256, int(rng.integers(3, 9))).astype(
        np.int32) for _ in range(n)]
    kw = dict(max_batch=max_batch, cache_len=32, block_tokens=4,
              hbm_blocks=6 * max_batch // 3, prefill_chunk=3,
              max_queue=n + 4, megastep=4, pipeline_depth=2)
    je = JaxServeEngine(japi, jp32, JaxEngineConfig(**kw))
    te = ServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"))
    jr = [je.submit(p, 9, arrival_step=i).rid for i, p in enumerate(prompts)]
    tr = [te.submit(p, 9, arrival_step=i).rid for i, p in enumerate(prompts)]
    jo, to = je.run(max_steps=400), te.run(max_steps=400)
    assert len(to) == n
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(to[b], jo[a])
        assert te.completed[b].admitted_step == je.completed[a].admitted_step
        assert te.completed[b].done_step == je.completed[a].done_step
    assert te.paging_stats() == je.paging_stats()
    assert te.stats() == je.stats()
