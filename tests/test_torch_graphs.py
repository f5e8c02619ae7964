"""The engine steps as graphs over static buffers (``serve/graphs.py``),
on the CPU: a "replay" there calls the step function directly on the
same static tensors the CUDA graphs read, so the bookkeeping around the
replays — the slot state and cache updated in place, admission written
into them, each step's tokens and staged slab copied out, the packed
readback — runs here. Against the eager ``_megastep_math``: token-exact,
with equal ``stats()``, ``paging_stats()`` and micro-step counts, at
K = 1/2/4/8, pipeline depth 1 and 2 and prefill_chunk 1 and 4, with the
tenants attached, and for a recurrent cache (rwkv6-7b); and the same run
as the JAX engine."""

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
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               ServeEngine, VectorSearchTenant,
                               reference_decode)
from repro_torch.serve.graphs import StepGraphs  # noqa: E402

BASE = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
            max_queue=8, device="cpu")


@pytest.fixture(scope="module")
def api():
    return TR.build("smollm-135m", smoke=True, device="cpu")


@pytest.fixture(scope="module")
def params(api):
    return api.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def rwkv_api():
    return TR.build("rwkv6-7b", smoke=True, device="cpu")


@pytest.fixture(scope="module")
def rwkv_params(rwkv_api):
    return rwkv_api.init(torch.Generator().manual_seed(7))


def _serve(api, params, cfg, prompts, gen, graphs, tenants=False):
    """One run; returns the tokens, both stats, the micro-step count and
    the engine."""
    eng = ServeEngine(api, params, cfg, _graphs=graphs)
    if tenants:
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=1,
                                          store_blocks=10))
        kv.preload(8)
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, n_queries=2, visits_per_step=1, data_blocks=4))
        kv.submit("sequential", n_steps=20)
        kv.submit("read_heavy", n_steps=24, arrival_step=3)
        vec.submit(n_steps=26, arrival_step=1)
    dev = dict(eng._dev)
    cache = dict(eng.cache)
    rids = [eng.submit(p, gen, arrival_step=2 * i).rid
            for i, p in enumerate(prompts)]
    outs = eng.run(max_steps=300)
    if graphs:
        # the graphs' static inputs are never rebound
        assert all(eng._dev[k] is v for k, v in dev.items())
        assert all(eng.cache[k] is v for k, v in cache.items())
    return ([outs[r].tolist() for r in rids], eng.stats(),
            eng.paging_stats(), eng.decode_steps, eng)


def _assert_same_run(eager, graphed):
    assert graphed[0] == eager[0]
    assert graphed[1] == eager[1]
    assert graphed[2] == eager[2]
    assert graphed[3] == eager[3] > 0


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("megastep", [1, 2, 4, 8])
def test_graph_steps_equal_eager_megastep(api, params, megastep, depth,
                                          chunk):
    """Staggered arrivals, five requests on three slots (recycled rows),
    an oversubscribed pool that pages both ways."""
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (5, 6)).astype(np.int32)
    cfg = EngineConfig(**BASE, prefill_chunk=chunk, megastep=megastep,
                       pipeline_depth=depth)
    eager = _serve(api, params, cfg, prompts, 10, graphs=False)
    graphed = _serve(api, params, cfg, prompts, 10, graphs=True)
    _assert_same_run(eager, graphed)
    assert graphed[2]["page_ins"] > 0 and graphed[2]["page_outs"] > 0
    assert eager[4].graphs is None
    assert graphed[4].graphs.keys == tuple(range(chunk + 1))
    want = np.concatenate([
        reference_decode(api, params, prompts[i:i + 3], 10,
                         cache_len=64).numpy() for i in (0, 3)])
    np.testing.assert_array_equal(np.asarray(graphed[0]), want)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("megastep", [1, 8])
def test_graph_steps_with_tenants(api, params, megastep, depth):
    """The tenants' paging and compute run eagerly between the steps and
    read the copied-out staged slabs; the run ends in tenant-only
    megasteps with no step at all."""
    prompts = np.random.default_rng(4).integers(
        0, api.cfg.vocab, (4, 6)).astype(np.int32)
    cfg = EngineConfig(**dict(BASE, hbm_blocks=12, max_queue=12),
                       prefill_chunk=3, megastep=megastep,
                       pipeline_depth=depth)
    eager = _serve(api, params, cfg, prompts, 8, graphs=False,
                   tenants=True)
    graphed = _serve(api, params, cfg, prompts, 8, graphs=True,
                     tenants=True)
    _assert_same_run(eager, graphed)
    assert graphed[2]["tenants"]["redis"]["ops"] > 0
    graphed[4].pool.check_invariants()


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("megastep", [1, 8])
def test_graph_steps_recurrent_cache(rwkv_api, rwkv_params, megastep, chunk):
    """rwkv6-7b: unpaged, so a step with no active micro-step does no work
    and has no graph; the frozen-row keep writes the static cache."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, rwkv_api.cfg.vocab, n).astype(np.int32)
               for n in (3, 7, 5, 6, 2)]
    cfg = EngineConfig(max_batch=2, cache_len=32, prefill_chunk=chunk,
                       megastep=megastep, pipeline_depth=2, device="cpu")
    eager = _serve(rwkv_api, rwkv_params, cfg, prompts, 6, graphs=False)
    graphed = _serve(rwkv_api, rwkv_params, cfg, prompts, 6, graphs=True)
    _assert_same_run(eager, graphed)
    assert graphed[2]["paged"] is False
    assert graphed[4].graphs.keys == tuple(range(1, chunk + 1))
    for p, got in zip(prompts, graphed[0]):
        want = reference_decode(rwkv_api, rwkv_params, p[None], 6,
                                cache_len=32).numpy()[0]
        np.testing.assert_array_equal(got, want)


def test_graph_steps_same_run_as_the_jax_engine():
    """float32 weights of the reference: the static-buffer path gives the
    JAX engine's tokens, admission and completion steps and stats."""
    japi0 = R.build("smollm-135m", smoke=True)
    jp = japi0.init(jax.random.PRNGKey(0))
    japi = R._lm_api("smollm-135m", dataclasses.replace(japi0.cfg,
                                                        dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build("smollm-135m", smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api("smollm-135m", tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(rng.integers(4, 9))).astype(
        np.int32) for _ in range(6)]
    kw = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
              prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=2)
    je = JaxServeEngine(japi, jp32, JaxEngineConfig(**kw))
    te = ServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"),
                     _graphs=True)
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
    assert te.stats() == je.stats()


def test_step_graphs_hold_one_step_per_micro_count(api, params):
    """The engine's graphs: keyed 0..prefill_chunk when paged, none
    captured on the CPU (``n_graphs`` 0), an unknown count refused, and a
    step's copies are not the static tensors."""
    eng = ServeEngine(api, params, EngineConfig(**BASE, prefill_chunk=2),
                      _graphs=True)
    g = eng.graphs
    assert isinstance(g, StepGraphs) and not g.captured
    assert g.keys == (0, 1, 2) and eng.n_graphs == 0 and g.capture_s == 0
    tok, staged = g.step(0)
    assert tok is not eng._dev["tok"] and torch.equal(tok, eng._dev["tok"])
    assert staged.shape == (3 * 1, 4, eng.pool.block_shape[1])
    with pytest.raises(ValueError, match="no engine step of 3"):
        g.step(3)
    assert ServeEngine(api, params, EngineConfig(**BASE)).graphs is None
