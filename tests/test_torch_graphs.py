"""The engine steps as graphs over static buffers (``serve/graphs.py``),
on the CPU: a "replay" there calls the step function directly on the
same static tensors the CUDA graphs read, so the bookkeeping around the
replays — the slot state and cache updated in place, admission written
into them, each step's tokens and staged slab copied out, the packed
readback — runs here. Against the eager ``_megastep_math``: token-exact,
with equal ``stats()``, ``paging_stats()`` and micro-step counts, at
K = 1/2/4/8, pipeline depth 1 and 2 and prefill_chunk 1 and 4, with the
tenants attached, for a recurrent cache (rwkv6-7b) and for the nested
caches of zamba2-7b and whisper-base; the same run as the JAX engine; and
the capture's warm-up on a nested copy of the cache."""

import contextlib
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


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-base"])
@pytest.mark.parametrize("megastep", [1, 8])
def test_graph_steps_nested_cache(arch, megastep):
    """zamba2-7b (Mamba state kept, rings written in place) and
    whisper-base (self rings, cross K/V): unpaged, the static nested cache
    written in place by the steps, equal to the eager megastep and to
    ``reference_decode``."""
    api = TR.build(arch, smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, api.cfg.vocab, n).astype(np.int32)
               for n in (4, 7, 3, 6)]
    cfg = EngineConfig(max_batch=2, cache_len=32, prefill_chunk=3,
                       megastep=megastep, pipeline_depth=2, device="cpu")
    eager = _serve(api, params, cfg, prompts, 5, graphs=False)
    graphed = _serve(api, params, cfg, prompts, 5, graphs=True)
    _assert_same_run(eager, graphed)
    assert graphed[2]["paged"] is False
    leaves = list(nn.tree_leaves(graphed[4].cache))
    assert all(a is b for a, b in zip(leaves, nn.tree_leaves(
        graphed[4].graphs._cache)))
    for p, got in zip(prompts, graphed[0]):
        want = reference_decode(api, params, p[None], 5,
                                cache_len=32).numpy()[0]
        np.testing.assert_array_equal(got, want)


class _NoCuda:
    """Stand-ins for the ``torch.cuda`` calls ``StepGraphs._capture_all``
    makes, so its host logic runs on the CPU: streams and graphs that do
    nothing, a capture context that runs the step eagerly."""

    class Stream:
        def wait_stream(self, other):
            pass

    class CUDAGraph:
        def replay(self):
            pass

    @staticmethod
    @contextlib.contextmanager
    def ctx(*args, **kwargs):
        yield


def test_capture_warms_up_on_a_nested_copy(monkeypatch):
    """The capture's warm-up is a real step, so it must run on a copy of
    the state: for zamba2-7b's nested cache, the warm-up of every graph
    gets a tree of the static cache's structure whose every leaf is a new
    tensor, equal in value to the static leaf at the first warm-up; the
    capture itself gets the static tensors."""
    api = TR.build("zamba2-7b", smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(6))
    eng = ServeEngine(api, params, EngineConfig(
        max_batch=2, cache_len=16, prefill_chunk=2, device="cpu"),
        _graphs=False)
    for name, value in (("graph_pool_handle", lambda: None),
                        ("Stream", _NoCuda.Stream),
                        ("current_stream", lambda: _NoCuda.Stream()),
                        ("stream", _NoCuda.ctx),
                        ("CUDAGraph", _NoCuda.CUDAGraph),
                        ("graph", _NoCuda.ctx),
                        ("synchronize", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    static = list(nn.tree_leaves(eng.cache))
    for leaf in static:
        leaf.add_(1)
    start = [t.clone() for t in static]
    calls = []
    from repro_torch.serve.engine import _engine_step_math
    step_fn = _engine_step_math(api, 2, None)

    def spy(params, cache, dev, m):
        leaves = list(nn.tree_leaves(cache))
        calls.append((m, leaves, [t.clone() for t in leaves]))
        return step_fn(params, cache, dev, m)

    graphs = StepGraphs(spy, params, eng.cache, eng._dev, 2, extract=False,
                        capture=True)
    assert graphs.captured and graphs.keys == (1, 2)
    assert [c[0] for c in calls] == [1, 1, 2, 2]
    for i, (m, leaves, values) in enumerate(calls):
        if i % 2 == 0:      # the warm-up on the side stream
            assert len(leaves) == len(static)
            for leaf, ref, val in zip(leaves, static, values):
                assert leaf is not ref
                assert leaf.data_ptr() != ref.data_ptr()
                assert leaf.shape == ref.shape and leaf.dtype == ref.dtype
            if i == 0:
                assert all(torch.equal(v, ref)
                           for v, ref in zip(values, start))
        else:               # the capture, on the static tensors
            assert all(a is b for a, b in zip(leaves, static))
    nested = graphs._cache
    assert set(nested) == {"mamba", "attn"} and nested is eng.cache


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
