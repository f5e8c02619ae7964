"""Port's sharded serving (``serve/shard.py``, ``launch/mesh.py``): the
contracts of ``tests/test_shard_serve.py`` on ``repro_torch``, run on CPU
meshes of logical ranks (``make_debug_mesh(model, devices=[cpu] * n)``),
so no case skips for lack of devices.

The differential lane: ``ShardedServeEngine`` over every mesh the
reference tests ((1,1), (2,1), (4,1), (1,4), (2,2)) serves the port's flat
``ServeEngine``'s tokens, admission/done steps and states, at K = 1/4/8
and depths 1/2, for ring, recurrent (rwkv6-7b, no pool) and mixed-tenant
workloads; block ownership follows the slot; ICI bytes appear exactly on
the axes of size > 1; one ``_Readback.wait`` per megastep per mesh. Then
across packages, in process: the port's (2, 2) engine against the JAX
package's single-device ``ServeEngine`` (float32 weights) for ring K = 4
depth 2, rwkv6-7b and the mixed KV-store tenant (the store's checksum
within rtol 1e-4, as ``tests/test_torch_workloads.py`` holds it: the pool
tensors agree within the kernels' tolerances, not bit for bit), and
``IciMeter`` exactly equal to the reference's on duck meshes of shape
(2, 2) and (4, 1)."""

import dataclasses
import warnings

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
from repro.serve import KVStoreTenant as JaxKVStoreTenant  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.shard import IciMeter as JaxIciMeter  # noqa: E402
from repro_torch.core import channel as channel_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               ServeEngine, ShardedServeEngine)
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.shard import IciMeter  # noqa: E402

CPU = torch.device("cpu")


def _mesh(data, model):
    return make_debug_mesh(model, devices=[CPU] * (data * model))


@pytest.fixture(scope="module")
def api():
    return TR.build("smollm-135m", smoke=True, device="cpu")


@pytest.fixture(scope="module")
def params(api):
    return api.init(torch.Generator().manual_seed(0))


def _cfg(**kw):
    base = dict(max_batch=4, cache_len=64, block_tokens=4, hbm_blocks=6,
                prefill_chunk=3, max_queue=8, megastep=4,
                pipeline_depth=2, device="cpu")
    base.update(kw)
    return EngineConfig(**base)


def _prompts(vocab, n, prompt_len, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, prompt_len).astype(np.int32)
            for _ in range(n)]


def _drive(api, eng, n=5, gen=8, seed=1, prompt_len=6):
    """The reference's staggered greedy workload; per-submission-order
    tokens, (admitted, done) steps and final states (rids are process-wide
    counters, so order, not rid, joins two engines)."""
    rids = [eng.submit(p, gen, arrival_step=2 * i).rid
            for i, p in enumerate(_prompts(api.cfg.vocab, n, prompt_len,
                                           seed))]
    outs = eng.run()
    toks = [np.asarray(outs[r]) for r in rids]
    timing = [(eng.completed[r].admitted_step, eng.completed[r].done_step)
              for r in rids]
    states = [eng.completed[r].state for r in rids]
    return toks, timing, states


_REF = {}


def _reference(api, params, **cfg_kw):
    """The flat engine's run, cached per config cell."""
    key = tuple(sorted(cfg_kw.items()))
    if key not in _REF:
        _REF[key] = _drive(api, ServeEngine(api, params, _cfg(**cfg_kw)))
    return _REF[key]


def _assert_differential(got, ref):
    assert len(got[0]) == len(ref[0])
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == ref[1], "admission/completion timing diverged"
    assert got[2] == ref[2], "request states diverged"


class TestMakeDebugMeshFallback:
    """An unsatisfiable model axis falls back with a warning that names
    the port's remedy (``devices=``), not a reshape error."""

    def test_model_axis_exceeding_devices_falls_back(self):
        with pytest.warns(RuntimeWarning, match="falling back to"):
            mesh = make_debug_mesh(3, devices=[CPU])
        assert dict(mesh.shape) == {"data": 1, "model": 1}

    def test_falls_back_to_largest_divisor(self):
        with pytest.warns(RuntimeWarning, match="model=2"):
            mesh = make_debug_mesh(3, devices=[CPU] * 4)
        assert dict(mesh.shape) == {"data": 2, "model": 2}

    def test_warning_names_the_devices_remedy(self):
        with pytest.warns(RuntimeWarning, match="devices="):
            make_debug_mesh(2, devices=[CPU])

    def test_exact_divisor_is_silent(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mesh = make_debug_mesh(1, devices=[CPU])
        assert dict(mesh.shape) == {"data": 1, "model": 1}

    def test_model_below_one_raises(self):
        with pytest.raises(ValueError, match="model"):
            make_debug_mesh(0)

    def test_default_is_the_cuda_devices(self):
        if torch.cuda.is_available():
            pytest.skip("this checks the no-GPU behaviour")
        with pytest.raises(RuntimeError, match="torch.device\\('cpu'\\)"):
            make_debug_mesh()

    def test_axes_and_grid(self):
        mesh = _mesh(2, 2)
        assert mesh.axis_names == ("data", "model")
        assert mesh.devices.shape == (2, 2)
        assert mesh_lib.data_axes(mesh) == ("data",)
        assert mesh_lib.axis_size(mesh, ("data", "model")) == 4


class TestShardDifferential:
    """The core lane: sharded == flat, token for token and step for
    step."""

    @pytest.mark.parametrize("megastep", [1, 4, 8])
    @pytest.mark.parametrize("depth", [1, 2])
    def test_ring_matrix_on_2x2(self, api, params, megastep, depth):
        ref = _reference(api, params, megastep=megastep,
                         pipeline_depth=depth)
        eng = ShardedServeEngine(
            api, params, _cfg(megastep=megastep, pipeline_depth=depth),
            mesh=_mesh(2, 2))
        _assert_differential(_drive(api, eng), ref)
        assert not eng.failed
        eng.pool.check_invariants()
        st = eng.paging_stats()
        assert st["mesh"] == {"data": 2, "model": 2}
        assert st["by_path"]["/serve/ici/model"]["bytes"] > 0
        assert st["by_path"]["/serve/ici/data"]["bytes"] > 0

    @pytest.mark.parametrize("dm", [(1, 1), (2, 1), (4, 1), (1, 4)])
    def test_mesh_shapes(self, api, params, dm):
        """Pure-data, pure-model and trivial meshes all reproduce the flat
        engine; ICI bytes appear exactly on the axes that exist."""
        d, m = dm
        ref = _reference(api, params)
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(d, m))
        _assert_differential(_drive(api, eng), ref)
        eng.pool.check_invariants()
        st = eng.paging_stats()
        assert ("/serve/ici/model" in st["by_path"]) == (m > 1)
        assert ("/serve/ici/data" in st["by_path"]) == (d > 1)
        if d == 1 and m == 1:
            assert st["ici"]["bytes"] == 0.0
        assert len(eng.ranks) == d * m

    def test_graph_bookkeeping_on_2x2(self, api, params):
        """``_graphs=True`` on the CPU: every rank steps through its own
        ``StepGraphs`` over its own static tensors (direct calls in place
        of replays), with the flat engine's tokens; the static tensors
        are written in place, never rebound."""
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(2, 2),
                                 _graphs=True)
        ptrs = [{k: v.data_ptr() for k, v in rk.dev.items()}
                for rk in eng.ranks]
        assert all(rk.graphs is not None for rk in eng.ranks)
        _assert_differential(_drive(api, eng), _reference(api, params))
        assert ptrs == [{k: v.data_ptr() for k, v in rk.dev.items()}
                        for rk in eng.ranks]

    def test_model_replicas_are_separate_tensors(self, api, params):
        """Each model rank holds its own copy of its band, so a replica
        that drifts surfaces as a readback divergence (the reduction is a
        maximum, not a pick)."""
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(1, 2))
        a, b = eng.ranks
        assert a.cache["k"].data_ptr() != b.cache["k"].data_ptr()
        assert a.dev["state"].data_ptr() != b.dev["state"].data_ptr()
        assert a.params is b.params        # one placement per device
        eng.submit(np.ones(5, np.int32), 6)
        eng.megastep(1)
        b.dev["n_gen"] += 7                # replica 1 drifts
        with pytest.raises(RuntimeError, match="diverged"):
            eng.megastep(1)

    def test_recurrent_cache_family(self):
        """The recurrent (rwkv) cache family shards the same way: its
        cache leaves are (L, B, ...) state rows, split over data."""
        api_r = TR.build("rwkv6-7b", smoke=True, device="cpu")
        params_r = api_r.init(torch.Generator().manual_seed(0))
        ref = _drive(api_r, ServeEngine(api_r, params_r, _cfg()),
                     n=4, gen=6, seed=2, prompt_len=5)
        eng = ShardedServeEngine(api_r, params_r, _cfg(), mesh=_mesh(2, 2))
        _assert_differential(
            _drive(api_r, eng, n=4, gen=6, seed=2, prompt_len=5), ref)
        assert eng.pool is None        # recurrent family: no paged pool

    def test_mixed_tenant(self, api, params):
        """LLM rows + a KV-store tenant sharing the pool: tokens, op
        counts and the tenant's GET checksum all match, and the tenant's
        blocks pin to shard 0."""
        def run(eng):
            kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                              store_blocks=16))
            kv.preload(8)
            kv.submit("sequential", n_steps=12)
            toks, timing, states = _drive(api, eng, n=4)
            return toks, timing, states, kv.ops_done, kv.result(), eng, kv

        cfg_kw = dict(pool_blocks=96, hbm_blocks=14)
        *ref, _, _ = run(ServeEngine(api, params, _cfg(**cfg_kw)))
        *got, eng, kv = run(ShardedServeEngine(
            api, params, _cfg(**cfg_kw), mesh=_mesh(2, 2)))
        _assert_differential(got[:3], ref[:3])
        assert got[3] == ref[3] and got[4] == ref[4]
        assert all(eng.pool.shard_of(b) == 0 for b in kv._store)
        eng.pool.check_invariants()

    def test_block_ownership_follows_slot(self, api, params):
        """Every request's KV blocks come from the pool shard owning its
        slot — checked at every megastep boundary, with the cross-shard
        disjointness invariant."""
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(2, 2))
        for i, p in enumerate(_prompts(api.cfg.vocab, 5, 6, 9)):
            eng.submit(p, 10, arrival_step=i)
        saw_blocks = False
        for _ in range(60):
            if not eng.pending():
                break
            eng.megastep(4)
            for r in eng.active():
                shard = r.slot // eng.slots_per_shard
                for b in r.blocks:
                    assert eng.pool.shard_of(b) == shard, (r.slot, b)
                saw_blocks = saw_blocks or bool(r.blocks)
            eng.pool.check_invariants()
        assert not eng.pending()
        assert saw_blocks

    def test_uneven_batch_rejected(self, api, params):
        with pytest.raises(ValueError, match="data axis"):
            ShardedServeEngine(api, params, _cfg(max_batch=3),
                               mesh=_mesh(2, 1))

    def test_mesh_device_kind_must_match(self, api, params):
        mesh = mesh_lib.Mesh(np.array([[torch.device("meta")]],
                                      dtype=object))
        with pytest.raises(ValueError, match="mesh's devices"):
            ShardedServeEngine(api, params, _cfg(), mesh=mesh)


class TestShardSyncBudget:
    """One packed readback per megastep per mesh (the port's
    ``_Readback.wait``), and the megastep functions an engine builds."""

    @pytest.mark.parametrize("dm", [(1, 1), (2, 1), (2, 2)])
    def test_one_readback_per_megastep(self, api, params, dm,
                                       monkeypatch):
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(*dm))
        for p in _prompts(api.cfg.vocab, 3, 6, 24):
            eng.submit(p, 20)
        eng.megastep(4)
        shapes = []
        real = engine_mod._Readback.wait

        def counted(self):
            out = real(self)
            shapes.append(out.shape)
            return out

        monkeypatch.setattr(engine_mod._Readback, "wait", counted)
        for _ in range(3):
            n = len(shapes)
            report = eng.megastep(4)
            assert len(shapes) == n + 1
            assert report["steps"] == 4
        # the one sync is the mesh-global packed (B, 3+K) readback
        assert all(s == (eng.cfg.max_batch, 3 + 4) for s in shapes)

    @pytest.mark.parametrize("dm", [(1, 1), (2, 1), (2, 2)])
    def test_megasteps_built_per_engine_and_k(self, api, params, dm,
                                              monkeypatch):
        """Stands for ``test_program_cached_per_mesh_cell`` (which counts
        jit retraces). The port builds one eager megastep function per K
        in an engine, which every rank calls on its own tensors (it holds
        no state), once per megastep; with step graphs each rank holds
        its own, at most ``prefill_chunk + 1``."""
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(*dm))
        calls = []
        real = engine_mod._megastep_math

        def counting(*a, **kw):
            mega = real(*a, **kw)

            def call(params, cache, dev, micro):
                calls.append(id(cache))
                return mega(params, cache, dev, micro)
            return call

        monkeypatch.setattr(engine_mod, "_megastep_math", counting)
        eng.submit(np.ones(5, np.int32), 8)
        eng.run(max_steps=100)
        assert set(eng._mega_fns) <= {1, 2, 4}
        fn = eng._mega_fn(4)
        assert eng._mega_fn(4) is fn
        d, m = dm
        assert len(calls) == d * m * eng.host_dispatches
        assert len(set(calls)) == d * m          # each rank's own cache
        graphed = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(*dm),
                                     _graphs=True)
        for rk in graphed.ranks:
            assert len(rk.graphs.keys) <= graphed.cfg.prefill_chunk + 1
        assert graphed._mega_fns == {}


class TestIciChannel:
    """The interconnect is a ``core.channel`` kind, billed with the same
    duplex/serial arithmetic as the host tiers."""

    def test_preset_registered(self):
        link = channel_lib.INTERCONNECT_PRESETS["ici"]
        assert isinstance(link, channel_lib.ChannelModel)
        assert link.duplex

    def test_meter_allreduce_wire_volume(self):
        m = IciMeter(_mesh(1, 1))
        m.axis_size = {"data": 1, "model": 4}      # synthetic 4-rank axis
        m.note_allreduce("model", 1000.0)
        st = m.by_path["/serve/ici/model"]
        # ring all-reduce: 2(m-1)/m per direction -> 1500 read + 1500
        # written per device
        assert st["bytes"] == pytest.approx(3000.0)
        assert st["collectives"] == 1
        assert st["duplex_us"] > 0
        assert st["serial_us"] > st["duplex_us"]   # duplex overlaps legs
        m.note_allgather("data", 0.0)              # degenerate: no-op
        m.note_allreduce("data", 500.0)            # axis size 1: no-op
        assert "/serve/ici/data" not in m.by_path
        assert m.summary()["links"] == {"data": 1, "model": 4}

    def test_model_axis_bills_into_paths(self, api, params):
        eng = ShardedServeEngine(api, params, _cfg(), mesh=_mesh(1, 2))
        _drive(api, eng, n=3)
        st = eng.paging_stats()
        ici = st["ici"]
        assert ici["bytes"] > 0 and ici["collectives"] > 0
        assert ici["duplex_us"] > 0
        mp = st["by_path"]["/serve/ici/model"]
        assert mp["bytes"] == ici["bytes"]
        assert "/serve/ici/data" not in st["by_path"]


class _DuckMesh:
    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("dm", [(2, 2), (4, 1)])
def test_ici_meter_equals_reference(dm):
    """The same collectives through the port's meter and the
    reference's: every path's bytes, counts and modelled microseconds,
    the summary and the snapshot state, exactly."""
    meters = [IciMeter(_DuckMesh(*dm)), JaxIciMeter(_DuckMesh(*dm))]
    for m in meters:
        for i in range(1, 40):
            m.note_allreduce("model", 1152.0 * i)
            m.note_allgather("data", 44.0 * i + 0.5)
            m.note_allreduce("data", 96.0 * (i % 7))
            m.note_allgather("model", 3.0 * (i % 5))
    assert meters[0].by_path == meters[1].by_path
    assert meters[0].summary() == meters[1].summary()
    assert meters[0].snapshot_state() == meters[1].snapshot_state()


# ---------------------------------------------------------------------------
# across packages: the port's (2, 2) engine against the JAX flat engine
# ---------------------------------------------------------------------------

def _f32_models(arch: str, seed: int):
    """The reference's weights in float32 for both packages."""
    japi0 = R.build(arch, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(seed))
    maker = R._rwkv_api if arch == "rwkv6-7b" else R._lm_api
    japi = maker(arch, dataclasses.replace(japi0.cfg, dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    if arch == "rwkv6-7b":
        tapi = TR._rwkv_api(arch, tcfg, "cpu")
        tp = TW.params_from_jax(host, tcfg)
    else:
        tapi = TR._lm_api(arch, tcfg, "cpu")
        tp = TT.params_from_jax(host, tcfg)
    return (japi, jp32), (tapi, tp)


JAX_CELLS = {
    "ring": dict(arch="smollm-135m", cfg={}, tenant=False),
    "rwkv": dict(arch="rwkv6-7b", cfg={}, tenant=False),
    "mixed": dict(arch="smollm-135m",
                  cfg=dict(pool_blocks=96, hbm_blocks=14), tenant=True),
}


@pytest.mark.parametrize("cell", list(JAX_CELLS))
def test_2x2_equals_the_jax_flat_engine(cell):
    """The port's (2, 2) sharded engine and the JAX package's flat engine
    on the same float32 weights, prompts and config (K = 4, depth 2):
    the same tokens, admission/done steps and states; with the KV-store
    tenant also the same op counts and store size, and its checksum
    within rtol 1e-4."""
    spec = JAX_CELLS[cell]
    (japi, jp), (tapi, tp) = _f32_models(spec["arch"], 0)
    kw = {**dict(max_batch=4, cache_len=64, block_tokens=4, hbm_blocks=6,
                 prefill_chunk=3, max_queue=8, megastep=4,
                 pipeline_depth=2), **spec["cfg"]}
    je = JaxServeEngine(japi, jp, JaxEngineConfig(**kw))
    te = ShardedServeEngine(tapi, tp, EngineConfig(**kw, device="cpu"),
                            mesh=_mesh(2, 2))
    kvs = []
    if spec["tenant"]:
        for eng, cls in ((je, JaxKVStoreTenant), (te, KVStoreTenant)):
            kv = eng.add_tenant(cls(n_slots=2, ops_per_step=2,
                                    store_blocks=16))
            kv.preload(8)
            kv.submit("sequential", n_steps=12)
            kvs.append(kv)
    runs = [_drive(japi, je, n=4), _drive(tapi, te, n=4)]
    _assert_differential(runs[1], runs[0])
    assert not te.failed and not je.failed
    if spec["tenant"]:
        jkv, tkv = kvs
        assert tkv.ops_done == jkv.ops_done > 0
        # the store's block ids differ: the LLM rows take theirs from
        # their own shard here, from the one pool there
        assert len(tkv._store) == len(jkv._store)
        np.testing.assert_allclose(tkv.result(), jkv.result(), rtol=1e-4)
        te.pool.check_invariants()
