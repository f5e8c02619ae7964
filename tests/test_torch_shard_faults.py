"""Port's sharded engine under snapshots, fault plans and tracing: the
port's counterparts of ``tests/test_snapshot.py::TestShardedRestore``,
``tests/test_faults.py::TestShardedChaos`` and
``tests/test_trace.py::TestShardedTrace``, on CPU meshes of logical ranks
(no case skips for lack of devices).

  * restore: a (2, 2) engine killed by ``crash:@9`` and restored into a
    fresh engine on the same mesh resumes with the uncrashed run's
    signature (tokens, admission and done steps, billing per path and per
    channel, ``/serve/ici/*`` included, fault stats); the restore writes
    every rank's tensors in place; a snapshot of another mesh is refused;
  * chaos: seeded fault plans replay bit for bit on a (2, 2) mesh, poison
    routes to the shard owning the block's global-id band, and an offline
    channel evacuates on every shard without a row crossing shards;
  * trace: every data rank's channels on ``shard<s>/`` tracks and the
    model axis's collectives on an ``ici:model`` track, in the Perfetto
    export too."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

from repro_torch.core.faults import (CrashFault, FaultInjector,  # noqa: E402
                                     parse_fault_plan)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import (EngineConfig, FAILED,  # noqa: E402
                               ServeEngine, ShardedServeEngine)

CPU = torch.device("cpu")
N_REQ, PROMPT_LEN = 4, 6
PROMPTS = np.random.default_rng(77).integers(
    0, 256, (N_REQ, PROMPT_LEN)).astype(np.int32)


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


def _submit_all(eng, gen):
    return [eng.submit(PROMPTS[i], gen, arrival_step=2 * i)
            for i in range(N_REQ)]


# ---------------------------------------------------------------------------
# TestShardedRestore
# ---------------------------------------------------------------------------

_BILLING_KEYS = ("duplex_us", "serial_us", "page_ins", "page_outs",
                 "kernel_calls")


def _signature(eng):
    """``tests/test_snapshot.py``'s ``_signature``, the ICI paths among
    ``by_path``: everything a bit-exact resume must reproduce."""
    toks = [list(eng.completed[rid].generated)
            for rid in sorted(eng.completed)]
    timing = [(eng.completed[rid].admitted_step,
               eng.completed[rid].done_step)
              for rid in sorted(eng.completed)]
    errors = sorted((r.error["kind"], r.error.get("block", -1))
                    for r in eng.failed.values())
    ps = eng.paging_stats()
    billing = {k: ps.get(k) for k in _BILLING_KEYS}
    billing["by_path"] = {
        path: {k: st[k] for k in ("duplex_us", "serial_us")}
        for path, st in ps["by_path"].items()}
    billing["ici"] = ps["ici"]
    if ps.get("tiers"):
        billing["tiers"] = {
            name: {k: ch[k] for k in ("busy_us", "read_bytes",
                                      "write_bytes")}
            for name, ch in ps["tiers"]["channels"].items()}
    return toks, timing, errors, billing, dict(eng.stats()["faults"])


class TestShardedRestore:
    @pytest.mark.parametrize("tiers", [None, "ddr5:1,cxl:1"])
    def test_mesh_crash_restore_bit_exact(self, api, params, tmp_path,
                                          tiers):
        """(2, 2) mesh: the shards' pool state fans out into one
        manifest; the restore writes each data band into every rank that
        holds it, in place, and resumes bit-exactly."""
        mesh = _mesh(2, 2)
        ref = ShardedServeEngine(api, params, _cfg(
            snapshot_every=2, snapshot_dir=str(tmp_path / "ref"),
            faults=FaultInjector([]), tiers=tiers), mesh=mesh)
        _submit_all(ref, 10)
        ref.run(max_steps=600)

        d = str(tmp_path / "crash")
        eng = ShardedServeEngine(api, params, _cfg(
            snapshot_every=2, snapshot_dir=d,
            faults=FaultInjector(parse_fault_plan("crash:@9")),
            tiers=tiers), mesh=mesh)
        _submit_all(eng, 10)
        with pytest.raises(CrashFault):
            eng.run(max_steps=600)

        eng2 = ShardedServeEngine(api, params, _cfg(
            snapshot_every=2, snapshot_dir=d,
            faults=FaultInjector(parse_fault_plan("crash:@9")),
            tiers=tiers), mesh=mesh)
        ptrs = [(rk.cache["k"].data_ptr(), rk.dev["tok"].data_ptr())
                for rk in eng2.ranks]
        info = eng2.restore()
        assert info["restored_step"] > 0
        assert ptrs == [(rk.cache["k"].data_ptr(), rk.dev["tok"].data_ptr())
                        for rk in eng2.ranks]
        eng2.run(max_steps=600)
        assert _signature(eng2) == _signature(ref)
        assert eng2.paging_stats()["ici"]["bytes"] > 0
        eng2.pool.check_invariants()

    def test_mesh_mismatch_rejected(self, api, params, tmp_path):
        d = str(tmp_path)
        eng = ShardedServeEngine(api, params, _cfg(
            snapshot_every=2, snapshot_dir=d,
            faults=FaultInjector(parse_fault_plan("crash:@9"))),
            mesh=_mesh(2, 1))
        _submit_all(eng, 10)
        with pytest.raises(CrashFault):
            eng.run(max_steps=600)
        eng2 = ShardedServeEngine(api, params, _cfg(
            snapshot_every=2, snapshot_dir=d,
            faults=FaultInjector([])), mesh=_mesh(1, 1))
        with pytest.raises(ValueError, match="mesh"):
            eng2.restore()


# ---------------------------------------------------------------------------
# TestShardedChaos
# ---------------------------------------------------------------------------

GEN = 12


@pytest.fixture(scope="module")
def baseline(api, params):
    """Fault-free oracle: submission index -> served tokens, from the
    flat engine."""
    eng = ServeEngine(api, params, _cfg(max_batch=3))
    reqs = _submit_all(eng, GEN)
    outs = eng.run(max_steps=600)
    return [np.asarray(outs[r.rid]) for r in reqs]


def _serve_sharded(api, params, *, max_steps=600, **cfg_kw):
    eng = ShardedServeEngine(api, params, _cfg(**cfg_kw), mesh=_mesh(2, 2))
    reqs = _submit_all(eng, GEN)
    outs = eng.run(max_steps=max_steps)
    return eng, reqs, outs


def _check_survivors(eng, reqs, outs, oracle, allowed_kinds):
    """Every request either matches the oracle token for token or
    carries a structured error of an expected kind."""
    for i, r in enumerate(reqs):
        if r.rid in outs:
            np.testing.assert_array_equal(np.asarray(outs[r.rid]),
                                          oracle[i])
        else:
            fr = eng.failed[r.rid]
            assert fr.state == FAILED
            assert fr.error is not None
            assert fr.error["kind"] in allowed_kinds
            assert "step" in fr.error


class TestShardedChaos:
    @staticmethod
    def _signature(eng, reqs, outs):
        toks = [np.asarray(outs[r.rid]).tolist() if r.rid in outs
                else None for r in reqs]
        timing = [(eng.completed[r.rid].admitted_step,
                   eng.completed[r.rid].done_step)
                  if r.rid in eng.completed else None for r in reqs]
        errors = sorted(
            (r.error["kind"], r.error.get("block", -1), r.error["step"])
            for r in eng.failed.values())
        return toks, timing, errors, dict(eng.stats()["faults"])

    def test_seeded_plan_replays_bit_identical(self, api, params):
        """Same plan + same injector seed => the sharded run reproduces
        tokens, timing, structured errors and fault counters exactly."""
        plan = ("transient:0@2+40=0.4,degrade:1@4+12=0.5,"
                "poison:0@6,poison:1@7,offline:2@10")

        def once():
            fx = FaultInjector(parse_fault_plan(plan), seed=11)
            eng, reqs, outs = _serve_sharded(
                api, params, faults=fx, tiers="ddr5:1,cxl:2")
            eng.pool.check_invariants()
            return self._signature(eng, reqs, outs)

        assert once() == once()

    def test_transients_bit_exact_with_oracle(self, api, params, baseline):
        """Transient retries on every shard's channels show only in billed
        time: all four requests finish with the fault-free tokens."""
        fx = FaultInjector(parse_fault_plan(
            "transient:0@1+80=0.5,degrade:0@4+40=0.25"), seed=3)
        eng, reqs, outs = _serve_sharded(api, params, faults=fx)
        _check_survivors(eng, reqs, outs, baseline, set())
        assert not eng.failed
        f = eng.stats()["faults"]
        assert f["retried"] > 0 and f["recovered"] > 0
        eng.pool.check_invariants()

    def test_poison_routes_to_owning_shard(self, api, params, baseline):
        """Poison aimed at shard 1's global-id band quarantines host slots
        on shard 1 only; shard 0's capacity is untouched, and every failed
        request was a shard-1 resident."""
        per = 24                                  # blocks per shard
        fx = FaultInjector(parse_fault_plan(
            f"poison:{per}@2,poison:{per + 1}@3,poison:{per + 2}@3"),
            seed=0)
        eng, reqs, outs = _serve_sharded(
            api, params, faults=fx, tiers="ddr5:1,cxl:2",
            pool_blocks=per, hbm_blocks=4)
        f = eng.stats()["faults"]
        assert f["quarantined"] > 0
        assert eng.failed
        _check_survivors(eng, reqs, outs, baseline, {"poisoned_block"})
        s0, s1 = eng.pool.shards
        assert int(s0.host._quarantined.sum()) == 0
        assert int(s1.host._quarantined.sum()) == f["quarantined"]
        assert not s0.host.capacity_degraded
        for fr in eng.failed.values():
            assert fr.error["block"] >= per    # the poisoned band
        eng.pool.check_invariants()

    def test_offline_evacuation_stays_shard_local(self, api, params,
                                                  baseline):
        """Hot-unplug of tier channel 2: every shard loses its channel 2
        and evacuates onto its own survivors; each shard's migrated_out is
        accounted in its own tier stats."""
        fx = FaultInjector(parse_fault_plan("offline:2@12"), seed=1)
        eng, reqs, outs = _serve_sharded(
            api, params, faults=fx, tiers="ddr5:1,cxl:2",
            pool_blocks=24, hbm_blocks=4)
        f = eng.stats()["faults"]
        assert f["offline_channels"] == [2]
        assert f["evacuated"] > 0
        _check_survivors(eng, reqs, outs, baseline,
                         {"evacuation_casualty", "shed"})
        migrated = 0
        for sh in eng.pool.shards:
            assert bool(sh.host.offline[2])
            dead = sh.tier_stats()["channels"]["cxl:2"]
            assert dead["offline"] and dead["slots_used"] == 0
            migrated += dead["migrated_out"]
        assert migrated >= f["evacuated"]
        eng.pool.check_invariants()


# ---------------------------------------------------------------------------
# TestShardedTrace
# ---------------------------------------------------------------------------

class TestShardedTrace:
    def test_shard_tracks_and_ici_links(self, api, params, tmp_path):
        eng = ShardedServeEngine(
            api, params,
            _cfg(tiers="ddr5:1,cxl:1", trace=str(tmp_path / "shard.json")),
            mesh=_mesh(2, 2))
        _submit_all(eng, 8)
        eng.run(max_steps=400)
        tracks = set(eng.tracer.timelines)
        # every data rank's channels are namespaced shard<s>/
        for s in range(2):
            assert any(t.startswith(f"shard{s}/") for t in tracks), tracks
        # the collectives of both axes on their own ici tracks
        assert any(t.startswith("ici:model") for t in tracks), tracks
        assert any(t.startswith("ici:data") for t in tracks), tracks
        path = eng.export_trace()
        doc = json.load(open(path))
        thread_names = {e["args"]["name"]
                        for e in doc["traceEvents"]
                        if e["ph"] == "M" and e["name"] == "thread_name"}
        assert any(n.startswith("shard0/") for n in thread_names)
        assert any(n.startswith("ici:model") for n in thread_names)
