"""Port's multi-tenant serving: the contracts of ``tests/test_workloads.py``
on ``repro_torch`` (KV-store and vector-search tenants on the real paged
data plane, LLM decode exact beside them, duplex withdrawal per scope),
and one run on the same arguments as the JAX engine (float32 weights):
equal tokens, admission and completion steps, tenant state, paging stats
and billing, kernel call sequence and ``duplex_speedup``; checksums and
minima within rtol 1e-4; pool tensors within one bf16 ulp and int8 codes
within 1 LSB."""

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
from repro.serve import KVStoreTenant as JaxKVStoreTenant  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import VectorSearchTenant as JaxVectorTenant  # noqa: E402
from repro.serve import workloads as jwl  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               ServeEngine, VectorSearchTenant,
                               reference_decode)
from repro_torch.serve import kv_pool as kv_pool_mod  # noqa: E402
from repro_torch.serve.workloads import (_synth_blocks,  # noqa: E402
                                         kv_value_seed)

ARCH = "smollm-135m"
STREAM_KERNELS = ("duplex_kv_stream", "dequant_kv_stream", "quant_kv_stream")


@pytest.fixture(scope="module")
def api():
    return TR.build(ARCH, smoke=True, device="cpu")


@pytest.fixture(scope="module")
def params(api):
    return api.init(torch.Generator().manual_seed(0))


@pytest.fixture
def port_kernel_calls(monkeypatch):
    """The port's twin of ``conftest.kernel_call_counter``: (entry point,
    n_blocks) per stream-kernel call the pool makes."""
    calls: list[tuple[str, int]] = []
    for name in STREAM_KERNELS:
        real = getattr(kv_pool_mod.kernel_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[0].shape[0]))
            return _real(*a, **kw)

        monkeypatch.setattr(kv_pool_mod.kernel_ops, name, counting)
    return calls


def _engine(api, params, *, hbm=14, pool=96, batch=2, policy="hinted"):
    return ServeEngine(api, params, EngineConfig(
        max_batch=batch, cache_len=64, block_tokens=4, hbm_blocks=hbm,
        pool_blocks=pool, prefill_chunk=2, max_queue=16, policy=policy,
        device="cpu"))


def _synth(seeds, T, D):
    return _synth_blocks(torch.tensor(seeds, dtype=torch.int32), tokens=T,
                         dims=D).float().numpy()


class TestKVStoreTenant:
    def test_op_streams_execute_real_data(self, api, params):
        eng = _engine(api, params)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=16))
        reqs = [kv.submit("gaussian", n_steps=30) for _ in range(2)]
        eng.run(max_steps=200)
        assert all(r.rid in eng.completed for r in reqs)
        assert kv.ops_done > 0
        assert kv.result() != 0.0           # GETs really read data
        T, D = eng.pool.block_shape
        checked = 0
        for b in kv._store:
            slot = eng.pool.slot_of[b]
            if slot < 0 or b not in kv._version:
                continue
            want = _synth([kv_value_seed(b, kv._version[b])], T, D)[0]
            got = eng.pool.hbm[slot].float().numpy()
            assert np.abs(got - want).max() <= 1.0 / 127.0 + 0.05
            checked += 1
        assert checked > 0

    def test_paging_traffic_flows_through_pool(self, api, params):
        eng = _engine(api, params, hbm=6)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=16))
        for _ in range(2):
            kv.submit("gaussian", n_steps=30)
        eng.run(max_steps=200)
        path = eng.paging_stats()["by_path"].get("/serve/redis/gaussian")
        assert path is not None
        assert path["page_ins"] > 0 and path["page_outs"] > 0
        eng.pool.check_invariants()

    def test_five_patterns_produce_schedules(self, api, params):
        eng = _engine(api, params)
        kv = eng.add_tenant(KVStoreTenant(n_slots=5, ops_per_step=2,
                                          store_blocks=8))
        for pattern in ("read_heavy", "write_heavy", "pipelined",
                        "sequential", "gaussian"):
            req = kv.submit(pattern, n_steps=16)
            sched = req.work.schedule
            assert sched.shape == (16, 2)
            assert sched.sum() > 0
            assert req.hint_path.startswith("/serve/redis/")

    def test_sequential_streams_alternate_phase_and_scope(self, api,
                                                          params):
        eng = _engine(api, params)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2))
        a = kv.submit("sequential", n_steps=32)
        b = kv.submit("sequential", n_steps=32)
        assert a.hint_path == "/serve/redis/seq/read"
        assert b.hint_path == "/serve/redis/seq/write"
        assert a.work.schedule[0, 0] > 0 and a.work.schedule[0, 1] == 0
        assert b.work.schedule[0, 1] > 0 and b.work.schedule[0, 0] == 0


class TestMixedTenantExactness:
    def test_llm_decode_unchanged_by_tenant_traffic(self, api, params):
        prompts = np.random.default_rng(21).integers(
            0, api.cfg.vocab, (3, 6)).astype(np.int32)
        ref = reference_decode(api, params, prompts, 10,
                               cache_len=64).numpy()
        eng = _engine(api, params, hbm=16, batch=3)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=12))
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, visits_per_step=2, data_blocks=8))
        rids = [eng.submit(prompts[i], 10, arrival_step=2 * i).rid
                for i in range(3)]
        kv.submit("sequential", n_steps=30)
        kv.submit("sequential", n_steps=30)
        vec.submit(n_steps=24)
        outs = eng.run(max_steps=300)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(outs[rid], ref[i])
        assert kv.ops_done > 0 and vec.queries_done > 0
        eng.pool.check_invariants()


class TestDuplexWithdrawal:
    def test_opted_out_tenant_never_fused(self, api, params,
                                          port_kernel_calls):
        eng = _engine(api, params, hbm=6)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=16))
        kv.preload(16)
        for _ in range(2):
            kv.submit("read_heavy", n_steps=40)
        del port_kernel_calls[:]            # drop the preload's traffic
        eng.run(max_steps=300)
        path = eng.paging_stats()["by_path"]["/serve/redis/read_heavy"]
        assert path["page_ins"] > 0 and path["page_outs"] > 0
        assert path["duplex_us"] > 0
        assert path["fused_calls"] == 0
        assert path["duplex_us"] == pytest.approx(path["serial_us"])
        assert eng.pool.duplex_speedup("/serve/redis/read_heavy") == 1.0
        assert port_kernel_calls
        assert all(name != "duplex_kv_stream"
                   for name, _ in port_kernel_calls)

    def test_withdrawal_is_per_scope_not_global(self, api, params):
        eng = _engine(api, params, hbm=8)
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                          store_blocks=20))
        kv.preload(20)
        kv.submit("read_heavy", n_steps=48)
        kv.submit("gaussian", n_steps=48)
        eng.run(max_steps=300)
        by_path = eng.paging_stats()["by_path"]
        out = by_path["/serve/redis/read_heavy"]
        opted_in = by_path["/serve/redis/gaussian"]
        assert out["fused_calls"] == 0
        assert out["duplex_us"] == pytest.approx(out["serial_us"])
        assert opted_in["fused_calls"] > 0
        assert opted_in["duplex_us"] < opted_in["serial_us"]


class TestVectorSearchTenant:
    def test_best_distances_match_bruteforce(self, api, params):
        eng = _engine(api, params, hbm=16)   # dataset stays resident
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, n_queries=3, visits_per_step=2, data_blocks=6,
            load_per_step=2, result_every=4))
        req = vec.submit(n_steps=20)
        eng.run(max_steps=100)
        res = vec.result()
        best = res["best"][req.rid]
        T, D = eng.pool.block_shape
        data = _synth([vec.data_seed(i) for i in sorted(req.work.visited)],
                      T, D).reshape(-1, D)
        q = req.work.queries.numpy()
        want = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1).min(1)
        np.testing.assert_allclose(best, want, rtol=1e-2,
                                   atol=0.05 * D / 32)
        assert res["checksum"] > 0

    def test_result_writeback_creates_write_traffic(self, api, params):
        eng = _engine(api, params, hbm=6)
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, visits_per_step=2, data_blocks=12,
            load_per_step=1, result_every=3))
        vec.submit(n_steps=30)
        eng.run(max_steps=100)
        st = eng.paging_stats()
        assert st["page_ins"] > 0 and st["page_outs"] > 0
        assert st["duplex_speedup"] > 1.0    # walk reads overlap writes
        eng.pool.check_invariants()


class TestWorkloadAPIErrors:
    def test_submit_before_bind_raises(self):
        kv = KVStoreTenant()
        with pytest.raises(RuntimeError, match="not attached"):
            kv.submit("gaussian", n_steps=4)

    def test_unpaged_engine_rejects_tenants(self, api, params):
        eng = ServeEngine(api, params, EngineConfig(
            max_batch=2, cache_len=64, paging=False, device="cpu"))
        with pytest.raises(ValueError, match="paged"):
            eng.add_tenant(KVStoreTenant())

    def test_duplicate_tenant_name_rejected(self, api, params):
        eng = _engine(api, params)
        eng.add_tenant(KVStoreTenant(n_slots=1, ops_per_step=1))
        with pytest.raises(ValueError, match="already taken"):
            eng.add_tenant(KVStoreTenant(n_slots=1, ops_per_step=1))

    def test_tenant_reservation_bounded_by_hbm(self, api, params):
        eng = _engine(api, params, hbm=4)
        with pytest.raises(ValueError, match="reserve"):
            eng.add_tenant(KVStoreTenant(n_slots=4, ops_per_step=2))


def test_synth_blocks_within_one_bf16_ulp_of_the_reference():
    """The stored values of both tenants: f32 iotas and association as the
    reference, then ``sin`` (which may differ by an f32 ulp across the
    two frameworks) and a bf16 cast — equal within one bf16 ulp."""
    seeds = [0, 1, kv_value_seed(5, 3), 2 ** 31 - 2, 123456789]
    want = np.asarray(jwl._synth_blocks(jnp.asarray(seeds, np.int32),
                                        tokens=8, dims=96), np.float32)
    got = _synth(seeds, 8, 96)
    _assert_within_bf16_ulp(got, want)


def _assert_within_bf16_ulp(got, want):
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-30))) - 7), 0.0)
    assert np.all(np.abs(got - want) <= ulp)


# -- one run on the same arguments as the JAX engine ------------------------

def _models():
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


def _mixed_run(engine_cls, cfg, model, kv_cls, vec_cls, prompts):
    """LLM requests beside two sequential streams, a read-heavy stream
    (withdrawn scope) and a vector walk, over a preloaded store in an
    oversubscribed pool."""
    eng = engine_cls(*model, cfg)
    kv = eng.add_tenant(kv_cls(n_slots=2, ops_per_step=2, store_blocks=16))
    kv.preload(12)
    vec = eng.add_tenant(vec_cls(n_slots=1, n_queries=3, visits_per_step=2,
                                 data_blocks=8))
    rids = [eng.submit(p, 8, arrival_step=3 * i).rid
            for i, p in enumerate(prompts)]
    rids += [kv.submit("sequential", n_steps=20, arrival_step=1).rid,
             kv.submit("read_heavy", n_steps=24, arrival_step=2).rid,
             vec.submit(n_steps=20, arrival_step=4).rid,
             kv.submit("sequential", n_steps=16, arrival_step=6).rid]
    return eng, kv, vec, rids


def test_same_tenant_run_as_the_jax_engine(kernel_call_counter,
                                           port_kernel_calls):
    jmodel, tmodel = _models()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(rng.integers(4, 9))).astype(
        np.int32) for _ in range(4)]
    kw = dict(max_batch=2, cache_len=64, block_tokens=4, hbm_blocks=14,
              pool_blocks=96, prefill_chunk=2, max_queue=16, megastep=4,
              pipeline_depth=2)
    je, jkv, jvec, jr = _mixed_run(JaxServeEngine, JaxEngineConfig(**kw),
                                   jmodel, JaxKVStoreTenant,
                                   JaxVectorTenant, prompts)
    te, tkv, tvec, tr = _mixed_run(ServeEngine,
                                   EngineConfig(**kw, device="cpu"),
                                   tmodel, KVStoreTenant,
                                   VectorSearchTenant, prompts)
    del kernel_call_counter[:], port_kernel_calls[:]   # drop the preloads
    jo, to = je.run(max_steps=400), te.run(max_steps=400)

    for a, b in zip(jr, tr):
        ja, tb = je.completed[a], te.completed[b]
        assert (tb.admitted_step, tb.done_step) == \
            (ja.admitted_step, ja.done_step)
        if ja.tenant == "llm":
            np.testing.assert_array_equal(to[b], jo[a])
    assert tkv.ops_done == jkv.ops_done > 0
    assert tkv._store == jkv._store
    assert tkv._version == jkv._version
    assert tvec.queries_done == jvec.queries_done > 0
    assert te.paging_stats() == je.paging_stats()
    assert te.pool.duplex_speedup() == je.pool.duplex_speedup() > 1.0
    assert te.stats() == je.stats()
    assert port_kernel_calls == kernel_call_counter
    assert {name for name, _ in port_kernel_calls} == set(STREAM_KERNELS)

    np.testing.assert_allclose(tkv.result(), jkv.result(), rtol=1e-4)
    jres, tres = jvec.result(), tvec.result()
    np.testing.assert_allclose(tres["checksum"], jres["checksum"],
                               rtol=1e-4)
    for (ja, jb), (ta, tb) in zip(jres["best"].items(),
                                  tres["best"].items()):
        np.testing.assert_allclose(tb, np.asarray(jb), rtol=1e-4)

    np.testing.assert_array_equal(te.pool.slot_of, je.pool.slot_of)
    _assert_within_bf16_ulp(te.pool.hbm.float().numpy(),
                            np.asarray(je.pool.hbm, np.float32))
    live = np.flatnonzero(je.pool._has_host)
    np.testing.assert_array_equal(np.flatnonzero(te.pool._has_host), live)
    tq = te.pool.host_q.numpy()[live].astype(np.int32)
    jq = np.asarray(je.pool.host_q)[live].astype(np.int32)
    assert np.abs(tq - jq).max(initial=0) <= 1


def test_cli_co_serves_the_tenants(monkeypatch, capsys):
    import json
    import sys

    from repro_torch.launch import serve
    argv = ["serve", "--device", "cpu", "--requests", "2", "--gen", "4",
            "--tenants", "redis,vectordb", "--tenant-steps", "8",
            "--no-warmup"]
    monkeypatch.setattr(sys, "argv", argv)
    assert serve.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["tenants"] == ["redis", "vectordb"]
    assert report["generated_tokens"] == 8
    assert report["paging"]["tenants"]["redis"]["ops"] > 0
    assert report["paging"]["tenants"]["vectordb"]["queries"] == 4
    monkeypatch.setattr(sys, "argv", argv[:-1] + ["--no-paging"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "drop --no-paging" in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["serve", "--tenants", "memcached"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "known tenants: redis,vectordb" in capsys.readouterr().err
