"""The port's tracing plane and metrics registry (``repro_torch.serve.trace``,
``core.metrics``, ``core.telemetry``) against ``repro.serve.trace``,
``repro.core.metrics`` and ``repro.core.telemetry``.

A traced engine serves exactly as an untraced one: the same tokens,
``paging_stats()``, tier and fault stats (flat, ``ddr5:1,cxl:1`` beside a
KV-store tenant, and a fault plan with an offline channel). Against the
reference on the same arguments (smollm-135m SMOKE in float32, seeded):
the modelled-clock channel timelines, busy totals, ``duplex_util`` and
horizon, the modelled-clock instants (fault arrivals, migrations,
evacuations, failed requests by submission index) and the ``metrics()``
counters and gauges are equal exactly — host-deterministic arithmetic.
Host-clock spans and counters are compared by name and count only. The
scenarios avoid the reference's double-release of a host slot (ROADMAP
Queue 3): their tiered pools pass ``check_invariants`` in both packages.
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import KVStoreTenant as JaxKVStoreTenant  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import trace as jtrace  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import telemetry as ttelemetry  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               ServeEngine, Tracer)

ARCH = "smollm-135m"
PROMPTS = np.random.default_rng(31).integers(0, 256, (5, 6)).astype(np.int32)
SCENARIOS = {
    "flat": dict(hbm_blocks=6, pool_blocks=0),
    "tiered": dict(tiers="ddr5:1,cxl:1", kv=True),
    "faults": dict(tiers="ddr5:1,cxl:2", hbm_blocks=6, pool_blocks=0,
                   plan="offline:2@8,poison:0@6,transient:1@2+30=0.4"),
}


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
    return {"jax": (JaxServeEngine, JaxEngineConfig, JaxKVStoreTenant,
                    jfaults, japi, jp32),
            "torch": (ServeEngine, EngineConfig, KVStoreTenant, tfaults,
                      tapi, tp)}


def _serve(side, scenario, trace):
    """LLM requests on a small oversubscribed pool (megastep 4, depth 2),
    beside a KV-store tenant whose gaussian and read-heavy scopes prefer
    different tiers where ``kv``; returns the engine, the requests and
    the outputs."""
    engine_cls, cfg_cls, kv_cls, faults_mod, api, params = side
    kw = dict(SCENARIOS[scenario])
    kv_on, plan = kw.pop("kv", False), kw.pop("plan", None)
    base = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=10,
                pool_blocks=48, prefill_chunk=3, max_queue=16, megastep=4,
                pipeline_depth=2, trace=trace)
    base.update(kw)
    if cfg_cls is EngineConfig:
        base["device"] = "cpu"
    if plan is not None:
        base["faults"] = faults_mod.FaultInjector(
            faults_mod.parse_fault_plan(plan), seed=3)
    eng = engine_cls(api, params, cfg_cls(**base))
    if kv_on:
        kv = eng.add_tenant(kv_cls(n_slots=2, ops_per_step=2,
                                   store_blocks=12))
        kv.preload(12)
        kv.submit("gaussian", n_steps=24)
        kv.submit("read_heavy", n_steps=24, arrival_step=4)
    reqs = [eng.submit(PROMPTS[i], 10, arrival_step=2 * i)
            for i in range(len(PROMPTS))]
    outs = eng.run(max_steps=400)
    eng.pool.check_invariants()
    return eng, reqs, outs


def _outcome(eng, reqs, outs):
    served = {i: np.asarray(outs[r.rid]).tolist()
              for i, r in enumerate(reqs) if r.rid in outs}
    failed = {i: r.error for i, r in enumerate(reqs) if r.rid in eng.failed}
    return served, failed, eng.stats(), eng.paging_stats()


def _model_view(tracer, reqs):
    """Everything on the modelled clock, with request ids replaced by
    submission indices (both packages draw rids from process counters)."""
    index = {r.rid: i for i, r in enumerate(reqs)}

    def args(a):
        return {k: index.get(v, v) if k == "rid" else v
                for k, v in a.items()}

    return {"timelines": tracer.timelines, "busy": tracer._busy,
            "model_us": tracer.model_us,
            "duplex_util": tracer.duplex_util(),
            "instants": [(c, tr, n, ts if c == "model" else None, args(a))
                         for c, tr, n, ts, a in tracer.instants]}


@pytest.fixture(scope="module")
def runs(models):
    out = {}
    for scenario in SCENARIOS:
        out[scenario] = {
            "jax": _serve(models["jax"], scenario, True),
            "torch": _serve(models["torch"], scenario, True),
            "untraced": _serve(models["torch"], scenario, None)}
    return out


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_traced_engine_equals_untraced(runs, scenario):
    traced, plain = runs[scenario]["torch"], runs[scenario]["untraced"]
    assert _outcome(*traced) == _outcome(*plain)
    assert traced[0].pool.tier_stats() == plain[0].pool.tier_stats()
    assert plain[0].tracer is None
    assert traced[0].tracer.spans


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_trace_equals_reference(runs, scenario):
    (je, jr, jo), (te, tr, to) = runs[scenario]["jax"], \
        runs[scenario]["torch"]
    assert _outcome(te, tr, to)[:2] == _outcome(je, jr, jo)[:2]
    assert te.paging_stats() == je.paging_stats()
    jt, tt = je.tracer, te.tracer
    assert _model_view(tt, tr) == _model_view(jt, jr)
    assert Counter(s[0] for s in tt.spans) == \
        Counter(s[0] for s in jt.spans)
    assert {k: len(v) for k, v in tt.counters.items()} == \
        {k: len(v) for k, v in jt.counters.items()}
    ts, js = tt.summary(), jt.summary()
    assert ts["phase_us"]["spans"] == js["phase_us"]["spans"]
    assert set(ts["phase_us"]) == set(js["phase_us"])
    for key in ("duplex_util", "model_us", "events", "instants"):
        assert ts[key] == js[key], key
    kinds = {n for _, track, n, _, _ in tt.instants if track == "faults"}
    if scenario == "faults":
        assert {"offline", "poison", "transient", "evacuation",
                "request_failed"} <= kinds
    if scenario == "tiered":
        assert any(n == "tier_migrate" for _, _, n, _, _ in tt.instants)
        assert any(iv[2] == "migrate" for ivals in tt.timelines.values()
                   for iv in ivals)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_channel_tracks_are_monotonic(runs, scenario):
    tt = runs[scenario]["torch"][0].tracer
    assert any(tt.timelines.values())
    for track, ivals in tt.timelines.items():
        end = -1.0
        for t0, dur, _, _ in ivals:
            assert t0 >= end - 1e-6, track
            end = t0 + dur
        assert end <= tt.model_us + 1e-6


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_metrics_equal_reference(runs, scenario):
    jm = runs[scenario]["jax"][0].metrics()
    tm = runs[scenario]["torch"][0].metrics()
    assert set(tm) == set(jm)
    for key in ("counters", "gauges", "cax"):
        assert tm[key] == jm[key], key
    assert {k: v["count"] for k, v in tm["histograms"].items()} == \
        {k: v["count"] for k, v in jm["histograms"].items()}
    assert tm["trace"]["duplex_util"] == jm["trace"]["duplex_util"]
    plain = runs[scenario]["untraced"][0].metrics()
    assert "trace" not in plain and plain["counters"] == tm["counters"]


def test_export_round_trips(runs, tmp_path):
    eng = runs["faults"]["torch"][0]
    with pytest.raises(ValueError, match="tracing is disabled"):
        runs["faults"]["untraced"][0].export_trace()
    with pytest.raises(ValueError, match="no trace path"):
        eng.export_trace()
    path = eng.export_trace(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert doc == json.loads(json.dumps(eng.tracer.to_perfetto()))
    evs = doc["traceEvents"]
    tr = eng.tracer
    assert sum(e["ph"] == "X" for e in evs) == len(tr.spans) + sum(
        len(v) for v in tr.timelines.values())
    assert sum(e["ph"] == "i" for e in evs) == len(tr.instants)
    assert doc["otherData"]["modelled_horizon_us"] == round(tr.model_us, 3)
    want = runs["faults"]["jax"][0].tracer.to_perfetto()
    assert [(e["ph"], e["name"], e["pid"]) for e in evs] == \
        [(e["ph"], e["name"], e["pid"]) for e in want["traceEvents"]]


def test_engine_takes_a_tracer_or_a_path(models, tmp_path):
    side = models["torch"]
    mine = Tracer()
    eng, _, _ = _serve(side, "flat", mine)
    assert eng.tracer is mine and mine.spans
    path = str(tmp_path / "t.json")
    eng, _, _ = _serve(side, "flat", path)
    assert eng.export_trace() == path and json.load(open(path))


# -- the tracer, the registry and the scope tree alone -------------------------

def _drive_tracer(tr):
    tr.channel_transaction([("cxl:0", 4096.0, 8192.0, 0.1, 0.2, 0.25, True),
                            ("ddr5:1", 4096.0, 0.0, 0.3, 0.0, 0.3, False)],
                           0.3, name="paging")
    tr.instant("faults", "poison", {"block": 3})
    tr.channel_transaction([("ddr5:1", 0.0, 4096.0, 0.0, 0.4, 0.4, False)],
                           0.4, name="evacuate")
    tr.counter("in_flight", 2)
    tr.span("plan", tr.now_us(), step=0)
    tr.instant("engine", "divergence_rollback", {"step": 1}, clock="host")
    return tr


def test_tracer_equals_reference():
    j, t = _drive_tracer(jtrace.Tracer()), _drive_tracer(Tracer())
    assert t.timelines == j.timelines and t._busy == j._busy
    assert t.duplex_util() == j.duplex_util()
    assert t.summary()["model_us"] == j.summary()["model_us"]
    assert [i[:3] for i in t.instants] == [i[:3] for i in j.instants]
    assert t.metrics.snapshot()["counters"] == \
        j.metrics.snapshot()["counters"]
    assert tuple(jtrace.PHASES) == tuple(__import__(
        "repro_torch.serve.trace", fromlist=["PHASES"]).PHASES)


def _fill_registry(mod):
    reg = mod.MetricsRegistry()
    reg.ingest("engine", {"steps": 7, "duplex_us": 1.25, "paged": True,
                          "name": "x", "tiers": {"migrations": 2,
                                                 "tier_us": 3.5}})
    for v in (0.0, 0.5, 1.0, 3.0, 1e12):
        reg.observe("span.plan.us", v)
    reg.inc("instant.faults.poison")
    reg.inc("instant.faults.poison", 2.5)
    reg.set("g", 1 / 3)
    return reg


def test_metrics_registry_equals_reference():
    j, t = _fill_registry(jmetrics), _fill_registry(tmetrics)
    assert t.snapshot() == j.snapshot()
    assert tmetrics.Histogram().snapshot() == jmetrics.Histogram().snapshot()
    with pytest.raises(TypeError, match="is a Counter"):
        t.gauge("engine.steps")
    with pytest.raises(ValueError, match="counters only go up"):
        t.inc("c", -1.0)
    t.reset()
    assert t.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def _fill_cax(reg):
    reg.attribute("/serve/kv_cache/page_in", read_bytes=3e9)
    reg.attribute("/serve/redis/gaussian", write_bytes=1e9, flops=2e9)
    reg.context("/serve/vector", ctx_type="module")
    return reg


def test_cax_registry_equals_reference():
    j = _fill_cax(jtelemetry.CaxRegistry())
    t = _fill_cax(ttelemetry.CaxRegistry())
    assert t.paths() == j.paths()
    assert t.report() == j.report()
    assert t.report("/serve", min_bytes=1.5e9) == \
        j.report("/serve", min_bytes=1.5e9)
    assert t.to_json() == j.to_json()
    assert [c.path for c in t.children("/serve")] == \
        [c.path for c in j.children("/serve")]
    assert list(t.children("/nowhere")) == []
    assert t.get("/serve").read_bytes == 3e9 and t.get("/x") is None
    reg = ttelemetry.reset_global_registry()
    assert ttelemetry.global_registry() is reg and reg.paths() == ["/"]
