"""The engine's nested phases, request stamps and useful-row counter
(``repro_torch.serve.trace``, ``serve/engine.py``, ``serve/queue.py``).

A traced engine records each phase of ``NESTED_PHASES`` inside the
boundary span it names as its parent, stamps every submitted request's
submission and admission on the tracer's host clock and counts the
requests that overtook it, and serves exactly as an untraced one, whose
requests carry no stamps. ``row_advances`` counts the row-micro-steps
that moved a request: its prompt tokens and the tokens fed back. Under a
torch profiler each span and phase is one ``engine/<name>`` range, on
the profiler's clock and nested as the phases are; with no profiler
recording no range is opened.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import policies as policies_lib  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import (EngineConfig, ServeEngine,  # noqa: E402
                               Tracer)
from repro_torch.serve import trace as trace_lib  # noqa: E402
from repro_torch.serve.queue import Request, RequestQueue  # noqa: E402

ARCH = "smollm-135m"
#: more requests than slots, of unequal prompts, arriving two a step: a
#: queue forms, prefill and decode rows share steps, the pool pages
PROMPTS = [np.random.default_rng(7).integers(0, 256, n).astype(np.int32)
           for n in (5, 2, 8, 3, 7, 4, 6)]
BASE = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
            prefill_chunk=3, max_queue=16, megastep=4, device="cpu")


@pytest.fixture(scope="module")
def model():
    api = registry.build(ARCH, smoke=True, device="cpu")
    return api, api.init(torch.Generator().manual_seed(0))


def _engine(model, trace, depth):
    api, params = model
    eng = ServeEngine(api, params, EngineConfig(
        **BASE, pipeline_depth=depth, trace=trace))
    reqs = [eng.submit(p, 4 + i % 3, arrival_step=i // 2)
            for i, p in enumerate(PROMPTS)]
    return eng, reqs


def _serve(model, trace, depth):
    eng, reqs = _engine(model, trace, depth)
    outs = eng.run(max_steps=400)
    return eng, reqs, outs


@pytest.fixture(scope="module")
def runs(model):
    return {(depth, traced): _serve(model, True if traced else None, depth)
            for depth in (1, 2) for traced in (False, True)}


def _inside(inner, outer):
    """(t0, dur) ``inner`` lies within ``outer`` on the host clock."""
    eps = 1e-6
    return (outer[0] - eps <= inner[0]
            and inner[0] + inner[1] <= outer[0] + outer[1] + eps)


@pytest.mark.parametrize("depth", [1, 2])
def test_phases_nest_in_their_spans(runs, depth):
    eng, _, _ = runs[(depth, True)]
    tr = eng.tracer
    assert tr.phases and not tr._open
    children = {i: [] for i in range(len(tr.spans))}
    for name, t0, dur, parent in tr.phases:
        assert name in trace_lib.NESTED_PHASES
        assert parent == name.split(".")[0] and dur >= 0.0
        hosts = [i for i, s in enumerate(tr.spans)
                 if s[0] == parent and _inside((t0, dur), s[1:3])]
        assert len(hosts) == 1, name
        children[hosts[0]].append((name, t0, dur))
    for i, (span, t0, dur, args) in enumerate(tr.spans):
        kids = children[i]
        # a span's self time: its duration less its phases'
        assert dur - sum(d for _, _, d in kids) >= -1e-6
        # the phases run in order, one after the other, in their span
        assert [k[1] for k in kids] == sorted(k[1] for k in kids)
        names = [k[0] for k in kids]
        if span == "plan":
            assert names == ["plan.admit", "plan.trajectory"]
        elif span == "dispatch":
            replay = ["dispatch.replay"] if args["live"] else []
            assert names == replay + ["dispatch.page", "dispatch.retire",
                                      "dispatch.policy"]
        else:
            assert names in (["reconcile.wait", "reconcile.sync"],
                             ["reconcile.sync"])
    # every megastep that ran rows waits on its readback once
    n = Counter(p[0] for p in tr.phases)
    assert n["reconcile.wait"] == n["dispatch.replay"] == \
        eng.host_dispatches
    assert n["plan.admit"] == sum(s[0] == "plan" for s in tr.spans)


@pytest.mark.parametrize("depth", [1, 2])
def test_untraced_engine_serves_the_same_without_stamps(runs, depth):
    (te, treqs, touts), (pe, preqs, pouts) = runs[(depth, True)], \
        runs[(depth, False)]
    assert pe.tracer is None and pe.queue.tracer is None
    assert all(r.trace is None for r in preqs)
    served = [[touts[r.rid].tolist() for r in treqs],
              [pouts[r.rid].tolist() for r in preqs]]
    assert served[0] == served[1]
    assert te.stats() == pe.stats()
    assert te.paging_stats() == pe.paging_stats()
    assert (te.decode_steps, te.row_advances) == \
        (pe.decode_steps, pe.row_advances)
    for r in treqs:
        tr = r.trace
        assert tr["rid"] == r.rid and tr["overtaken"] >= 0
        assert 0.0 <= tr["submit_us"] <= tr["admit_us"]


@pytest.mark.parametrize("depth", [1, 2])
def test_row_advances_count_prompt_and_fed_tokens(runs, depth):
    eng, reqs, outs = runs[(depth, False)]
    # every prompt token is consumed once, and every generated token but
    # the last is fed back once
    want = sum(r.prompt_len + len(outs[r.rid]) - 1 for r in reqs)
    assert eng.row_advances == want
    # a decoding row idles through its step's other micro-steps
    assert want < eng.decode_steps * BASE["max_batch"]


def _stub(weights):
    """A policy that gives each waiting-room slot a fixed weight."""
    w = torch.tensor(weights, dtype=torch.float32)
    return policies_lib.Policy(
        "stub", lambda params, n, device="cpu": (),
        lambda params, state, obs: (state, w),
        lambda params, state, fb: state)


def _queue(weights, traced=True, tenants=("llm", "llm", "llm")):
    q = RequestQueue(capacity=len(weights), policy=_stub(weights))
    q.tracer = Tracer() if traced else None
    reqs = []
    for tenant in tenants:
        r = Request(prompt=np.arange(1, 4), max_new_tokens=2, tenant=tenant)
        if traced:
            r.trace = {"rid": r.rid, "submit_us": q.tracer.now_us(),
                       "admit_us": None, "overtaken": 0}
        reqs.append(q.submit(r))
    return q, reqs


def test_equal_weights_admit_in_submit_order_and_overtake_nobody():
    q, (a, b, c) = _queue([1.0, 1.0, 1.0])
    assert q.dispatch(0, 1) == [a]
    assert a.trace["admit_us"] is not None
    assert b.trace["admit_us"] is None and c.trace["admit_us"] is None
    assert q.dispatch(1, 1) == [b]
    assert [r.trace["overtaken"] for r in (a, b, c)] == [0, 0, 0]
    assert a.trace["admit_us"] <= b.trace["admit_us"]


def test_a_later_request_ranked_first_overtakes_the_earlier_ones():
    q, (a, b, c) = _queue([0.2, 0.5, 1.0])
    assert q.dispatch(0, 1) == [c]
    assert [r.trace["overtaken"] for r in (a, b, c)] == [1, 1, 0]
    # b before a: b overtakes a once more; b has no one behind it
    assert q.dispatch(1, 1) == [b]
    assert [r.trace["overtaken"] for r in (a, b)] == [2, 1]


def test_an_admission_on_another_tenants_budget_overtakes_nobody():
    q, (a, b, c) = _queue([0.2, 0.5, 1.0], tenants=("llm", "llm", "kv"))
    assert q.dispatch(0, {"llm": 0, "kv": 1}) == [c]
    assert [r.trace["overtaken"] for r in (a, b)] == [0, 0]
    assert q.dispatch(1, {"llm": 1, "kv": 1}) == [b]
    assert a.trace["overtaken"] == 1


def test_an_untraced_queue_stamps_nothing():
    q, (a, b, c) = _queue([0.2, 0.5, 1.0], traced=False)
    assert q.dispatch(0, 2) == [c, b]
    assert all(r.trace is None for r in (a, b, c))


def _profiled(model, megasteps=4):
    """A traced engine's next ``megasteps`` boundaries under a CPU torch
    profiler: the engine, the spans and phases recorded in them, and the
    profiler's ``engine/`` ranges as (name, start ns, end ns)."""
    eng, _ = _engine(model, True, 2)
    for _ in range(2):
        eng.megastep()
    tr = eng.tracer
    n_spans, n_phases = len(tr.spans), len(tr.phases)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(megasteps):
            eng.megastep()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace_lib.RANGE_PREFIX)]
    return eng, tr.spans[n_spans:], tr.phases[n_phases:], ranges


def test_profiler_sees_each_span_and_phase_once(model):
    eng, spans, phases, ranges = _profiled(model)
    want = Counter(trace_lib.RANGE_PREFIX + s[0] for s in spans) \
        + Counter(trace_lib.RANGE_PREFIX + p[0] for p in phases)
    assert {"engine/plan.admit", "engine/dispatch.page",
            "engine/reconcile.wait"} <= set(want)
    assert Counter(r[0] for r in ranges) == want
    # on the profiler's clock each phase's range lies in a range of its
    # parent
    by_name = {}
    for name, s, e in ranges:
        by_name.setdefault(name, []).append((s, e))
    for name, s, e in ranges:
        parent = name[len(trace_lib.RANGE_PREFIX):].split(".")
        if len(parent) == 2:
            outer = by_name[trace_lib.RANGE_PREFIX + parent[0]]
            assert any(a <= s and e <= b for a, b in outer), name


def test_no_range_opens_without_a_profiler(model, monkeypatch):
    opened = []
    real = trace_lib._RecordFunctionFast

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(trace_lib, "_RecordFunctionFast", counting)
    eng, _ = _engine(model, True, 2)
    for _ in range(3):
        eng.megastep()
    assert eng.tracer.phases and opened == []
    # the counter counts: under a profiler every span and phase opens one
    _, spans, phases, _ = _profiled(model, megasteps=2)
    assert len(opened) == len(spans) + len(phases) > 0


def test_tracer_phases_name_their_parents_and_unwind():
    tr = Tracer()
    with tr.phase("alone"):
        pass
    t0 = tr.begin("plan")
    with tr.phase("plan.admit"):
        with tr.phase("inner"):
            pass
    with pytest.raises(KeyError):
        with tr.phase("plan.trajectory"):
            raise KeyError("a raising phase is recorded and closed")
    tr.span("plan", t0)
    assert [(p[0], p[3]) for p in tr.phases] == [
        ("alone", None), ("inner", "plan.admit"), ("plan.admit", "plan"),
        ("plan.trajectory", "plan")]
    # closing a span closes what was left open inside it
    t1 = tr.begin("reconcile")
    tr.begin("reconcile.sync")
    tr.span("reconcile", t1)
    assert tr._open == [] and [s[0] for s in tr.spans] == ["plan",
                                                           "reconcile"]
    # a span never begun closes nothing else
    t2 = tr.begin("dispatch")
    tr.span("restore", tr.now_us())
    assert [o[0] for o in tr._open] == ["dispatch"]
    tr.span("dispatch", t2)
    assert tr.summary()["phase_us"]["spans"] == {
        "plan": 1, "reconcile": 1, "restore": 1, "dispatch": 1}


def test_a_diverged_readback_closes_its_span_unrecorded(model):
    eng, _ = _engine(model, True, 1)
    rec = eng._dispatch(eng._plan())
    assert rec.live
    rec.packed._host[:, 2] += 1     # n_gen off by one in every row
    with pytest.raises(RuntimeError, match="diverged"):
        eng._reconcile(rec)
    tr = eng.tracer
    assert tr._open == []
    assert [s[0] for s in tr.spans] == ["plan", "dispatch"]
    assert [p[0] for p in tr.phases][-2:] == ["reconcile.wait",
                                              "reconcile.sync"]
    assert tr.phases[-1][3] == "reconcile"
    assert tr.instants[-1][2] == "divergence_rollback"
