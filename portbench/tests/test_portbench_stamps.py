"""The readers of the program's request stamps (``portbench/stamps.py``,
``metrics/queue_wait_p95_ms.py``, ``metrics/admission_overtakes_p95.py``):
their arithmetic on a synthetic window, nothing to read from a program
that stamps nothing, and both metrics in the traced CPU rehearsal."""

from __future__ import annotations

import types

import pytest

from portbench import spec, stamps, timeline
from portbench.tests.test_portbench_rehearsal import run, smoke_cell

NEW = ("queue_wait_p95_ms", "admission_overtakes_p95")


def _rec(submit, admit, wait_ms, overtaken, stamped=True):
    """A request of the window as the harness records it, carrying the
    program's stamps (``wait_ms`` in the queue) where ``stamped``."""
    trace = None
    if stamped:
        t0 = 5e6 + submit * 1e6
        trace = {"rid": 0, "submit_us": t0,
                 "admit_us": None if wait_ms is None else t0 + wait_ms * 1e3,
                 "overtaken": overtaken}
    return timeline.Rec(0, 8, 8, submit=submit, admit=admit,
                        req=types.SimpleNamespace(trace=trace))


def _ctx(recs, t_end=10.0):
    return types.SimpleNamespace(window=types.SimpleNamespace(
        recs=recs, t_end=t_end, seconds=t_end, steps=100), tail=None)


def _window():
    recs = [_rec(0.5 * i, 0.5 * i + 1.0, 10.0 * (i + 1), i % 4)
            for i in range(19)]
    # the ramp's requests, one admitted after the window, one waiting
    recs += [_rec(-2.0, 0.5, 99_000.0, 50), _rec(9.0, 10.5, 88_000.0, 40),
             _rec(9.5, None, None, 30)]
    return recs


def test_readers_take_the_windows_admitted_requests():
    read = {n: spec.metric_reader(n) for n in NEW}
    ctx = _ctx(_window())
    assert len(stamps.admitted(ctx.window)) == 19
    # waits 10, 20, ..., 190 ms: the nearest rank of 95 % of 19 is the
    # 19th
    assert read["queue_wait_p95_ms"](ctx) == pytest.approx(190.0)
    # overtaken 0, 1, 2, 3, 0, ...: the 19th of the sorted 19 is 3
    assert read["admission_overtakes_p95"](ctx) == 3.0
    one = _ctx([_rec(1.0, 2.0, 25.0, 2)])
    assert read["queue_wait_p95_ms"](one) == pytest.approx(25.0)
    assert read["admission_overtakes_p95"](one) == 2.0


def test_a_program_that_stamps_nothing_gives_nothing():
    read = {n: spec.metric_reader(n) for n in NEW}
    unstamped = [_rec(0.5, 1.0, 10.0, 0, stamped=False)]
    plain = [timeline.Rec(0, 8, 8, submit=0.5, admit=1.0,
                          req=types.SimpleNamespace())]
    for recs in ([], unstamped, plain,
                 [timeline.Rec(0, 8, 8, submit=0.5, admit=1.0)]):
        for name in NEW:
            assert read[name](_ctx(recs)) is None


def test_traced_rehearsal_reports_the_stamps():
    out = run(smoke_cell("smollm-135m"), trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(NEW) <= set(got)
    assert got["queue_wait_p95_ms"]["value"] >= 0.0
    assert got["queue_wait_p95_ms"]["unit"] == "ms"
    assert got["admission_overtakes_p95"]["value"] >= 0.0
