"""The program's own stamps on its requests, over a window.

A traced engine (``EngineConfig(trace=...)``) writes on each request it
is given, as ``Request.trace``, when ``submit()`` took it and when its
admission queue admitted it, both on the engine tracer's host clock, and
how many requests behind it in FIFO order the queue admitted while it
waited. A program that stamps nothing (an untraced engine, or one from
before the stamps) gives no stamps, and its readers nothing.
"""

from __future__ import annotations


def admitted(window) -> list[dict]:
    """The stamps of the requests submitted in the window and admitted by
    its end: the requests that ``timeline.queue_waits`` takes, by the
    harness's own boundary records."""
    out = []
    for r in window.recs:
        stamp = getattr(r.req, "trace", None)
        if (stamp is not None and stamp.get("admit_us") is not None
                and r.submit >= 0.0 and r.admit is not None
                and r.admit <= window.t_end):
            out.append(stamp)
    return out
