"""The closed loop on the program's public serving entry.

Requests go in through ``ServeEngine.submit`` and the engine advances by
``ServeEngine.megastep``, which plans a boundary, dispatches K engine
steps and blocks until their readback is reconciled. After each boundary
the harness reads the public request mirrors (``Request.state``,
``.consumed``, ``.generated``) and records, on the host clock, which
requests left the queue, got their first token or completed; a client
whose request completed sends its next one at once.
"""

from __future__ import annotations

import contextlib
import time

from portbench import timeline
from portbench.devtrace import RANGE_PREFIX


class Driver:
    """A closed loop of ``plan.clients`` clients on ``engine``.

    ``flops(a, b)`` gives the model FLOPs of one sequence's passes at
    positions a .. b-1 (the family's count). Times are seconds from
    ``start()``, and from ``open_window()`` once it is called, by
    ``clock``."""

    def __init__(self, engine, plan, flops, clock=time.perf_counter):
        from repro_torch.serve.queue import DONE, FAILED, WAITING

        self._done, self._failed, self._waiting = DONE, FAILED, WAITING
        self.engine = engine
        self.plan = plan
        self.flops_of = flops
        self.clock = clock
        self.recs: list[timeline.Rec] = []
        self.live: dict[int, timeline.Rec] = {}
        self._next = [0] * plan.clients
        self._passes: dict[int, int] = {}
        self.t0 = None
        self.tokens = 0           # tokens read back
        self.flops = 0.0          # model FLOPs of the passes run
        self.failed = 0
        self.ranges = False       # wrap calls in profiler ranges
        self.marks: list[int] = []  # perf_counter_ns at each megastep
        self.history: list[tuple[float, int]] = []  # (t, tokens) a boundary

    def now(self) -> float:
        return self.clock() - self.t0

    @contextlib.contextmanager
    def _range(self, name: str):
        if not self.ranges:
            yield
            return
        import torch
        with torch.profiler.record_function(RANGE_PREFIX + name):
            yield

    def _submit(self, client: int, t: float) -> None:
        k = self._next[client]
        self._next[client] = k + 1
        prompt, n = self.plan.request(client, k)
        with self._range("submit"):
            req = self.engine.submit(prompt, n)
        rec = timeline.Rec(client, len(prompt), n, submit=t, req=req)
        self.recs.append(rec)
        self.live[id(rec)] = rec
        self._passes[id(rec)] = 0

    def start(self) -> None:
        """Every client sends its first request; the clock starts."""
        self.t0 = self.clock()
        for c in range(self.plan.clients):
            self._submit(c, 0.0)

    def open_window(self) -> None:
        """The window opens now, after the ramp: times become seconds from
        here (what the ramp recorded turns negative), and the tokens and
        FLOPs counted start again from 0. The requests in flight stay."""
        shift = self.now()
        self.t0 += shift
        for rec in self.recs:
            for f in ("submit", "admit", "first", "done"):
                v = getattr(rec, f)
                if v is not None:
                    setattr(rec, f, v - shift)
        self.tokens = 0
        self.flops = 0.0
        self.history = []

    def boundary(self) -> float:
        """One megastep boundary, then the scan. Returns its end time."""
        if self.ranges:
            self.marks.append(time.perf_counter_ns())
        with self._range("megastep"):
            self.engine.megastep()
        t = self.now()
        with self._range("scan"):
            self._scan(t)
        self.history.append((t, self.tokens))
        return t

    def _scan(self, t: float) -> None:
        finished = []
        for key, rec in list(self.live.items()):
            r = rec.req
            if rec.admit is None and r.state != self._waiting:
                rec.admit = t
            n = len(r.generated)
            if n > rec.tokens:
                self.tokens += n - rec.tokens
                rec.tokens = n
                if rec.first is None:
                    rec.first = t
            p = timeline.passes(rec.prompt_len, r.consumed, n)
            if p > self._passes[key]:
                self.flops += self.flops_of(self._passes[key], p)
                self._passes[key] = p
            if r.state in (self._done, self._failed):
                if r.state == self._failed:
                    rec.failed = True
                    self.failed += 1
                else:
                    rec.done = t
                del self.live[key]
                finished.append(rec.client)
        for c in finished:
            self._submit(c, t)
