"""Duplex-aware tracing plane: boundary spans, nested phases, channel
timelines, Perfetto.

Port of ``repro/serve/trace.py``: plain Python, no device work. On a CUDA
device the engine's ``dispatch`` span covers the enqueue of its step
graphs' replays, not their execution on the card; no hook reads a device
tensor, and a traced engine replays the same graphs as an untraced one.
The ``snapshot_cut`` / ``restore`` spans cover a cut's drain, flush and
write, and a restore's load and journal scan. A sharded engine
(``serve/shard.py``) emits its collectives on ``ici:model`` and
``ici:data`` tracks and its pool shards' channels as ``shard<s>/...``
tracks, on the same modelled clock.

The serving stack's observability layer (README "Observability"). One
``Tracer`` per engine, ``None`` when disabled — every hot-path hook in
the engine/pool/tiers/faults sits behind an ``is not None`` check, so a
disabled engine serves bit-identically to one built before this layer
existed (tokens, billing, AND the one-readback-per-megastep sync
budget: no hook touches a device array).

Two clocks, deliberately:

  * **host clock** (``now_us``) — ``time.perf_counter_ns`` relative to
    the tracer's epoch. Boundary spans (``plan``/``dispatch``/
    ``reconcile``), snapshot cuts, and restore live here: they measure
    where the *host* spends its time between dispatches — the pipeline
    bubbles ``host_blocked`` only counts. Inside them the engine opens
    the nested phases of ``NESTED_PHASES`` (``Tracer.phases``, each with
    the span or phase it opened in as its parent), and stamps each
    request's submission and admission (``Request.trace``). The host
    clock is shared with the device trace through ranges: while a torch
    profiler records, every boundary span and phase is also a profiler
    range ``engine/<name>`` (a CPU op, no device annotation and no
    sync), so any profiler trace shows the engine's phases on the
    kernels' own clock, with no offset to estimate.
  * **modelled clock** (``model_us``) — the cumulative billed
    transaction time of the memory hierarchy. Channel busy intervals
    (DDR5/CXL/ICI, per direction) and fault instants live here: each
    pool transaction advances the clock by its modelled duplex time
    (channels run in parallel within it), so per-track intervals are
    monotonic and non-overlapping by construction, and the idle minor
    direction of a duplex link shows up as literal white space.

``export()`` writes Chrome/Perfetto ``trace.json`` (open at
https://ui.perfetto.dev): pid 1 = the engine's host-clock spans, pid 2
= the modelled memory hierarchy, one thread per phase / per channel
direction, fault instants riding the channel tracks. The nested phases
stay out of it (the reference's export), and are read from
``Tracer.phases`` or a profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from repro_torch.core.metrics import MetricsRegistry

#: span names the engine emits — the span taxonomy (README).
PHASES = ("plan", "dispatch", "reconcile", "snapshot_cut", "restore")
#: phases the engine opens inside its boundary spans, each named after
#: its parent span: admission (``queue.dispatch`` and the slot installs),
#: the rows' trajectories; the graph replays and the readback's enqueue,
#: the paging transactions with the block frees between them, retirement
#: (tier migration, shedding, the planning view), the policy fold; the
#: blocking wait on the readback, and the host mirrors' sync.
NESTED_PHASES = ("plan.admit", "plan.trajectory",
                 "dispatch.replay", "dispatch.page", "dispatch.retire",
                 "dispatch.policy",
                 "reconcile.wait", "reconcile.sync")
#: prefix of the profiler ranges of the spans and phases
RANGE_PREFIX = "engine/"

_HOST_PID = 1       # host-clock process (boundary spans)
_MODEL_PID = 2      # modelled-clock process (channels + faults)
_NO_PHASE = contextlib.nullcontext()


def maybe_phase(tracer: "Tracer | None", name: str):
    """``tracer.phase(name)``, or one shared no-op context where tracing
    is off (``tracer`` None): no clock read, no allocation."""
    return _NO_PHASE if tracer is None else tracer.phase(name)


class Tracer:
    """Collects spans, channel timelines, instants and counters.

    All mutators are cheap host-side appends — never a device op. The
    modelled clock is shared by every channel sink attached to this
    tracer (pool shards, tiered channels, the ICI meter), so one
    serving run yields one coherent modelled-time axis.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._epoch = time.perf_counter_ns()
        # host-clock spans: (name, t0_us, dur_us, args)
        self.spans: list[tuple[str, float, float, dict]] = []
        # host-clock nested phases: (name, t0_us, dur_us, parent)
        self.phases: list[tuple[str, float, float, str | None]] = []
        # the spans and phases open now, outermost first: (name, the
        # profiler range opened with it or None)
        self._open: list[tuple[str, object]] = []
        # modelled-clock busy intervals per track:
        # track -> [(t0_us, dur_us, name, args), ...]
        self.timelines: dict[str, list] = {}
        # instants: (clock, track, name, ts_us, args)
        self.instants: list[tuple[str, str, str, float, dict]] = []
        # host-clock counter series: name -> [(ts_us, value), ...]
        self.counters: dict[str, list] = {}
        self.model_us = 0.0
        # per-track modelled busy totals (combined, read, write)
        self._busy: dict[str, dict] = {}
        self.metrics = MetricsRegistry()

    # -- clocks --------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch) / 1e3

    # -- host-clock spans ----------------------------------------------------
    def begin(self, name: str) -> float:
        """Open the boundary span or phase ``name`` now: what opens before
        it closes names it as its parent, and while a torch profiler
        records it is also the range ``engine/<name>``. Returns its start
        on the host clock, for ``span``."""
        rng = None
        if _autograd_profiler._is_profiler_enabled:
            rng = _RecordFunctionFast(RANGE_PREFIX + name)
            rng.__enter__()
        self._open.append((name, rng))
        return self.now_us()

    def end(self, name: str) -> None:
        """Close the innermost open ``name`` and whatever opened inside it
        is still open (a span whose code raised). No-op where ``name`` is
        not open (a span that was not begun)."""
        for i in range(len(self._open) - 1, -1, -1):
            if self._open[i][0] == name:
                for _, rng in reversed(self._open[i:]):
                    if rng is not None:
                        rng.__exit__(None, None, None)
                del self._open[i:]
                return

    def span(self, name: str, t0_us: float, **args) -> None:
        """Close a boundary span opened at ``t0_us`` (host clock)."""
        dur = max(0.0, self.now_us() - t0_us)
        self.spans.append((name, t0_us, dur, args))
        self.metrics.observe(f"span.{name}.us", dur)
        self.end(name)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Record the block as the phase ``name`` of ``phases``, with the
        innermost open span or phase as its parent (None outside any)."""
        parent = self._open[-1][0] if self._open else None
        t0 = self.begin(name)
        try:
            yield
        finally:
            self.phases.append((name, t0, max(0.0, self.now_us() - t0),
                                parent))
            self.end(name)

    def counter(self, name: str, value: float) -> None:
        """One sample of a host-clock counter series (Perfetto "C")."""
        self.counters.setdefault(name, []).append((self.now_us(),
                                                   float(value)))

    # -- instants ------------------------------------------------------------
    def instant(self, track: str, name: str, args: dict | None = None,
                clock: str = "model") -> None:
        """A zero-duration event: fault arrivals, divergences,
        rollbacks. ``clock="model"`` pins it to the modelled axis (the
        channel tracks); ``clock="host"`` to the span axis."""
        ts = self.model_us if clock == "model" else self.now_us()
        self.instants.append((clock, track, name, ts, args or {}))
        self.metrics.inc(f"instant.{track}.{name}")

    # -- modelled-clock channel timelines ------------------------------------
    def channel_transaction(self, entries, advance_us: float,
                            name: str = "txn") -> None:
        """Record one billed transaction's per-channel busy intervals.

        ``entries``: ``(track, read_bytes, write_bytes, read_us,
        write_us, busy_us, co_issued)`` per busy channel. Channels run
        in parallel within the transaction, so every entry starts at
        the current modelled time; the clock then advances by
        ``advance_us`` (the transaction's modelled duplex time — the
        max over its channels), keeping per-track intervals disjoint.
        Each direction gets its own track (``<chan>.rd`` /
        ``<chan>.wr``): co-issued directions overlap in time (the
        duplex win, visible as parallel bars), serial/withdrawn traffic
        lays read-then-write end to end — the idle minor direction is
        the white space between them.
        """
        t0 = self.model_us
        for track, rb, wb, rd_us, wr_us, busy_us, co in entries:
            tot = self._busy.setdefault(
                track, {"busy_us": 0.0, "read_us": 0.0, "write_us": 0.0,
                        "read_bytes": 0.0, "write_bytes": 0.0, "txns": 0})
            tot["busy_us"] += busy_us
            tot["read_us"] += rd_us
            tot["write_us"] += wr_us
            tot["read_bytes"] += rb
            tot["write_bytes"] += wb
            tot["txns"] += 1
            if rd_us > 0.0:
                self.timelines.setdefault(f"{track}.rd", []).append(
                    (t0, min(rd_us, busy_us), name,
                     {"bytes": rb, "co_issued": co}))
            if wr_us > 0.0:
                w0 = t0 if co else t0 + rd_us
                self.timelines.setdefault(f"{track}.wr", []).append(
                    (w0, min(wr_us, busy_us), name,
                     {"bytes": wb, "co_issued": co}))
        self.model_us += max(0.0, advance_us)

    # -- summaries (the BENCH / metrics feed) --------------------------------
    def phase_totals(self) -> dict:
        """Host-clock time per span name: ``{"plan_us": ...,
        "dispatch_us": ..., "reconcile_us": ..., ...}`` plus counts."""
        out: dict[str, float] = {}
        counts: dict[str, int] = {}
        for name, _, dur, _ in self.spans:
            out[f"{name}_us"] = out.get(f"{name}_us", 0.0) + dur
            counts[name] = counts.get(name, 0) + 1
        return {**{k: round(v, 1) for k, v in out.items()},
                "spans": counts}

    def duplex_util(self) -> dict:
        """Per-channel busy fraction of the modelled transaction clock:
        ``{channel: {"util": busy/model, "rd_util": ..., "wr_util": ...,
        "busy_us": ...}}``. The minor-direction utilization gap on a
        duplex link is the capacity boundary migrations ride."""
        horizon = max(self.model_us, 1e-9)
        idle = {"busy_us": 0.0, "read_us": 0.0, "write_us": 0.0,
                "read_bytes": 0.0, "write_bytes": 0.0, "txns": 0}
        chans = set(self._busy)
        chans.update(t.rsplit(".", 1)[0] for t in self.timelines
                     if t.endswith((".rd", ".wr")))
        busy = {c: self._busy.get(c, idle) for c in chans}
        return {
            track: {"util": round(t["busy_us"] / horizon, 4),
                    "rd_util": round(t["read_us"] / horizon, 4),
                    "wr_util": round(t["write_us"] / horizon, 4),
                    "busy_us": round(t["busy_us"], 3),
                    "read_bytes": t["read_bytes"],
                    "write_bytes": t["write_bytes"],
                    "txns": t["txns"]}
            for track, t in sorted(busy.items())}

    def summary(self) -> dict:
        """The trace plane's stats block: phase totals, duplex
        utilization, modelled horizon, event counts."""
        return {"phase_us": self.phase_totals(),
                "duplex_util": self.duplex_util(),
                "model_us": round(self.model_us, 3),
                "events": (len(self.spans) + len(self.instants)
                           + sum(len(v) for v in self.timelines.values())),
                "instants": len(self.instants)}

    # -- Perfetto export -----------------------------------------------------
    def to_perfetto(self) -> dict:
        """Chrome trace-event JSON: pid 1 = engine (host clock), pid 2 =
        memory hierarchy (modelled clock); one tid per phase / channel
        direction; instants as "i" events on their track; counter
        series as "C" events."""
        ev: list[dict] = []
        tids: dict[tuple[int, str], int] = {}

        def tid(pid: int, track: str) -> int:
            key = (pid, track)
            if key not in tids:
                t = len([k for k in tids if k[0] == pid]) + 1
                tids[key] = t
                ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": t, "args": {"name": track}})
            return tids[key]

        for pid, pname in ((_HOST_PID, "engine (host clock)"),
                           (_MODEL_PID,
                            "memory hierarchy (modelled clock)")):
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": pname}})

        for name, t0, dur, args in self.spans:
            ev.append({"name": name, "ph": "X", "pid": _HOST_PID,
                       "tid": tid(_HOST_PID, name), "ts": round(t0, 3),
                       "dur": round(dur, 3), "cat": "boundary",
                       "args": args})
        for track, ivals in sorted(self.timelines.items()):
            t = tid(_MODEL_PID, track)
            for t0, dur, name, args in ivals:
                ev.append({"name": name, "ph": "X", "pid": _MODEL_PID,
                           "tid": t, "ts": round(t0, 3),
                           "dur": round(dur, 3), "cat": "channel",
                           "args": args})
        for clock, track, name, ts, args in self.instants:
            pid = _MODEL_PID if clock == "model" else _HOST_PID
            ev.append({"name": name, "ph": "i", "pid": pid,
                       "tid": tid(pid, track), "ts": round(ts, 3),
                       "s": "t", "cat": "fault" if track == "faults"
                       else "event", "args": args})
        for name, series in sorted(self.counters.items()):
            for ts, v in series:
                ev.append({"name": name, "ph": "C", "pid": _HOST_PID,
                           "tid": 0, "ts": round(ts, 3),
                           "args": {"value": v}})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"modelled_horizon_us":
                              round(self.model_us, 3)}}

    def export(self, path: str | None = None) -> str:
        """Write the Perfetto JSON; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no trace path: pass one here or at "
                             "construction")
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
        return path
