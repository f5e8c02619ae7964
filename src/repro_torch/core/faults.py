"""Deterministic fault injection for the CXL serving memory hierarchy.

Port of ``repro/core/faults.py`` (numpy only, as there: plans, retries
and chaos schedules draw the reference's numbers exactly).

Real CXL devices misbehave in ways native DDR rarely does: degraded
bandwidth under thermal/link retraining, transient transfer errors
(CRC retries), corrupted media, and outright link loss on hot-unplug
(arXiv:2303.15375; Samsung's CMM-H characterization, arXiv:2503.22017).
The serving stack's premise — KV/working state lives on CXL links — is
only production-credible if those faults are survivable.

``FaultInjector`` is a seeded, schedulable fault plan evaluated against
the pool's *transaction clock* (one tick per ``PagedKVPool.step_multi``
call — the same deterministic clock the megastep planner runs on, so a
fault plan replays bit-identically across runs, megastep widths, and
pipeline depths). Four fault kinds:

  * ``degrade``  — a channel's bandwidth drops to ``factor`` of nominal
    for ``duration`` transactions; billing runs on the degraded model
    (``ChannelModel.degraded``), so busy_us honestly inflates;
  * ``transient``— each transfer attempt on the channel fails with
    probability ``p`` for ``duration`` transactions; the pool retries
    with capped exponential backoff and every failed attempt's transfer
    time + backoff is billed into that channel's ``busy_us`` (no free
    recovery bandwidth);
  * ``poison``   — a logical block's host-side bytes are corrupted; the
    per-block checksum stamped at page-out catches it at the next
    page-in, the host slot is quarantined and only the owning request
    fails;
  * ``offline``  — the channel hot-unplugs: placement excludes it, its
    live blocks are emergency-evacuated onto surviving channels via the
    migration path, and requests that no longer fit are shed.

A fifth, unrecoverable kind — ``crash`` — models whole-process death:
``tick()`` raises :class:`CrashFault` the instant the clock reaches the
event, abandoning the engine mid-transaction (possibly mid-dispatch
with a megastep in flight). Nothing in the serving stack catches it;
the port has no snapshot/journal layer yet to recover from one.

The injector is pure host-side bookkeeping: with no injector attached
the pool/engine fault paths are never entered (zero-cost when
disabled), and with one attached the only nondeterminism is the seeded
``numpy`` Generator, so chaos runs are exactly reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("degrade", "transient", "poison", "offline")

#: ``crash`` is deliberately not in the recoverable-kind default set:
#: ``random_plan(kinds=FAULT_KINDS)`` schedules must stay survivable
#: without a restore harness, and fixed-seed chaos tests depend on the
#: default draw sequence. Pass ``kinds=ALL_FAULT_KINDS`` (or "crash"
#: explicitly) to opt crashes into a generated plan.
ALL_FAULT_KINDS = FAULT_KINDS + ("crash",)

#: transient-retry policy: a failed transfer attempt is retried after an
#: exponentially growing backoff, capped — both the attempt's transfer
#: time and the backoff are billed into the channel's busy_us.
MAX_ATTEMPTS = 6
BACKOFF_BASE_US = 50.0
BACKOFF_CAP_US = 800.0


class CrashFault(RuntimeError):
    """Simulated process death (``crash:@S``): raised from ``tick()`` the
    moment the pool-transaction clock reaches the event's ``at_step``.

    Because ``tick()`` runs inside the pool's paging transaction — which
    at pipeline depth 2 runs inside ``_dispatch`` with a megastep already
    in flight — the exception abandons the engine mid-boundary with
    partial state, exactly like a SIGKILL. Nothing in the serving stack
    catches it; recovery is only possible from an on-disk snapshot +
    journal (not ported). ``at_step`` records which scheduled
    event fired so a restore harness can disarm it (or keep only later
    crashes) on the next attempt.
    """

    def __init__(self, at_step: int):
        super().__init__(
            f"simulated process crash at pool transaction {at_step}")
        self.at_step = int(at_step)


def fresh_fault_stats() -> dict:
    """The ``stats()["faults"]`` schema — always present, zeros when no
    injector is attached (consumers never branch on key presence)."""
    return {"injected": 0, "retried": 0, "recovered": 0,
            "quarantined": 0, "shed": 0, "evacuated": 0, "failed": 0,
            "retry_us": 0.0, "offline_channels": []}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``at_step`` is the pool-transaction clock tick the fault arms on
    (the first ``step_multi`` call is tick 0). ``channel`` indexes the
    host pool's channel list (degrade/transient/offline); ``block`` is
    a logical pool block id (poison). ``duration`` is the active window
    in transactions (0 = permanent; offline is always permanent).
    """
    kind: str
    at_step: int
    channel: int = -1
    block: int = -1
    factor: float = 1.0      # degrade: bandwidth multiplier in (0, 1]
    p: float = 0.0           # transient: per-attempt failure probability
    duration: int = 0

    def __post_init__(self):
        if self.kind not in ALL_FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known kinds: "
                f"{','.join(ALL_FAULT_KINDS)}")
        if self.at_step < 0:
            raise ValueError("fault at_step must be >= 0")
        if self.kind == "poison":
            if self.block < 0:
                raise ValueError("poison faults need a block id")
        elif self.kind == "crash":
            pass                          # process-level: no target
        elif self.channel < 0:
            raise ValueError(f"{self.kind} faults need a channel index")
        if self.kind == "degrade" and not 0.0 < self.factor <= 1.0:
            raise ValueError("degrade factor must be in (0, 1]")
        if self.kind == "transient" and not 0.0 <= self.p < 1.0:
            raise ValueError("transient p must be in [0, 1)")


class FaultInjector:
    """Seeded, schedulable fault plan (see module docstring).

    One injector drives one pool; ``tick()`` is called once per pool
    transaction and arms every event whose ``at_step`` has arrived.
    The shared ``stats`` dict is the single source of truth for the
    engine's ``stats()["faults"]`` section — the pool, the tiered host,
    and the engine all increment it.
    """

    def __init__(self, events, seed: int = 0):
        self.events = sorted(events, key=lambda e: e.at_step)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.step = -1                    # transaction clock (tick 0 first)
        self._cursor = 0
        self.stats = fresh_fault_stats()
        # active windows: channel -> (value, until_step_exclusive)
        self._degrade: dict[int, tuple[float, float]] = {}
        self._transient: dict[int, tuple[float, float]] = {}
        self._offline: set[int] = set()
        self._newly_offline: list[int] = []
        self._poison_armed: list[int] = []
        # observability (serve.trace.Tracer): the engine attaches it so
        # armed events land as instants on the trace's fault track;
        # None = no tracing, zero extra work.
        self.trace = None

    # -- clock --------------------------------------------------------------
    def tick(self) -> None:
        """Advance the transaction clock and arm due events."""
        self.step += 1
        evs = self.events
        while self._cursor < len(evs) and \
                evs[self._cursor].at_step <= self.step:
            ev = evs[self._cursor]
            self._cursor += 1
            until = (float("inf") if ev.duration <= 0
                     else self.step + ev.duration)
            if self.trace is not None:
                args = {"at_step": ev.at_step}
                if ev.kind == "poison":
                    args["block"] = ev.block
                elif ev.kind != "crash":
                    args["channel"] = ev.channel
                if ev.kind == "degrade":
                    args["factor"] = ev.factor
                elif ev.kind == "transient":
                    args["p"] = ev.p
                if ev.duration > 0:
                    args["duration"] = ev.duration
                self.trace.instant("faults", ev.kind, args)
            if ev.kind == "crash":
                # count the injection before dying (the reference's
                # post-mortem of the shared stats dict reads it)
                self.stats["injected"] += 1
                raise CrashFault(ev.at_step)
            if ev.kind == "degrade":
                self._degrade[ev.channel] = (ev.factor, until)
            elif ev.kind == "transient":
                self._transient[ev.channel] = (ev.p, until)
            elif ev.kind == "offline":
                if ev.channel not in self._offline:
                    self._offline.add(ev.channel)
                    self._newly_offline.append(ev.channel)
                    self.stats["offline_channels"].append(ev.channel)
            else:  # poison
                self._poison_armed.append(ev.block)
            self.stats["injected"] += 1

    # -- per-channel billing hooks (pool / tiered host) ---------------------
    def _active(self, table: dict, c: int):
        entry = table.get(c)
        if entry is None:
            return None
        value, until = entry
        if self.step >= until:
            del table[c]
            return None
        return value

    def bandwidth_factor(self, c: int) -> float:
        """Current bandwidth multiplier for channel ``c`` (1.0 = healthy)."""
        f = self._active(self._degrade, c)
        return 1.0 if f is None else f

    def retry_penalty_us(self, c: int, attempt_us: float) -> float:
        """Extra billed time for one transaction's transfers on channel
        ``c`` under an active transient window: seeded draws decide how
        many attempts fail (capped at ``MAX_ATTEMPTS``); each failure
        costs the attempt's transfer time plus a capped exponential
        backoff. Returns 0.0 with no active window (the healthy path
        does no rng work)."""
        p = self._active(self._transient, c)
        if p is None or attempt_us <= 0.0:
            return 0.0
        fails = 0
        extra = 0.0
        while fails < MAX_ATTEMPTS - 1 and self.rng.random() < p:
            extra += attempt_us + min(BACKOFF_BASE_US * (2 ** fails),
                                      BACKOFF_CAP_US)
            fails += 1
        if fails:
            self.stats["retried"] += fails
            self.stats["recovered"] += 1
            self.stats["retry_us"] += extra
        return extra

    def is_offline(self, c: int) -> bool:
        return c in self._offline

    # -- event drains (pool services these per transaction) -----------------
    def drain_offline(self) -> list[int]:
        """Channels that went offline since the last drain."""
        out, self._newly_offline = self._newly_offline, []
        return out

    def drain_poison(self) -> list[int]:
        """Blocks whose poison armed; the pool corrupts host copies and
        re-arms (``rearm_poison``) blocks with nothing to corrupt yet."""
        out, self._poison_armed = self._poison_armed, []
        return out

    def rearm_poison(self, block: int) -> None:
        self._poison_armed.append(block)


def random_plan(seed: int, *, n_channels: int, n_blocks: int,
                horizon: int, n_events: int = 4,
                kinds=FAULT_KINDS) -> list[FaultEvent]:
    """Seeded chaos-schedule generator for the fault harness: a random
    mix of fault events over ``horizon`` pool transactions. Keeps at
    least one channel online (never offlines the last survivor), so a
    generated plan is always survivable at the placement level."""
    rng = np.random.default_rng(seed)
    events: list[FaultEvent] = []
    offline: set[int] = set()
    for _ in range(n_events):
        kind = str(rng.choice(list(kinds)))
        at = int(rng.integers(0, max(1, horizon)))
        if kind == "crash":
            events.append(FaultEvent("crash", at))
            continue
        if kind == "poison":
            events.append(FaultEvent("poison", at,
                                     block=int(rng.integers(0, n_blocks))))
            continue
        c = int(rng.integers(0, n_channels))
        if kind == "offline":
            if len(offline) + 1 >= n_channels or c in offline:
                kind = "degrade"     # keep a survivor; degrade instead
            else:
                offline.add(c)
                events.append(FaultEvent("offline", at, channel=c))
                continue
        dur = int(rng.integers(2, max(3, horizon // 2)))
        if kind == "degrade":
            events.append(FaultEvent(
                "degrade", at, channel=c, duration=dur,
                factor=float(rng.uniform(0.2, 0.9))))
        else:
            events.append(FaultEvent(
                "transient", at, channel=c, duration=dur,
                p=float(rng.uniform(0.05, 0.5))))
    return events


def parse_fault_plan(spec: str) -> list[FaultEvent]:
    """Parse a CLI fault-plan spec into events.

    Grammar (comma-separated entries)::

        offline:C@S            channel C offline at transaction S
        poison:B@S             block B poisoned at transaction S
        degrade:C@S+D=F        channel C at F x bandwidth for D transactions
        transient:C@S+D=P      channel C fails attempts w.p. P for D
        crash:@S               process death at transaction S (no target)

    e.g. ``"offline:2@40,poison:5@10,transient:0@5+20=0.3"``. Raises
    ``ValueError`` naming the grammar on any malformed entry, so CLI
    frontends can validate at argparse time.
    """
    usage = ("expected entries like 'offline:C@S', 'poison:B@S', "
             "'degrade:C@S+D=F', 'transient:C@S+D=P', 'crash:@S'")
    events: list[FaultEvent] = []
    for entry in (e.strip() for e in spec.split(",") if e.strip()):
        try:
            kind, _, rest = entry.partition(":")
            if kind not in ALL_FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} "
                    f"(known: {','.join(ALL_FAULT_KINDS)})")
            target, _, when = rest.partition("@")
            if kind == "crash":
                if target:
                    raise ValueError("crash is process-level — it takes "
                                     "no target ('crash:@S')")
                if "=" in when or "+" in when:
                    raise ValueError("crash is instantaneous — it takes "
                                     "no '+D' window or '=V' value")
                events.append(FaultEvent("crash", int(when)))
                continue
            target = int(target)
            value = None
            if "=" in when:
                when, _, v = when.partition("=")
                value = float(v)
            duration = 0
            if "+" in when:
                when, _, d = when.partition("+")
                duration = int(d)
            at = int(when)
            if kind in ("offline", "poison") and (value is not None
                                                  or duration):
                raise ValueError(f"{kind} is instantaneous — it takes "
                                 "no '+D' window or '=V' value")
            if kind == "offline":
                events.append(FaultEvent("offline", at, channel=target))
            elif kind == "poison":
                events.append(FaultEvent("poison", at, block=target))
            elif kind == "degrade":
                if value is None:
                    raise ValueError("degrade needs '=F' (the factor)")
                if duration <= 0:
                    raise ValueError("degrade needs '+D' (a positive "
                                     "window in transactions)")
                events.append(FaultEvent("degrade", at, channel=target,
                                         duration=duration, factor=value))
            else:
                if value is None:
                    raise ValueError("transient needs '=P' (the "
                                     "failure probability)")
                if duration <= 0:
                    raise ValueError("transient needs '+D' (a positive "
                                     "window in transactions)")
                events.append(FaultEvent("transient", at, channel=target,
                                         duration=duration, p=value))
        except ValueError as e:
            raise ValueError(
                f"bad fault-plan entry {entry!r}: {e}; {usage}") from None
    if not events:
        raise ValueError(f"empty fault plan {spec!r}; {usage}")
    return events
