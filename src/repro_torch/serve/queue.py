"""Request admission via the Policy protocol (CXLAimPod §4.4).

Port of ``repro/serve/queue.py``. Each waiting request is presented to a
``core.policies`` policy as a stream: an LLM prefill with its remaining KV
traffic as backlog, a tenant request (KV store, vector search) with its
declared ``TrafficProfile``, each with hint fields resolved from the
``HintTree``. ``dispatch`` admits the top-weighted arrived requests while
their tenant's budget lasts and feeds the service back through
``Policy.update``.

Everything here is host-side: ``Request`` objects are host mirrors of the
engine's device slot state, and the policy's small float32 state lives on
the CPU (see ``core.policies``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core import policies as policies_lib
from repro_torch.core.hints import HintTree, default_serving_hints

WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"
#: terminal failure state (fault recovery: poisoned block, evacuation
#: casualty, capacity shedding). A FAILED request carries a structured
#: ``error`` dict and whatever partial output it produced; the engine
#: keeps serving everyone else.
FAILED = "failed"

# Device-visible state codes: the engine keeps per-slot request state in
# int32 device tensors and mirrors it back onto Request objects once per
# megastep.
S_EMPTY, S_PREFILL, S_DECODE, S_DONE = 0, 1, 2, 3
STATE_OF_CODE = {S_PREFILL: PREFILL, S_DECODE: DECODE, S_DONE: DONE}


class _RidCounter:
    """Process-wide rid source. Same contract as ``itertools.count()``
    (``next`` yields 0, 1, 2, ...) plus a peek/seek surface so a snapshot
    can record the watermark and a restored process can resume rid
    assignment where the crashed one left off: dispatch tie-breaks on
    rid, so bit-exact resume needs bit-exact rids."""

    def __init__(self, start: int = 0):
        self._next = int(start)

    def __next__(self) -> int:
        n, self._next = self._next, self._next + 1
        return n

    def __iter__(self):
        return self

    def peek(self) -> int:
        return self._next

    def seek(self, value: int) -> None:
        """Move the watermark forward (never backward: rids must stay
        unique within a process even across restores)."""
        self._next = max(self._next, int(value))


_rid = _RidCounter()


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """Declared link-traffic profile of one non-LLM tenant request: total
    remaining bytes per direction plus the head-of-queue (next-step) mix,
    which the duplex-aware policies read at dispatch time."""
    backlog_read: float = 0.0
    backlog_write: float = 0.0
    head_read: float = 0.0
    head_write: float = 0.0


@dataclasses.dataclass(eq=False)
class Request:
    """One request moving through the serving engine. ``tenant`` is
    ``"llm"`` for generation requests, or the name of an attached
    ``WorkloadAPI`` tenant, whose payload is ``work`` and whose declared
    traffic is ``profile``."""
    prompt: np.ndarray                  # (P,) int32 prompt token ids
    max_new_tokens: int
    arrival_step: int = 0
    hint_path: str = "/serve/llm/prefill"
    tenant: str = "llm"
    work: object = None                 # tenant payload (non-LLM requests)
    profile: TrafficProfile | None = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))
    state: str = WAITING
    consumed: int = 0                   # prompt tokens fed so far
    generated: list = dataclasses.field(default_factory=list)
    #: speculative (state, consumed, n_gen) planning view, set at dispatch
    #: time when megasteps are pipelined (see ``speculate``).
    spec: tuple | None = None
    blocks: list = dataclasses.field(default_factory=list)  # pool block ids
    blocks_freed: bool = False          # pool blocks already released
    slot: int = -1                      # engine batch slot while running
    admitted_step: int = -1
    done_step: int = -1
    #: structured failure record once ``state == FAILED``:
    #: ``{"kind": "poisoned_block"|"evacuation_casualty"|"shed",
    #:    "step": <engine step>, ...kind-specific fields}``.
    error: dict | None = None
    #: optional completion deadline (engine step). Under degraded
    #: capacity the engine sheds doomed-deadline requests first.
    deadline_step: int | None = None
    #: a traced engine's stamps, on its tracer's host clock (None when
    #: untraced): ``{"rid", "submit_us", "admit_us" (None while it
    #: waits), "overtaken"}``, the requests behind it in FIFO order that
    #: ``RequestQueue.dispatch`` admitted while it waited.
    trace: dict | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def sync_megastep(self, code: int, consumed: int, n_gen: int,
                      tokens) -> None:
        """Refresh this host mirror from a megastep's packed readback:
        ``tokens`` are the samples of the inner steps this row emitted on,
        in step order; the device's final counters cross-check the host's
        step-count arithmetic."""
        self.state = STATE_OF_CODE[int(code)]
        self.consumed = int(consumed)
        self.generated.extend(int(t) for t in tokens)
        if int(n_gen) != len(self.generated):
            raise RuntimeError(
                f"rid {self.rid}: device reports {int(n_gen)} generated "
                f"tokens after the megastep but the host trajectory "
                f"yields {len(self.generated)} — mirrors out of sync")
        if self.spec == (self.state, self.consumed, len(self.generated)):
            # the deferred readback caught the real mirror up to the last
            # dispatched boundary — drop the speculative view.
            self.spec = None

    # -- speculative planning view (pipelined megasteps) -------------------
    def speculate(self, state: str, consumed: int, n_gen: int) -> None:
        """Advance the planning view to the predicted post-megastep state
        at dispatch time; ``plan_*`` is what the engine plans from."""
        self.spec = (state, int(consumed), int(n_gen))

    @property
    def plan_state(self) -> str:
        return self.spec[0] if self.spec is not None else self.state

    @property
    def plan_consumed(self) -> int:
        return self.spec[1] if self.spec is not None else self.consumed

    @property
    def plan_n_gen(self) -> int:
        return (self.spec[2] if self.spec is not None
                else len(self.generated))


class RequestQueue:
    """Bounded waiting room with policy-driven admission."""

    def __init__(self, capacity: int = 32,
                 policy: str | policies_lib.Policy = "hinted",
                 params: policies_lib.PolicyParams | None = None,
                 hints: HintTree | None = None,
                 link: channel_lib.ChannelModel = channel_lib.PCIE_HOST,
                 kv_bytes_per_token: float = 4096.0):
        self.capacity = capacity
        self.policy = (policies_lib.get_policy(policy)
                       if isinstance(policy, str) else policy)
        self.params = params or policies_lib.PolicyParams()
        self.hints = hints or default_serving_hints()
        self.kv_bytes = float(kv_bytes_per_token)
        self._slots: list[Request | None] = [None] * capacity
        self._state = self.policy.init(self.params, capacity)
        self._prev_util = 0.0   # last megastep's mean engine-slot
                                # utilization (note_service)
        self.tracer = None      # a traced engine's serve.trace.Tracer:
                                # dispatch stamps admissions, counts
                                # overtakes
        self._opt_r = torch.tensor(channel_lib.peak_read_fraction(link),
                                   dtype=torch.float32)
        self._duplex = torch.tensor(link.duplex)

    # -- intake ------------------------------------------------------------
    def submit(self, req: Request) -> Request:
        for i, cur in enumerate(self._slots):
            if cur is None:
                self._slots[i] = req
                # cgroup-hint bootstrap (§4.5): the declared read fraction
                # seeds the policy's per-slot forecast.
                h = self.hints.resolve(req.hint_path).resolved()
                self._state = policies_lib.seed_read_fraction(
                    self._state, i, h.read_fraction)
                return req
        raise RuntimeError(f"request queue full ({self.capacity})")

    def waiting(self, now: int | None = None) -> list[Request]:
        out = [r for r in self._slots if r is not None]
        if now is not None:
            out = [r for r in out if r.arrival_step <= now]
        return out

    def __len__(self) -> int:
        return len(self.waiting())

    # -- megastep service feedback -----------------------------------------
    def note_service(self, fb: policies_lib.Feedback,
                     mean_util: float | None = None) -> None:
        """Fold a megastep's stacked feedback into the policy, step by
        step; ``mean_util`` becomes the next ``schedule``'s
        ``Obs.prev_util``."""
        self._state = policies_lib.fold_feedback(self.policy, self.params,
                                                 self._state, fb)
        if mean_util is not None:
            self._prev_util = float(mean_util)

    # -- policy-driven admission -------------------------------------------
    def _observe(self, now: int) -> tuple[policies_lib.Obs, np.ndarray]:
        S = self.capacity
        z = np.zeros((S,), np.float32)
        backlog_r, backlog_w = z.copy(), z.copy()
        head_r, head_w = z.copy(), z.copy()
        hint_rf = np.full((S,), 0.5, np.float32)
        hint_pri = np.ones((S,), np.float32)
        hint_opt = np.ones((S,), bool)
        arrived = np.zeros((S,), bool)
        for i, r in enumerate(self._slots):
            if r is None or r.arrival_step > now:
                continue
            arrived[i] = True
            if r.profile is not None:
                # tenant request: declared traffic profile (bytes).
                backlog_r[i] = r.profile.backlog_read
                backlog_w[i] = r.profile.backlog_write
                head_r[i] = r.profile.head_read
                head_w[i] = r.profile.head_write
            else:
                # LLM request: prefill writes the prompt's KV; decode then
                # re-reads the whole cache once per generated token
                # (triangular sum).
                n_p, n_g = r.prompt_len, r.max_new_tokens
                backlog_w[i] = n_p * self.kv_bytes
                backlog_r[i] = (n_g * n_p + n_g * (n_g + 1) / 2) \
                    * self.kv_bytes
                head_w[i] = min(n_p, 4) * self.kv_bytes
                head_r[i] = 0.0
            h = self.hints.resolve(r.hint_path).resolved()
            hint_rf[i] = h.read_fraction
            hint_pri[i] = h.priority
            hint_opt[i] = h.duplex_opt_in
        t = torch.from_numpy
        obs = policies_lib.Obs(
            step=torch.tensor(now, dtype=torch.int32),
            backlog_read=t(backlog_r), backlog_write=t(backlog_w),
            arrival_read=t(z.copy()), arrival_write=t(z.copy()),
            head_read=t(head_r), head_write=t(head_w),
            prev_weights=torch.zeros((S,), dtype=torch.float32),
            prev_util=torch.tensor(self._prev_util, dtype=torch.float32),
            opt_r=self._opt_r, duplex=self._duplex,
            hint_rf=t(hint_rf), hint_priority=t(hint_pri),
            hint_opt_in=t(hint_opt),
        )
        return obs, arrived

    def dispatch(self, now: int,
                 n_free: int | dict[str, int]) -> list[Request]:
        """Admit arrived requests, policy-ordered.

        ``n_free`` is either an int — a tenant-agnostic slot budget — or a
        dict mapping tenant name to that tenant's free slots; the policy
        ranks the whole waiting set and the top-weighted requests are
        taken while their tenant's budget lasts (a full tenant never
        blocks admission of another's requests)."""
        budgets = dict(n_free) if isinstance(n_free, dict) else None
        cap = (sum(budgets.values()) if budgets is not None
               else int(n_free))
        if cap <= 0 or not self.waiting(now):
            return []
        obs, arrived = self._observe(now)
        self._state, w = self.policy.schedule(self.params, self._state, obs)
        w = w.numpy().astype(np.float32)
        # policy weight first, FIFO (arrival, submit order) as tie-break;
        # rid is monotonic in submit order, unlike the waiting-room slot
        # index, which gets recycled. ``sorted`` is stable.
        order = sorted(
            np.flatnonzero(arrived).tolist(),
            key=lambda i: (-w[i], self._slots[i].arrival_step,
                           self._slots[i].rid))
        take = []
        for i in order:
            if len(take) >= cap:
                break
            if budgets is not None:
                t = self._slots[i].tenant
                if budgets.get(t, 0) <= 0:
                    continue
                budgets[t] -= 1
            take.append(i)
        if self.tracer is not None:
            self._note_admissions(take, arrived)
        admitted = []
        moved_r = np.zeros((self.capacity,), np.float32)
        moved_w = np.zeros((self.capacity,), np.float32)
        for i in take:
            req = self._slots[i]
            self._slots[i] = None
            req.state = PREFILL
            req.admitted_step = now
            admitted.append(req)
            if req.profile is not None:
                moved_r[i] = req.profile.head_read
                moved_w[i] = req.profile.head_write
            else:
                moved_w[i] = req.prompt_len * self.kv_bytes
        fb = policies_lib.Feedback(
            moved_read=torch.from_numpy(moved_r),
            moved_write=torch.from_numpy(moved_w),
            utilization=torch.tensor(min(1.0, len(take) / max(cap, 1)),
                                     dtype=torch.float32))
        self._state = self.policy.update(self.params, self._state, fb)
        self._reset_slot_state(take)
        return admitted

    def _note_admissions(self, take: list[int],
                         arrived: np.ndarray) -> None:
        """Stamp the taken requests' admission on the tracer's clock, and
        add to each arrived request left waiting the taken requests of its
        tenant that FIFO order (arrival step, then rid) puts behind it: an
        admission on another tenant's budget overtakes nobody."""
        now_us = self.tracer.now_us()
        taken = [self._slots[i] for i in take]
        for r in taken:
            if r.trace is not None:
                r.trace["admit_us"] = now_us
        left = set(np.flatnonzero(arrived).tolist()) - set(take)
        for i in left:
            r = self._slots[i]
            if r.trace is None:
                continue
            key = (r.arrival_step, r.rid)
            r.trace["overtaken"] += sum(
                a.tenant == r.tenant and (a.arrival_step, a.rid) > key
                for a in taken)

    def remove(self, req: Request) -> bool:
        """Withdraw a still-waiting request (fault shedding: under
        degraded capacity the engine removes queued requests that can
        never fit the surviving host tiers). Resets the vacated slot's
        policy state exactly like an admission would."""
        for i, cur in enumerate(self._slots):
            if cur is req:
                self._slots[i] = None
                self._reset_slot_state([i])
                return True
        return False

    # -- snapshot/restore --------------------------------------------------
    def snapshot_state(self) -> tuple[list[np.ndarray], float]:
        """Host copies of the policy state's leaves plus the utilization
        the next ``dispatch`` will observe. The waiting Requests are
        serialized by the snapshot layer, which records each one's
        waiting-room slot: per-slot policy state is indexed by it, so
        occupancy must round-trip positionally."""
        return policies_lib.policy_state_leaves(self._state), \
            self._prev_util

    def load_state(self, leaves, prev_util: float,
                   slots: dict[int, Request]) -> None:
        """Inverse of ``snapshot_state``: rebuild the policy state from a
        fresh-init template and re-seat waiting requests at their
        recorded waiting-room slots."""
        template = self.policy.init(self.params, self.capacity)
        self._state = policies_lib.rebuild_policy_state(template, leaves)
        self._prev_util = float(prev_util)
        self._slots = [slots.get(i) for i in range(self.capacity)]

    def _reset_slot_state(self, idx: list[int]) -> None:
        """Reinitialize per-slot policy state for vacated waiting slots —
        a later request recycling the slot must not inherit the previous
        occupant's vruntime/history."""
        if not idx:
            return
        mask = np.zeros((self.capacity,), bool)
        mask[idx] = True
        self._state = policies_lib.reset_slots(
            self.policy, self.params, self.capacity, self._state,
            torch.from_numpy(mask))
