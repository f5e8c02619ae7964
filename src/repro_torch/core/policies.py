"""Admission policies (CXLAimPod §4.4, Algorithm 1) on torch tensors.

Port of ``repro/core/policies.py``: the ``init / schedule / update``
policy protocol and all six policies of its registry — ``cfs`` (fair
share, direction-oblivious), ``ddr_batching`` (serve the majority
direction), ``round_robin`` (rotate slot ownership), ``threshold``
(static duplex-aware greedy mix), ``timeseries`` (Algorithm 1) and
``hinted`` (timeseries seeded by cgroup hints; the engine's default) —
plus ``migration_volume`` and the megastep feedback helpers
(``seed_read_fraction``, ``stack_feedbacks``, ``fold_feedback``).

A policy's state is a handful of small float32 vectors, one entry per
stream. ``init`` makes it on the device it is given, and ``schedule`` /
``update`` make every tensor on their inputs' device and read nothing
back to the host, so a policy runs inside the simulator's CUDA graph
(``core.scheduler``) as well as on the CPU, where the serving queue
keeps it (the reference reads the weights back at every admission, so
keeping that state off the card costs no transfer). The arithmetic
follows the reference operation for operation in float32, with two
PyTorch-specific cares: sorts are stable (``jnp.argsort`` is; PyTorch's
stable sort is stable on CUDA too), and a Python scalar divided by a
tensor is written as a tensor divide (``scalar / tensor`` in PyTorch
multiplies by the reciprocal, which is not the IEEE divide the reference
does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

F32 = torch.float32


def _sdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """IEEE ``a / t`` for a Python scalar ``a``."""
    return torch.full_like(t, a) / t


class Obs(NamedTuple):
    """Per-step observation handed to ``schedule``."""
    step: torch.Tensor           # int32 scalar
    backlog_read: torch.Tensor   # (S,) bytes of pending read work
    backlog_write: torch.Tensor  # (S,)
    arrival_read: torch.Tensor   # (S,) this step's newly offered work
    arrival_write: torch.Tensor  # (S,)
    head_read: torch.Tensor      # (S,) read bytes in the next segment
    head_write: torch.Tensor     # (S,)
    prev_weights: torch.Tensor   # (S,) last step's run weights
    prev_util: torch.Tensor      # float scalar, channel utilization in [0,1]
    opt_r: torch.Tensor          # channel's optimal aggregate read fraction
    duplex: torch.Tensor         # bool scalar
    hint_rf: torch.Tensor        # (S,) declared read fractions (cgroup hints)
    hint_priority: torch.Tensor  # (S,) vruntime weights
    hint_opt_in: torch.Tensor    # (S,) bool, duplex intervention allowed

    def head_rf(self) -> torch.Tensor:
        tot = self.head_read + self.head_write
        return torch.where(tot > 0,
                           self.head_read / torch.clamp(tot, min=1e-9), 0.5)


class Feedback(NamedTuple):
    """Post-dispatch feedback handed to ``update``."""
    moved_read: torch.Tensor     # (S,) bytes actually serviced
    moved_write: torch.Tensor    # (S,)
    utilization: torch.Tensor    # scalar


@dataclasses.dataclass(frozen=True)
class PolicyParams:
    n_slots: float = 4.0          # concurrent CPU slots ("cores")
    window: int = 32              # sliding window length (Alg 1 W_t)
    ewma_alpha: float = 0.12      # trend smoothing
    oversub_threads_per_core: float = 1.5   # §4.4.1 detection constants
    oversub_util: float = 0.85
    hysteresis: float = 0.25      # min weight change worth a migration
    base_slice: float = 1.0       # nominal time slice (steps)
    unidir_cutoff: float = 0.12   # |mix - {0,1}| below which we withdraw
    temperature: float = 0.35     # deadline -> weight softmax temperature


class Policy(NamedTuple):
    """The paper's three-method policy interface, as pure functions;
    ``init(params, n_streams, device="cpu")``."""
    name: str
    init: Callable[..., Any]
    schedule: Callable[[PolicyParams, Any, Obs], tuple[Any, torch.Tensor]]
    update: Callable[[PolicyParams, Any, Feedback], Any]


def _normalize_slots(raw: torch.Tensor, n_slots: float) -> torch.Tensor:
    """Scale nonnegative weights so their sum is min(sum, n_slots), <=1 each."""
    raw = torch.clamp(raw, 0.0, 1.0)
    total = torch.sum(raw)
    scale = torch.where(total > n_slots,
                        _sdiv(n_slots, torch.clamp(total, min=1e-9)), 1.0)
    return raw * scale


def _active(obs: Obs) -> torch.Tensor:
    return (obs.backlog_read + obs.backlog_write) > 0.0


# ---------------------------------------------------------------------------
# cfs — fair share, direction-oblivious (the paper's baseline).
# ---------------------------------------------------------------------------

def _cfs_init(params: PolicyParams, n_streams: int, device="cpu"):
    return ()


def _cfs_schedule(params: PolicyParams, state, obs: Obs):
    return state, _normalize_slots(_active(obs).to(F32), params.n_slots)


def _cfs_update(params: PolicyParams, state, fb: Feedback):
    return state


CFS = Policy("cfs", _cfs_init, _cfs_schedule, _cfs_update)


# ---------------------------------------------------------------------------
# ddr_batching — group same-direction work, minimize switches.
# ---------------------------------------------------------------------------

class _BatchState(NamedTuple):
    direction: torch.Tensor   # int32, 0 = favor reads, 1 = favor writes
    residual: torch.Tensor    # float32, batch budget remaining


def _batch_init(params: PolicyParams, n_streams: int, device="cpu"):
    return _BatchState(torch.zeros((), dtype=torch.int32, device=device),
                       torch.zeros((), dtype=F32, device=device))


def _batch_schedule(params: PolicyParams, state: _BatchState, obs: Obs):
    tot_r = torch.sum(obs.backlog_read)
    tot_w = torch.sum(obs.backlog_write)
    # switch direction only when the current one is (nearly) drained.
    cur_dir_bytes = torch.where(state.direction == 0, tot_r, tot_w)
    switch = cur_dir_bytes <= 0.0
    reads = torch.zeros_like(state.direction)
    direction = torch.where(switch, torch.where(tot_r >= tot_w, reads,
                                                reads + 1),
                            state.direction)
    backlog = torch.where(direction == 0, obs.backlog_read,
                          obs.backlog_write)
    w = _normalize_slots((backlog > 0.0).to(F32), params.n_slots)
    # if nothing matches the favored direction, fall back to fair share.
    fallback = _normalize_slots(_active(obs).to(F32), params.n_slots)
    w = torch.where(torch.sum(w) > 0.0, w, fallback)
    return _BatchState(direction, state.residual), w


def _batch_update(params: PolicyParams, state: _BatchState, fb: Feedback):
    return state


DDR_BATCHING = Policy("ddr_batching", _batch_init, _batch_schedule,
                      _batch_update)


# ---------------------------------------------------------------------------
# round_robin — rotate slots; direction-oblivious. The state is a bare
# int32 scalar (the rotation offset), not a tuple.
# ---------------------------------------------------------------------------

def _rr_init(params: PolicyParams, n_streams: int, device="cpu"):
    return torch.zeros((), dtype=torch.int32, device=device)


def _rr_schedule(params: PolicyParams, state, obs: Obs):
    n = obs.backlog_read.shape[0]
    k = max(1, int(params.n_slots))
    # ``%`` on a tensor floors like ``jnp``'s: a negative difference wraps
    idx = (torch.arange(n, dtype=torch.int32, device=state.device)
           - state) % n
    raw = (idx < k).to(F32) * _active(obs).to(F32)
    return (state + k) % n, _normalize_slots(raw, params.n_slots)


RR = Policy("round_robin", _rr_init, _rr_schedule, lambda p, s, f: s)


# ---------------------------------------------------------------------------
# duplex-aware slot quotas (duplex_select_cpu).
# ---------------------------------------------------------------------------

def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each element under a stable descending sort (0 = largest)."""
    order = torch.argsort(-scores, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(scores.shape[0], device=scores.device)
    return rank


def _quota_weights(rf, urgency, active, opt_in, n_slots: float, opt_r):
    """Fill ~k·opt_r slots with the most-urgent read-leaning streams and
    the rest with the most-urgent write-leaning ones; leftover slots fall
    back to global urgency order."""
    NEG = -1e9
    k = max(1, int(n_slots))
    act = active > 0.0
    grouped = act & opt_in
    readers = grouped & (rf >= 0.5)
    writers = grouped & (rf < 0.5)
    n_read = torch.sum(readers)
    n_write = torch.sum(writers)
    k_r = torch.clamp(torch.round(k * opt_r).to(torch.int32), 0, k)
    k_r = torch.minimum(k_r, n_read)
    k_w = torch.minimum(k - k_r, n_write)
    k_r = torch.minimum(k - k_w, n_read)     # redistribute scarce groups
    r_rank = _rank_desc(torch.where(readers, urgency, NEG))
    w_rank = _rank_desc(torch.where(writers, urgency, NEG))
    sel = (readers & (r_rank < k_r)) | (writers & (w_rank < k_w))
    # leftover slots: best remaining active streams (incl. opted-out)
    rem = k - torch.sum(sel)
    o_rank = _rank_desc(torch.where(act & ~sel, urgency, NEG))
    sel = sel | (act & ~sel & (o_rank < rem))
    return _normalize_slots(sel.to(F32), n_slots)


def _thr_schedule(params: PolicyParams, state, obs: Obs):
    """threshold — the static duplex-aware greedy mix toward ``opt_r``."""
    active = _active(obs).to(F32)
    head_tot = obs.head_read + obs.head_write
    agg = torch.sum(head_tot * active)
    work_mix = torch.where(agg > 0,
                           torch.sum(obs.head_read * active)
                           / torch.clamp(agg, min=1e-9), obs.opt_r)
    target = 0.5 * work_mix + 0.5 * obs.opt_r
    w_duplex = _quota_weights(obs.head_rf(), torch.ones_like(active), active,
                              obs.hint_opt_in, params.n_slots, target)
    w_fair = _normalize_slots(active, params.n_slots)
    return state, torch.where(obs.duplex, w_duplex, w_fair)


THRESHOLD = Policy("threshold", _cfs_init, _thr_schedule, _cfs_update)


# ---------------------------------------------------------------------------
# timeseries machinery (Algorithm 1); seeded by hints in ``hinted``.
# ---------------------------------------------------------------------------

class TimeSeriesState(NamedTuple):
    window: torch.Tensor       # (W, 4): [demand_r, demand_w, moved, util]
    cursor: torch.Tensor       # int32 ring-buffer cursor
    ewma_rf: torch.Tensor      # (S,) per-stream read-fraction forecast
    ewma_rate: torch.Tensor    # (S,) per-stream demand forecast (bytes/step)
    volatility: torch.Tensor   # (S,) EWMA |forecast error| -> adaptive slice
    vruntime: torch.Tensor     # (S,) weighted service received
    prev_w: torch.Tensor       # (S,) last weights (hysteresis)
    oversub: torch.Tensor      # bool


def _ts_init(params: PolicyParams, n_streams: int,
             device="cpu") -> TimeSeriesState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=device)

    return TimeSeriesState(
        window=zeros(params.window, 4),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        ewma_rf=torch.full((n_streams,), 0.5, dtype=F32, device=device),
        ewma_rate=zeros(n_streams),
        volatility=zeros(n_streams),
        vruntime=zeros(n_streams),
        prev_w=zeros(n_streams),
        oversub=torch.zeros((), dtype=torch.bool, device=device),
    )


def _ts_phase1_update_window(params: PolicyParams, state: TimeSeriesState,
                             obs: Obs) -> TimeSeriesState:
    """Alg 1 lines 4-7: CollectSystemMetrics / UpdateSlidingWindow / trends."""
    sample = torch.stack([
        torch.sum(obs.arrival_read),
        torch.sum(obs.arrival_write),
        torch.sum(obs.backlog_read + obs.backlog_write),
        obs.prev_util.to(F32),
    ])
    # the ring slot is indexed on the device: no read of the cursor back
    row = (state.cursor % params.window).reshape(1).to(torch.int64)
    window = state.window.index_copy(0, row, sample.reshape(1, 4))
    cursor = state.cursor + 1

    a = params.ewma_alpha
    arr = obs.arrival_read + obs.arrival_write
    inst_rf = torch.where(arr > 0.0,
                          obs.arrival_read / torch.clamp(arr, min=1e-9),
                          state.ewma_rf)
    err = torch.abs(inst_rf - state.ewma_rf)
    ewma_rf = (1 - a) * state.ewma_rf + a * inst_rf
    ewma_rate = (1 - a) * state.ewma_rate + a * arr
    volatility = (1 - a) * state.volatility + a * err
    return state._replace(window=window, cursor=cursor, ewma_rf=ewma_rf,
                          ewma_rate=ewma_rate, volatility=volatility)


def _ts_phase2_detect_oversub(params: PolicyParams, state: TimeSeriesState,
                              obs: Obs) -> torch.Tensor:
    """Alg 1 lines 8-10: runnable/slots > 1.5 while utilization > 85%."""
    runnable = torch.sum(_active(obs).to(F32))
    per_core = runnable / params.n_slots
    filled = torch.clamp(state.cursor, max=params.window).to(F32)
    mean_util = torch.sum(state.window[:, 3]) / torch.clamp(filled, min=1.0)
    return (per_core > params.oversub_threads_per_core) & \
        (mean_util > params.oversub_util)


def _prime_weights(params: PolicyParams, state: TimeSeriesState,
                   obs: Obs) -> torch.Tensor:
    """Pipeline priming for lockstep-unidirectional oversubscription: pin
    a stable subset so opposing phases start to overlap."""
    active = _active(obs).to(F32)
    sticky = state.prev_w * active
    k = params.n_slots
    first_k = (torch.cumsum(active, 0) <= k).to(F32) * active
    use_sticky = torch.sum(sticky) >= 1.0
    raw = torch.where(use_sticky, sticky, first_k)
    return _normalize_slots(raw, k)


def _ts_phase34_dispatch(params: PolicyParams, state: TimeSeriesState,
                         obs: Obs, rf_forecast: torch.Tensor,
                         frozen: torch.Tensor) -> torch.Tensor:
    """Alg 1 lines 11-23: vruntime deadlines + duplex-aware CPU selection.
    ``frozen`` marks streams exempt from duplex intervention."""
    active = _active(obs).to(F32)
    slice_ = _sdiv(params.base_slice, 1.0 + 4.0 * state.volatility)
    slice_ = torch.where(state.oversub, slice_ * 0.5, slice_)
    deadline = state.vruntime + slice_ / torch.clamp(obs.hint_priority,
                                                     min=1e-3)
    any_active = torch.any(active > 0)
    dmin = torch.min(torch.where(active > 0, deadline, float("inf")))
    dl = deadline - torch.where(any_active, dmin, 0.0)
    urgency = torch.where(active > 0, torch.exp(-dl / params.temperature),
                          0.0)
    w_fair = _normalize_slots(urgency, params.n_slots)

    opt_in = frozen <= 0.0
    head_tot = obs.head_read + obs.head_write
    agg = torch.sum(head_tot * active)
    work_mix = torch.where(agg > 0,
                           torch.sum(obs.head_read * active)
                           / torch.clamp(agg, min=1e-9), obs.opt_r)
    target = 0.5 * work_mix + 0.5 * obs.opt_r
    w_duplex = _quota_weights(rf_forecast, urgency, active, opt_in,
                              params.n_slots, target)
    all_frozen = torch.all(frozen > 0.0)
    w = torch.where(~obs.duplex | all_frozen, w_fair, w_duplex)
    return _normalize_slots(w * active, params.n_slots)


def _ts_schedule(params: PolicyParams, state: TimeSeriesState, obs: Obs):
    """timeseries — Algorithm 1 with the measured forecast: the head of
    queue's direction where work is queued, the EWMA trend otherwise;
    a unidirectional aggregate primes the pipeline when oversubscribed
    and withdraws the duplex intervention when not."""
    state = _ts_phase1_update_window(params, state, obs)
    oversub = _ts_phase2_detect_oversub(params, state, obs)
    state = state._replace(oversub=oversub)
    head = obs.head_read + obs.head_write
    rf_forecast = torch.where(head > 0, obs.head_rf(), state.ewma_rf)
    rate = torch.clamp(head + state.ewma_rate, min=1e-9)
    global_mix = torch.sum(rf_forecast * rate) / torch.sum(rate)
    unidir = (global_mix < params.unidir_cutoff) | \
        (global_mix > 1.0 - params.unidir_cutoff)
    frozen = torch.where(unidir, torch.ones_like(rf_forecast),
                         torch.zeros_like(rf_forecast))
    w_normal = _ts_phase34_dispatch(params, state, obs, rf_forecast,
                                    frozen)
    w_prime = _prime_weights(params, state, obs)
    w = torch.where(unidir & state.oversub, w_prime, w_normal)
    return state._replace(prev_w=w), w


def _ts_update(params: PolicyParams, state: TimeSeriesState, fb: Feedback):
    served = fb.moved_read + fb.moved_write
    v = state.vruntime + served / torch.clamp(torch.sum(served) + 1e-9,
                                              min=1e-9)
    v = v - torch.min(v)
    return state._replace(vruntime=v)


TIMESERIES = Policy("timeseries", _ts_init, _ts_schedule, _ts_update)


# ---------------------------------------------------------------------------
# hinted — timeseries + cgroup hints (§4.5).
# ---------------------------------------------------------------------------

def _hint_schedule(params: PolicyParams, state: TimeSeriesState, obs: Obs):
    state = _ts_phase1_update_window(params, state, obs)
    oversub = _ts_phase2_detect_oversub(params, state, obs)
    state = state._replace(oversub=oversub)
    # hints replace the measured forecast; the dispatch-time task profile
    # still wins when work is queued.
    head = obs.head_read + obs.head_write
    rf_forecast = torch.where(head > 0, obs.head_rf(), obs.hint_rf)
    opt_out = 1.0 - obs.hint_opt_in.to(F32)
    rate = torch.clamp(head + state.ewma_rate, min=1e-9)
    global_mix = torch.sum(rf_forecast * rate) / torch.sum(rate)
    unidir = (global_mix < params.unidir_cutoff) | \
        (global_mix > 1.0 - params.unidir_cutoff)
    frozen = torch.maximum(opt_out, torch.where(unidir, 1.0, 0.0)
                           * torch.ones_like(rf_forecast))
    w_normal = _ts_phase34_dispatch(params, state, obs, rf_forecast,
                                    frozen)
    w_prime = _prime_weights(params, state, obs)
    all_opted_out = torch.max(obs.hint_opt_in.to(F32)) < 0.5
    prime_ok = unidir & state.oversub & ~all_opted_out
    w = torch.where(prime_ok, w_prime, w_normal)
    return state._replace(prev_w=w), w


HINTED = Policy("hinted", _ts_init, _hint_schedule, _ts_update)

REGISTRY: dict[str, Policy] = {
    p.name: p for p in (CFS, DDR_BATCHING, RR, THRESHOLD, TIMESERIES, HINTED)
}


def get_policy(name: str) -> Policy:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {sorted(REGISTRY)}"
        ) from None


def seed_read_fraction(state: Any, slot: int, read_fraction: float) -> Any:
    """Seed one slot's declared read fraction into a policy's trend state
    (the cgroup-hint bootstrap of §4.5). No-op for stateless policies."""
    if isinstance(state, TimeSeriesState):
        ewma_rf = state.ewma_rf.clone()
        ewma_rf[slot] = float(np.float32(read_fraction))
        return state._replace(ewma_rf=ewma_rf)
    return state


def migration_volume(prev_w: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """L1 weight reallocation per step — the migration overhead proxy that
    the simulator charges against channel capacity."""
    return 0.5 * torch.sum(torch.abs(w - prev_w))


def reset_slots(policy: Policy, params: PolicyParams, capacity: int,
                state: Any, mask: torch.Tensor) -> Any:
    """Reinitialize per-slot policy state for the masked waiting slots:
    every leaf whose leading axis has ``capacity`` entries takes the
    fresh-init rows under ``mask`` (the reference's ``_policy_programs``
    reset, leaf rule included): a state that is not a tuple, such as
    ``round_robin``'s int32 offset, has no per-slot leaf and is returned
    unchanged."""
    if not isinstance(state, tuple) or not state:
        return state
    fresh = policy.init(params, capacity, device=mask.device)

    def sel(cur, f):
        if cur.dim() >= 1 and cur.shape[0] == capacity:
            m = mask.reshape((-1,) + (1,) * (cur.dim() - 1))
            return torch.where(m, f, cur)
        return cur

    return type(state)(*(sel(c, f) for c, f in zip(state, fresh)))


# ---------------------------------------------------------------------------
# state round-trip — snapshot/restore support for every registered policy.
# ---------------------------------------------------------------------------

def _state_leaves(state: Any) -> list:
    """A policy state's tensors in the reference's pytree flatten order:
    ``()`` has none, a bare tensor is its own leaf, a NamedTuple its
    fields in order."""
    if isinstance(state, tuple):
        return [leaf for part in state for leaf in _state_leaves(part)]
    return [state]


def policy_state_leaves(state: Any) -> list[np.ndarray]:
    """Flatten a policy state (any of the registry's shapes: ``()``, a
    bare int32, a NamedTuple of tensors) into host arrays for
    checkpointing. Leaf order matches :func:`rebuild_policy_state`'s
    template, so a snapshot round-trips bit-exactly through the pair."""
    return [leaf.detach().cpu().numpy() for leaf in _state_leaves(state)]


def rebuild_policy_state(template: Any, leaves) -> Any:
    """Rebuild a policy state from :func:`policy_state_leaves` output.

    ``template`` is a freshly initialized state of the same policy
    (``policy.init(params, capacity)``): it supplies the structure and
    each leaf's dtype, shape and device, which the flat host arrays do
    not carry."""
    n = len(_state_leaves(template))
    if n != len(leaves):
        raise ValueError(
            f"policy state arity mismatch: template has {n} leaves, "
            f"snapshot has {len(leaves)} — was the engine restored with a "
            "different policy?")
    it = iter(leaves)

    def build(tpl):
        if isinstance(tpl, tuple):
            return type(tpl)(*(build(part) for part in tpl))
        return torch.tensor(np.asarray(next(it)).reshape(tuple(tpl.shape)),
                            dtype=tpl.dtype, device=tpl.device)

    return build(template)


# ---------------------------------------------------------------------------
# megastep feedback aggregation — K per-step Feedbacks folded in one call.
# ---------------------------------------------------------------------------

def stack_feedbacks(fbs) -> Feedback:
    """Stack K per-step ``Feedback``s into one with a leading step axis
    (not a lossy sum: updates are not linear in the feedback)."""
    if not fbs:
        raise ValueError("stack_feedbacks needs at least one Feedback")
    return Feedback(*(
        torch.from_numpy(np.stack([np.asarray(x, np.float32)
                                   for x in leaves]))
        for leaves in zip(*fbs)))


def is_stacked(fb: Feedback) -> bool:
    return torch.as_tensor(fb.utilization).dim() >= 1


def fold_feedback(policy: Policy, params: PolicyParams, state: Any,
                  fb: Feedback) -> Any:
    """Apply one feedback — or a whole stacked megastep of them, in step
    order — to a policy."""
    if not is_stacked(fb):
        return policy.update(params, state, fb)
    for f in zip(*fb):
        state = policy.update(params, state, Feedback(*f))
    return state
