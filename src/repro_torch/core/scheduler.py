"""DuplexScheduler — the co-scheduling simulation engine (CXLAimPod §4-§5).

Port of ``repro/core/scheduler.py``. A discrete-time (1 us/step)
simulation of a set of traffic streams sharing one memory channel:

  state_t = (per-stream program progress, channel state, policy state)
  1. each stream's program (its arrival tape) has issued ``CR/CW[t+1]``
     bytes so far; what it has not executed is its backlog;
  2. ``policy.schedule`` assigns run weights w (CPU-slot shares), hardened
     to the top ``n_slots`` streams when ``discrete_slots``;
  3. running streams execute their next program segment in program order,
     split by the segment's read/write composition;
  4. the channel (``channel.channel_step``) moves what its duplex or
     half-duplex capacity allows; a *migration tax* proportional to the
     weight reallocation is charged against capacity;
  5. moved bytes are rationed back to streams pro rata; ``policy.update``
     receives the feedback.

The reference jits the whole run as one ``lax.scan``. Here the tapes are
generated on the host (``core.requests.generate``, numpy), their prefix
sums taken on the host in the reference's summation order, and both are
copied to the simulation's device once. Every step is then torch
operations on that device with no value read back: the step index is a
device scalar, the tape rows ``CR[t + 1]`` are taken with
``index_select``, and each step's outputs are written into preallocated
``(T, ...)`` buffers. On a CUDA device a block of ``GRAPH_STEPS`` steps is
captured once as a CUDA graph (warm-up on a side stream, then capture
over static state tensors that the block updates in place) and replayed
``T / GRAPH_STEPS`` times, a shorter tail graph after it; a failed
capture raises. On the CPU the same step runs eagerly, one call a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core import policies as policies_lib
from repro_torch.core import requests as requests_lib
from repro_torch.core.channel import ChannelModel
from repro_torch.core.policies import Policy, PolicyParams
from repro_torch.device import resolve_device, to_device

F32 = torch.float32

#: steps per captured CUDA graph. A step is ~200-450 small kernels, so
#: one replay's launch is already amortized at 16 steps, while capture
#: grows with the block (about 7 ms a step on an H100): 16 replays as
#: fast as 64 or 256 and captures in a fifth of 64's time (PERF.md §5).
GRAPH_STEPS = 16

#: XLA's CPU backend rewrites ``jnp.cumsum`` into reduce-windows over
#: blocks of this many elements, summed recursively (the block totals'
#: own prefix sums added onto each block's running sum).
_CUMSUM_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class SimConfig:
    steps: int = 2048
    drain_rate_factor: float = 2.0   # per-stream CPU drain cap vs offered rate
    migration_tax: float = 0.02      # capacity fraction lost per unit L1 move
    sequential: bool = False
    seed: int = 0
    # Discrete CPU slots: each of the n_slots "cores" runs exactly ONE
    # stream per step (the paper's setting). False = idealized processor
    # sharing (every stream runs fractionally; kept as an ablation).
    discrete_slots: bool = True
    # Closed loop (the paper's saturation benchmarks): each stream is a
    # byte TAPE consumed at drain rate whenever scheduled. False = open
    # loop: requests arrive on the wall clock.
    closed_loop: bool = True


class SimState(NamedTuple):
    exec_bytes: torch.Tensor     # (S,) program progress per stream (bytes)
    chan: channel_lib.ChannelState
    policy_state: Any
    prev_w: torch.Tensor         # (S,)
    prev_util: torch.Tensor      # scalar


class SimResult(NamedTuple):
    moved_read: torch.Tensor     # (T,) bytes/step
    moved_write: torch.Tensor    # (T,)
    utilization: torch.Tensor    # (T,)
    backlog_total: torch.Tensor  # (T,) bytes outstanding
    weights: torch.Tensor        # (T, S)
    migration: torch.Tensor      # (T,)
    switches: torch.Tensor       # scalar (half-duplex turnarounds charged)

    # -- derived metrics (0-dim tensors on the result's device) -------------
    def achieved_gbps(self) -> torch.Tensor:
        # bytes/us -> GB/s = bytes_per_step * 1e-3
        return torch.mean(self.moved_read + self.moved_write) * 1.0e-3

    def read_gbps(self) -> torch.Tensor:
        return torch.mean(self.moved_read) * 1.0e-3

    def write_gbps(self) -> torch.Tensor:
        return torch.mean(self.moved_write) * 1.0e-3

    def mean_backlog_bytes(self) -> torch.Tensor:
        return torch.mean(self.backlog_total)

    def p99_backlog_bytes(self) -> torch.Tensor:
        # ``jnp.percentile``'s default: linear interpolation
        return torch.quantile(self.backlog_total, 0.99)

    def mean_latency_us(self) -> torch.Tensor:
        """Little's law: L = lambda * W  =>  W = backlog / throughput."""
        thr = torch.clamp(torch.mean(self.moved_read + self.moved_write),
                          min=1e-9)
        return torch.mean(self.backlog_total) / thr

    def p99_latency_us(self) -> torch.Tensor:
        thr = torch.clamp(torch.mean(self.moved_read + self.moved_write),
                          min=1e-9)
        return self.p99_backlog_bytes() / thr


def _prefix_sums(x: np.ndarray) -> np.ndarray:
    """float32 prefix sums along axis 0 in the order the reference's
    ``jnp.cumsum`` adds (``_CUMSUM_BLOCK``): sequential within a block,
    then each block's total carried in from the prefix sums of the block
    totals. A sequential float32 sum differs in the last bits once the
    sums pass 2^24."""
    n, b = x.shape[0], _CUMSUM_BLOCK
    if n <= b:
        return np.cumsum(x, 0, dtype=np.float32)
    pad = np.zeros((-n % b,) + x.shape[1:], np.float32)
    rows = np.concatenate([x, pad]).reshape((-1, b) + x.shape[1:])
    inner = np.cumsum(rows, 1, dtype=np.float32)
    carry = _prefix_sums(inner[:, -1])
    carry = np.concatenate([np.zeros_like(carry[:1]), carry[:-1]])
    return (inner + carry[:, None]).reshape((-1,) + x.shape[1:])[:n]


def _interp(cr_t: torch.Tensor, cw_t: torch.Tensor, ct_t: torch.Tensor,
            e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Piecewise-linear values of the cumulative read and write tapes at
    executed-byte position ``e`` — the reference's ``_interp_columns``
    for both directions at once.

    cr_t, cw_t, ct_t: (S, T+1) per-stream prefix sums (read / write /
    total), one row a stream; e: (S,). Within a step, arrivals are
    consumed at that step's r/w composition — program order.
    """
    j = torch.searchsorted(ct_t, e[:, None], right=True) - 1
    j = torch.clamp(j, 0, ct_t.shape[1] - 2)
    j1 = j + 1
    ct0 = ct_t.gather(1, j)
    seg = ct_t.gather(1, j1) - ct0
    frac = torch.where(seg > 0, (e[:, None] - ct0)
                       / torch.clamp(seg, min=1e-9), 0.0)
    frac = torch.clamp(frac, 0.0, 1.0)
    out = []
    for c in (cr_t, cw_t):
        c0 = c.gather(1, j)
        out.append((c0 + frac * (c.gather(1, j1) - c0))[:, 0])
    return out[0], out[1]


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


class _Scan:
    """One simulation's device tensors and its step. ``state`` and ``t``
    are the static tensors the step updates in place; ``outs`` the
    preallocated per-step outputs."""

    def __init__(self, channel: ChannelModel, specs, policy: Policy,
                 params: PolicyParams, sim: SimConfig,
                 device: torch.device):
        self.policy, self.params, self.sim = policy, params, sim
        self.device = device
        T = int(sim.steps)
        S = len(specs)
        self.T, self.S = T, S
        # closed loop: the tape extends past the horizon so leaders can
        # run ahead of the wall clock (the drain cap bounds how far).
        tape_steps = (int(sim.steps * (sim.drain_rate_factor + 1.0))
                      if sim.closed_loop else sim.steps)
        arrivals = requests_lib.generate(specs, tape_steps, sim.seed)
        zero = np.zeros((1, S, 2), np.float32)
        cum = np.concatenate([zero, _prefix_sums(arrivals)])
        cr, cw = cum[:, :, 0], cum[:, :, 1]
        ct = cr + cw                                    # (tape+1, S)
        dev = device

        def put(a, dtype=None):
            return to_device(np.ascontiguousarray(a, dtype), dev)

        self.arr = put(arrivals[:T])                    # (T, S, 2)
        self.cr, self.cw, self.ct = put(cr), put(cw), put(ct)   # CR[t+1]..
        self.cr_t, self.cw_t, self.ct_t = put(cr.T), put(cw.T), put(ct.T)
        offered = np.asarray([s.offered_gbps * 1e3 for s in specs],
                             np.float32)
        self.drain_caps = put(offered * np.float32(sim.drain_rate_factor))
        self.hint_rf = put(requests_lib.hint_read_fractions(specs))
        self.hint_priority = put(np.asarray(
            [s.resolved_hint().resolved().priority for s in specs],
            np.float32))
        self.hint_opt_in = put(np.asarray(
            [s.resolved_hint().resolved().duplex_opt_in for s in specs],
            bool))
        opt = channel_lib.duplex_benefit(channel, sim.sequential)
        self.opt_r = torch.full((), opt["peak_read_fraction"], dtype=F32,
                                device=dev)
        self.cp = channel_lib.channel_params(channel, sim.sequential, dev)
        self.duplex = torch.full((), self.cp.duplex, dtype=torch.bool,
                                 device=dev)
        self.cap_total = self.cp.read_cap + self.cp.write_cap
        self.ct_end = self.ct[-1]
        # discrete slots: the step's rotating tie-break, one row a phase
        rot = (np.arange(S)[None, :] + np.arange(S)[:, None]) % S
        self.eps_rows = put(np.float32(1e-6) * (rot.astype(np.float32)
                                                / np.float32(S)))
        self.k = max(1, min(S, int(params.n_slots)))

        self.state = self.fresh_state()
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.outs = {
            "moved_read": torch.zeros((T,), dtype=F32, device=dev),
            "moved_write": torch.zeros((T,), dtype=F32, device=dev),
            "utilization": torch.zeros((T,), dtype=F32, device=dev),
            "backlog_total": torch.zeros((T,), dtype=F32, device=dev),
            "weights": torch.zeros((T, S), dtype=F32, device=dev),
            "migration": torch.zeros((T,), dtype=F32, device=dev),
        }

    def fresh_state(self) -> SimState:
        dev = self.device
        return SimState(
            exec_bytes=torch.zeros((self.S,), dtype=F32, device=dev),
            chan=channel_lib.init_channel_state(dev),
            policy_state=self.policy.init(self.params, self.S, device=dev),
            prev_w=torch.zeros((self.S,), dtype=F32, device=dev),
            prev_util=torch.zeros((), dtype=F32, device=dev),
        )

    def reset(self) -> None:
        """Put the static state and the step index back to step 0."""
        for dst, src in zip(_leaves(self.state), _leaves(self.fresh_state())):
            dst.copy_(src)
        self.t.zero_()

    def step(self) -> None:
        """Step ``t``: read the static state, write step ``t``'s outputs
        and the new state in place, advance ``t``. No value is read back."""
        sim, params, policy = self.sim, self.params, self.policy
        state, t = self.state, self.t
        row = t.reshape(1)
        nxt = row + 1
        arr = self.arr.index_select(0, row)[0]                    # (S, 2)
        cr_next = self.cr.index_select(0, nxt)[0]
        cw_next = self.cw.index_select(0, nxt)[0]
        ct_next = self.ct.index_select(0, nxt)[0]
        e = state.exec_bytes
        exec_bound = self.ct_end if sim.closed_loop else ct_next
        # what each stream's program has issued so far but not executed
        done_r, done_w = _interp(self.cr_t, self.cw_t, self.ct_t, e)
        backlog_r = torch.clamp(cr_next - done_r, min=0.0)
        backlog_w = torch.clamp(cw_next - done_w, min=0.0)

        # head-of-line program segment (what runs next if dispatched)
        e_head = torch.minimum(e + self.drain_caps, exec_bound)
        head_r, head_w = _interp(self.cr_t, self.cw_t, self.ct_t, e_head)
        head_r, head_w = head_r - done_r, head_w - done_w
        if sim.closed_loop:
            # closed loop: a worker always has its tape to run
            backlog_r = torch.maximum(backlog_r, head_r)
            backlog_w = torch.maximum(backlog_w, head_w)

        obs = policies_lib.Obs(
            step=t.to(torch.int32),
            backlog_read=backlog_r,
            backlog_write=backlog_w,
            arrival_read=arr[:, 0],
            arrival_write=arr[:, 1],
            head_read=head_r,
            head_write=head_w,
            prev_weights=state.prev_w,
            prev_util=state.prev_util,
            opt_r=self.opt_r,
            duplex=self.duplex,
            hint_rf=self.hint_rf,
            hint_priority=self.hint_priority,
            hint_opt_in=self.hint_opt_in,
        )
        pstate, w = policy.schedule(params, state.policy_state, obs)

        if sim.discrete_slots:
            # hard dispatch: the top n_slots streams by policy weight run
            # this step; a rotating epsilon breaks ties deterministically
            active = (backlog_r + backlog_w) > 0.0
            eps = self.eps_rows.index_select(0, row % self.S)[0]
            w_eff = torch.where(active, w + eps, -1.0)
            kth = torch.topk(w_eff, self.k).values[-1]
            w = ((w_eff >= kth) & active).to(F32)

        # running streams execute their next program segment (in order)
        budget = w * self.drain_caps
        e_try = torch.minimum(e + budget, exec_bound)
        want_r, want_w = _interp(self.cr_t, self.cw_t, self.ct_t, e_try)
        want_r, want_w = want_r - done_r, want_w - done_w

        # migration tax: reallocating run slots disrupts caches, modelled
        # as a transient loss of channel capacity this step
        mig = policies_lib.migration_volume(state.prev_w, w)
        tax = torch.clamp(1.0 - sim.migration_tax * mig, 0.5, 1.0)

        sum_r, sum_w = torch.sum(want_r), torch.sum(want_w)
        chan, moved_r_tot, moved_w_tot = channel_lib.channel_step(
            self.cp, state.chan, sum_r * tax, sum_w * tax)

        # ration actual service back to streams pro rata to demand
        ratio_r = moved_r_tot / torch.clamp(sum_r, min=1e-9)
        ratio_w = moved_w_tot / torch.clamp(sum_w, min=1e-9)
        moved_r = want_r * torch.clamp(ratio_r, max=1.0)
        moved_w = want_w * torch.clamp(ratio_w, max=1.0)
        e_new = torch.minimum(e + moved_r + moved_w, exec_bound)

        total_backlog = torch.sum(torch.clamp(ct_next - e_new, min=0.0))
        chan_util = (moved_r_tot + moved_w_tot) / torch.clamp(
            self.cap_total, min=1e-9)
        # Algorithm 1's oversubscription test uses *CPU* utilization
        # (running slots / cores), not channel utilization.
        cpu_util = torch.sum(w) / params.n_slots
        pstate = policy.update(params, pstate, policies_lib.Feedback(
            moved_r, moved_w, cpu_util))

        new = SimState(e_new, chan, pstate, w, cpu_util)
        for dst, src in zip(_leaves(state), _leaves(new)):
            dst.copy_(src)
        for key, val in (("moved_read", moved_r_tot),
                         ("moved_write", moved_w_tot),
                         ("utilization", chan_util),
                         ("backlog_total", total_backlog),
                         ("weights", w), ("migration", mig)):
            buf = self.outs[key]
            buf.index_copy_(0, row, val.reshape((1,) + buf.shape[1:]))
        t.add_(1)

    def result(self) -> SimResult:
        o = self.outs
        return SimResult(o["moved_read"], o["moved_write"],
                         o["utilization"], o["backlog_total"],
                         o["weights"], o["migration"],
                         self.state.chan.switches)


class ScanGraphs:
    """A ``_Scan``'s steps as CUDA graphs: one of ``GRAPH_STEPS`` steps and
    one of the remainder, captured over the scan's static tensors (after a
    warm-up step on a side stream, undone by ``reset``)."""

    def __init__(self, scan: _Scan, block: int = GRAPH_STEPS):
        self.scan = scan
        self.block = max(1, min(block, scan.T))
        self.n_full, tail = divmod(scan.T, self.block)
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            scan.step()
        torch.cuda.current_stream().wait_stream(side)
        scan.reset()
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        for n in (self.block, tail):
            if not n:
                continue
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                for _ in range(n):
                    scan.step()
            self.graphs.append(graph)
        # capture records the steps without running them: the state and
        # step index are as reset left them
        self.capture_s = time.perf_counter() - t0

    def run(self) -> None:
        for _ in range(self.n_full):
            self.graphs[0].replay()
        if len(self.graphs) > 1:
            self.graphs[1].replay()


def simulate(channel: ChannelModel,
             specs: list[requests_lib.StreamSpec],
             policy: Policy | str,
             params: PolicyParams | None = None,
             sim: SimConfig | None = None, *,
             device: torch.device | str = "cuda",
             _graphs: bool | None = None) -> SimResult:
    """Run one policy over one channel for a list of stream specs, on
    ``device`` (``cuda`` unless the caller asks for the CPU). The result's
    series are tensors on that device.

    ``_graphs`` is private: None (the default) replays CUDA graphs of the
    steps on a CUDA device and steps eagerly on the CPU; False steps
    eagerly on either (the on-card comparison of the two)."""
    if isinstance(policy, str):
        policy = policies_lib.get_policy(policy)
    params = params or PolicyParams()
    sim = sim or SimConfig()
    dev = resolve_device(device)
    scan = _Scan(channel, specs, policy, params, sim, dev)
    if _graphs is None:
        _graphs = dev.type == "cuda"
    if _graphs:
        if dev.type != "cuda":
            raise ValueError("the simulator's step graphs need a CUDA "
                             "device")
        ScanGraphs(scan).run()
    else:
        for _ in range(scan.T):
            scan.step()
    return scan.result()


def summarize(res: SimResult) -> dict:
    """One result as ``compare_policies`` reports it (host floats)."""
    return {
        "gbps": float(res.achieved_gbps()),
        "read_gbps": float(res.read_gbps()),
        "write_gbps": float(res.write_gbps()),
        "mean_latency_us": float(res.mean_latency_us()),
        "p99_latency_us": float(res.p99_latency_us()),
        "switches": int(res.switches),
        "migration": float(torch.sum(res.migration)),
    }


def compare_policies(channel: ChannelModel,
                     specs: list[requests_lib.StreamSpec],
                     policy_names: tuple[str, ...] = ("cfs", "timeseries"),
                     params: PolicyParams | None = None,
                     sim: SimConfig | None = None, *,
                     device: torch.device | str = "cuda") -> dict[str, dict]:
    """A/B harness: run several policies on identical arrivals and report."""
    return {name: summarize(simulate(channel, specs, name, params, sim,
                                     device=device))
            for name in policy_names}


def improvement(results: dict[str, dict], test: str = "timeseries",
                base: str = "cfs", metric: str = "gbps") -> float:
    return results[test][metric] / max(results[base][metric], 1e-9) - 1.0
