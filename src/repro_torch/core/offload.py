"""DuplexOffloadEngine — co-scheduled host↔HBM transfer planning.

Port of ``repro/core/offload.py``: the planning and billing, pure
Python, with the host-tier ``MIGRATE`` / ``EVACUATE`` transfer records,
the optimizer-state stream plan (``plan_state_stream``) and a plan's
execution on block tensors (``apply_kv_plan``).
The host link is full-duplex: a page-in (host→HBM) and a page-out
(HBM→host) can move concurrently. ``plan_duplex`` co-issues
opposing transfers slot by slot (respecting that an HBM slot's eviction
must finish before its refill), ``plan_serial`` is the phase-separated
baseline, and ``OffloadPlan.modelled_time_us`` integrates either under
the link's channel model. The numbers are plain float arithmetic and
equal the reference's exactly on the same arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core.channel import ChannelModel
from repro_torch.core.hints import HintTree
from repro_torch.core.telemetry import CaxRegistry

PAGE_IN = 0    # host -> HBM  (prefetch / page-in; link "read")
PAGE_OUT = 1   # HBM -> host  (writeback / eviction; link "write")
MIGRATE = 2    # host tier -> host tier (background placement rebalance)
EVACUATE = 3   # emergency off a failing channel (fault recovery, not idle-BW)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One DMA request against the host link."""
    direction: int          # PAGE_IN or PAGE_OUT
    src_block: int          # block index in the source pool
    dst_block: int          # block index in the destination pool
    nbytes: float
    hint_path: str = "/"


@dataclasses.dataclass(frozen=True)
class PlanSlot:
    """One schedule step: transfers co-issued on the full-duplex link."""
    page_in: Transfer | None
    page_out: Transfer | None

    def nbytes(self) -> tuple[float, float]:
        return (self.page_in.nbytes if self.page_in else 0.0,
                self.page_out.nbytes if self.page_out else 0.0)


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    slots: tuple[PlanSlot, ...]
    link: ChannelModel
    policy: str                     # "duplex" | "serial"

    def modelled_time_us(self) -> float:
        """Integrate slot times under the link's duplex capability."""
        rbw, wbw = self.link.direction_bw(sequential=True)
        r_bps = rbw * channel_lib.BYTES_PER_GB
        w_bps = wbw * channel_lib.BYTES_PER_GB
        kappa = self.link.duplex_coupling if self.link.duplex else 0.0
        total = 0.0
        for slot in self.slots:
            rb, wb = slot.nbytes()
            tr, tw = rb / r_bps, wb / w_bps
            total += max(tr, tw) + (1.0 - kappa) * min(tr, tw)
        return total * 1e6

    def total_bytes(self) -> tuple[float, float]:
        rb = sum(s.nbytes()[0] for s in self.slots)
        wb = sum(s.nbytes()[1] for s in self.slots)
        return rb, wb


def channel_time_us(channel: ChannelModel, read_bytes: float,
                    write_bytes: float, sequential: bool = True) -> float:
    """Modelled completion time (us) of co-issued traffic on one channel:
    the effective-bandwidth curve inverted into a completion time."""
    total = read_bytes + write_bytes
    if total <= 0.0:
        return 0.0
    r = read_bytes / total
    gbps = channel_lib.effective_bandwidth_scalar(channel, r, sequential)
    return total / (gbps * channel_lib.BYTES_PER_GB) * 1e6


def phase_separated_time_us(channel: ChannelModel, read_bytes: float,
                            write_bytes: float,
                            sequential: bool = True) -> float:
    """Phase-separated serial baseline on one channel: every read, then
    every write, each at full direction rate."""
    br, bw = channel.direction_bw(sequential)
    t = (read_bytes / (br * channel_lib.BYTES_PER_GB)
         + write_bytes / (bw * channel_lib.BYTES_PER_GB))
    return t * 1e6


def migration_transfers(blocks: Sequence[int], src_slots: Sequence[int],
                        dst_slots: Sequence[int], block_bytes: float,
                        hint_path: str = "/serve/tier_migrate"
                        ) -> list[Transfer]:
    """Describe host-tier rebalance moves as ``MIGRATE`` transfers.

    ``src_slots``/``dst_slots`` are global host-slot indices (the tiered
    pool's slot namespace); a migration reads the source channel and
    writes the destination channel, and the tiered pool schedules it
    into the idle minor direction of the CXL link it touches.
    """
    if not (len(blocks) == len(src_slots) == len(dst_slots)):
        raise ValueError("each migrated block needs a src and dst slot")
    return [Transfer(MIGRATE, src_block=int(s), dst_block=int(d),
                     nbytes=block_bytes, hint_path=hint_path)
            for s, d in zip(src_slots, dst_slots)]


def evacuation_transfers(blocks: Sequence[int], src_slots: Sequence[int],
                         dst_slots: Sequence[int], block_bytes: float,
                         hint_path: str = "/serve/evacuate"
                         ) -> list[Transfer]:
    """Describe emergency channel-evacuation moves as ``EVACUATE``
    transfers. Same slot-namespace contract as ``migration_transfers``,
    but these are fault-recovery traffic: the tiered pool bills them
    immediately into the dying channel's read leg and the survivors'
    write legs rather than scheduling them into idle minor-direction
    bandwidth."""
    if not (len(blocks) == len(src_slots) == len(dst_slots)):
        raise ValueError("each evacuated block needs a src and dst slot")
    return [Transfer(EVACUATE, src_block=int(s), dst_block=int(d),
                     nbytes=block_bytes, hint_path=hint_path)
            for s, d in zip(src_slots, dst_slots)]


def _slot_dependencies(page_ins: Sequence[Transfer],
                       page_outs: Sequence[Transfer]) -> dict[int, int]:
    """Map page-in index -> page-out index it must follow (same HBM slot)."""
    out_by_hbm_block = {t.src_block: j for j, t in enumerate(page_outs)}
    deps = {}
    for i, t in enumerate(page_ins):
        j = out_by_hbm_block.get(t.dst_block)
        if j is not None:
            deps[i] = j
    return deps


def plan_duplex(page_ins: Sequence[Transfer], page_outs: Sequence[Transfer],
                link: ChannelModel) -> OffloadPlan:
    """Interleave opposing-direction transfers so both link directions run.

    Page-outs whose slot a page-in awaits go first (ordered by their
    dependent's index), then page-ins are zipped against the remaining
    page-outs, each no earlier than its dependency (greedy list
    scheduling; optimal for equal-size blocks)."""
    deps = _slot_dependencies(page_ins, page_outs)
    gating = sorted(set(deps.values()),
                    key=lambda j: min(i for i, d in deps.items() if d == j))
    out_order = gating + [j for j in range(len(page_outs))
                          if j not in deps.values()]

    slots: list[PlanSlot] = []
    out_done: set[int] = set()
    in_cursor = 0
    oi = 0
    while in_cursor < len(page_ins) or oi < len(out_order):
        out_t = None
        if oi < len(out_order):
            out_t = page_outs[out_order[oi]]
        in_t = None
        if in_cursor < len(page_ins):
            need = deps.get(in_cursor)
            if need is None or need in out_done:
                in_t = page_ins[in_cursor]
        slots.append(PlanSlot(page_in=in_t, page_out=out_t))
        if out_t is not None:
            out_done.add(out_order[oi])
            oi += 1
        if in_t is not None:
            in_cursor += 1
    return OffloadPlan(tuple(slots), link, "duplex")


def plan_serial(page_ins: Sequence[Transfer], page_outs: Sequence[Transfer],
                link: ChannelModel) -> OffloadPlan:
    """Phase-separated baseline: all evictions, then all prefetches."""
    slots = [PlanSlot(page_in=None, page_out=t) for t in page_outs]
    slots += [PlanSlot(page_in=t, page_out=None) for t in page_ins]
    return OffloadPlan(tuple(slots), link, "serial")


def validate_plan(plan: OffloadPlan) -> None:
    """Raise if any page-in starts before its slot's eviction completed."""
    freed: set[int] = set()
    pending_out = {s.page_out.src_block for s in plan.slots if s.page_out}
    for k, slot in enumerate(plan.slots):
        if slot.page_in is not None:
            dst = slot.page_in.dst_block
            if dst in pending_out and dst not in freed:
                raise ValueError(
                    f"slot {k}: page-in into HBM block {dst} before its "
                    f"eviction was scheduled")
        if slot.page_out is not None:
            freed.add(slot.page_out.src_block)


def apply_kv_plan(hbm_pool: torch.Tensor, host_pool: torch.Tensor,
                  plan: OffloadPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute a paging plan on (hbm_pool, host_pool) block tensors.

    Pools are ``(num_blocks, ...block shape)``; the inputs are not
    written (new tensors are returned, as the reference's ``.at[].set``
    returns new arrays). The result does not depend on the plan's order
    given its dependency constraints: the duplex and serial plans
    produce identical pools.
    """
    validate_plan(plan)
    hbm_pool, host_pool = hbm_pool.clone(), host_pool.clone()
    for slot in plan.slots:
        # page-out first within a slot: eviction logically precedes refill.
        if slot.page_out is not None:
            t = slot.page_out
            host_pool[t.dst_block] = hbm_pool[t.src_block]
        if slot.page_in is not None:
            t = slot.page_in
            hbm_pool[t.dst_block] = host_pool[t.src_block]
    return hbm_pool, host_pool


@dataclasses.dataclass
class DuplexOffloadEngine:
    """Plans host↔HBM traffic for a job, honoring its hint tree.

    A hint scope with ``duplex_opt_in=False`` forces serial planning for
    that scope — the paper's intervention-withdrawal mechanism.
    """

    link: ChannelModel = channel_lib.PCIE_HOST
    hints: HintTree = dataclasses.field(default_factory=HintTree)
    telemetry: CaxRegistry | None = None

    def _record(self, plan: OffloadPlan, path: str) -> None:
        if self.telemetry is not None:
            rb, wb = plan.total_bytes()
            self.telemetry.attribute(path, read_bytes=rb, write_bytes=wb)

    def plan_kv_paging(self, *, needed_host_blocks: Sequence[int],
                       evict_hbm_blocks: Sequence[int],
                       free_hbm_blocks: Sequence[int],
                       host_dst_blocks: Sequence[int],
                       block_bytes: float,
                       hint_path: str = "/serve/kv_cache") -> OffloadPlan:
        """Page ``needed_host_blocks`` in; write ``evict_hbm_blocks`` out.

        HBM destinations are ``free_hbm_blocks`` first, then the slots vacated
        by evictions (creating the cross-direction dependencies the planner
        must respect). ``host_dst_blocks`` receive the evicted data.
        """
        if len(evict_hbm_blocks) != len(host_dst_blocks):
            raise ValueError("each eviction needs a host destination block")
        dst_slots = list(free_hbm_blocks) + list(evict_hbm_blocks)
        if len(needed_host_blocks) > len(dst_slots):
            raise ValueError(
                f"{len(needed_host_blocks)} page-ins but only "
                f"{len(dst_slots)} HBM slots (free + evicted)")
        page_ins = [
            Transfer(PAGE_IN, src_block=src, dst_block=dst_slots[i],
                     nbytes=block_bytes, hint_path=hint_path + "/page_in")
            for i, src in enumerate(needed_host_blocks)
        ]
        page_outs = [
            Transfer(PAGE_OUT, src_block=src, dst_block=host_dst_blocks[i],
                     nbytes=block_bytes, hint_path=hint_path + "/page_out")
            for i, src in enumerate(evict_hbm_blocks)
        ]
        resolved = self.hints.resolve(hint_path).resolved()
        planner = plan_duplex if resolved.duplex_opt_in else plan_serial
        plan = planner(page_ins, page_outs, self.link)
        validate_plan(plan)
        self._record(plan, hint_path)
        return plan

    def plan_state_stream(self, *, nbytes: float, chunk_bytes: float,
                          hint_path: str = "/train/opt_offload"
                          ) -> tuple[OffloadPlan, OffloadPlan]:
        """Optimizer-state streaming: read m,v chunk k while writing back k-1.

        Returns (duplex_plan, serial_plan) for the same byte volume — a
        perfectly balanced 50/50 mix, the paper's best case (Obs 1).
        """
        n = max(1, math.ceil(nbytes / chunk_bytes))
        ins = [Transfer(PAGE_IN, i, i, min(chunk_bytes, nbytes - i * chunk_bytes),
                        hint_path) for i in range(n)]
        outs = [Transfer(PAGE_OUT, i, i, ins[i].nbytes, hint_path)
                for i in range(n)]
        # software pipeline: writeback of chunk i pairs with prefetch of i+1.
        slots = [PlanSlot(page_in=ins[0], page_out=None)]
        slots += [PlanSlot(page_in=ins[i + 1], page_out=outs[i])
                  for i in range(n - 1)]
        slots += [PlanSlot(page_in=None, page_out=outs[n - 1])]
        duplex = OffloadPlan(tuple(slots), self.link, "duplex")
        serial = plan_serial(ins, outs, self.link)
        self._record(duplex, hint_path)
        return duplex, serial

    def speedup(self, duplex: OffloadPlan, serial: OffloadPlan) -> float:
        return serial.modelled_time_us() / max(duplex.modelled_time_us(), 1e-9)
