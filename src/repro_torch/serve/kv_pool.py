"""Vectorized tiered KV block pool — the serving memory hierarchy.

Port of ``PagedKVPool`` of ``repro/serve/kv_pool.py``. One pool is shared
by every request in the batch:

  * residency, the slot map and the LRU clocks are **host numpy** arrays
    (``slot_of``, ``block_at``, ``last_use``): they never feed device
    compute, so victim picking, invariant checks and the engine's
    write-through read them on the host;
  * the HBM working set (``hbm``, bf16) and the int8 host tier
    (``host_q`` + per-row ``host_scale``) are tensors on the pool's
    device. The host tier is on the card, as in the reference: link
    timing is modelled, not measured;
  * ``step_multi`` makes a step's whole block demand resident in one
    transaction: ONE ``DuplexOffloadEngine`` plan per hint scope and ONE
    kernel launch per scope — the fused ``duplex_kv_stream`` when both
    directions carry blocks, or the single-direction dequant-only /
    quant-only half when one stream is empty;
  * ``tiers`` backs the host side with heterogeneous DDR5/CXL channels
    (``serve/tiers.py``): hint-driven placement, per-channel billing,
    ``tier_speedup`` and boundary migrations (``migrate_tiers``);
  * ``faults`` attaches a ``core.faults.FaultInjector``: checksums
    stamped at page-out and verified at page-in, poisoned slots
    quarantined, offline channels evacuated.

Where the reference donates the tier buffers to a jitted commit and
rebinds them, the port updates them in place (``index_copy_``), so the
tensors stay the same objects a captured CUDA graph may read. The
reference's ``mode="drop"`` scatters silently drop out-of-range sentinel
rows; the port drops them explicitly on the host before indexing.
``attach_trace`` lays each billed transaction's per-channel busy
intervals on a ``serve.trace.Tracer``'s modelled clock (host arithmetic
only). ``flush_dirty`` (the snapshot cut's durability barrier, billed and
traced as ``"flush"``, through the ``quant_stream`` kernel) and
``snapshot_state`` / ``load_state`` serve ``serve.snapshot``; a restore
copies into the tier tensors in place too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core.hints import HintTree, default_serving_hints
from repro_torch.core.offload import (DuplexOffloadEngine, plan_serial,
                                      phase_separated_time_us)
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve.tiers import TieredHostPool


def _fresh_stats() -> dict:
    return {"page_ins": 0, "page_outs": 0, "duplex_us": 0.0,
            "serial_us": 0.0, "kernel_calls": 0, "steps": 0,
            "tier_us": 0.0, "ddr5_us": 0.0, "migrations": 0,
            "migrate_us": 0.0, "by_path": {}}


def _fresh_path_stats() -> dict:
    return {"page_ins": 0, "page_outs": 0, "duplex_us": 0.0,
            "serial_us": 0.0, "fused_calls": 0}


#: staging depth of the fused duplex kernel's streams: both are
#: zero-padded up to a multiple of it, and the padding is dropped at
#: commit (the reference's double-buffer granularity; kept so the
#: streams, and the billing, have the reference's shapes).
STAGE_BLOCKS = 2

#: most host-tier migrations one megastep boundary plans (the
#: reference's default ``migrate_max``).
MIGRATE_MAX = 8


def _pad_rows(a: torch.Tensor, m: int) -> torch.Tensor:
    if a.shape[0] == m:
        return a
    fill = torch.zeros((m - a.shape[0],) + tuple(a.shape[1:]),
                       dtype=a.dtype, device=a.device)
    return torch.cat([a, fill])


class PagedKVPool:
    """Block-table KV pool: HBM working set + tiered int8 host side.

    ``n_blocks`` logical blocks of ``block_shape = (tokens, kv_dims)``;
    at most ``hbm_blocks`` are HBM-resident at a time. Logical block ids are
    allocated per request (``alloc``/``free``) or caller-managed. The
    tensors live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``).

    ``tiers`` backs the host side with heterogeneous memory channels
    (``serve.tiers.TieredHostPool``): a ``"ddr5:2,cxl:2"`` spec string or
    a (kind, ChannelModel) sequence. Spilled blocks get a host *slot*
    through the hint-driven weighted-interleave placement map, traffic is
    billed per channel, ``tier_speedup()`` compares against the all-DDR5
    serial counterfactual, and ``migrate_tiers()`` (called by the engine
    at megastep boundaries) rebalances mismatched blocks through the idle
    minor direction of the CXL links. ``tiers=None`` is the flat
    single-channel pool with identity placement.
    """

    def __init__(self, n_blocks: int, hbm_blocks: int, block_shape,
                 hints: HintTree | None = None,
                 link: channel_lib.ChannelModel = channel_lib.PCIE_HOST,
                 tiers=None, faults=None,
                 device: torch.device | str = "cuda"):
        if hbm_blocks < 1:
            raise ValueError("need at least one HBM block")
        self.device = resolve_device(device)
        self.n_blocks = n_blocks
        self.hbm_capacity = hbm_blocks
        self.block_shape = tuple(block_shape)        # (tokens, kv_dims)
        block_bytes = float(np.prod(self.block_shape) * 2)  # bf16
        if tiers is None:
            self.host = TieredHostPool.flat(n_blocks, link, block_bytes)
        else:
            self.host = TieredHostPool.from_spec(n_blocks, tiers,
                                                 block_bytes)
        self.tiered = self.host.tiered
        self.hbm = torch.zeros((hbm_blocks,) + self.block_shape,
                               dtype=torch.bfloat16, device=self.device)
        self.host_q = torch.zeros((self.host.total_slots,)
                                  + self.block_shape, dtype=torch.int8,
                                  device=self.device)
        self.host_scale = torch.ones((self.host.total_slots,
                                      self.block_shape[0], 1),
                                     dtype=torch.float32, device=self.device)
        # block table (host-resident residency metadata)
        self.slot_of = np.full((n_blocks,), -1, np.int32)    # block -> slot
        self.block_at = np.full((hbm_blocks,), -1, np.int32)  # slot -> block
        self.last_use = np.zeros((n_blocks,), np.int64)      # LRU clock
        self._clock = 0
        self._allocated = np.zeros((n_blocks,), bool)
        # blocks whose HBM copy is newer than host_q (dirty after write(),
        # clean after the eviction that quantizes it out) — evicting a
        # clean or never-written block carries no data and bills nothing.
        self._dirty = np.zeros((n_blocks,), bool)
        # blocks whose host_q copy is real (written by an eviction)
        self._has_host = np.zeros((n_blocks,), bool)
        self.engine = DuplexOffloadEngine(
            link=link, hints=hints or default_serving_hints())
        self.stats = _fresh_stats()
        # fault injection (core.faults.FaultInjector). With no injector
        # attached none of the fault machinery exists: no checksum
        # arrays, no per-transaction tick, no branch past one ``is None``.
        self._fx = faults
        self._trace = None            # serve.trace.Tracer, when attached
        self._trace_prefix = ""
        self._csum_data = self._csum_stamp = None
        self._stamp = 0
        if faults is not None:
            self.host.attach_faults(faults)
            # per-block host-copy checksums (host numpy), stamped at
            # page-out and verified at page-in (modelled: a poison bumps
            # _csum_data so the verify mismatches, like a real CRC).
            self._csum_data = np.zeros((n_blocks,), np.int64)
            self._csum_stamp = np.zeros((n_blocks,), np.int64)

    def _idx(self, ids) -> torch.Tensor:
        """Host index array -> int64 index tensor on the pool's device."""
        return to_device(np.asarray(ids, np.int64).reshape(-1), self.device)

    def attach_trace(self, tracer, prefix: str = "") -> None:
        """Attach a ``serve.trace.Tracer``: every billed transaction
        (paging, migrations, evacuations) additionally lays per-channel
        per-direction busy intervals on its modelled clock. ``prefix``
        namespaces the channel tracks."""
        self._trace = tracer
        self._trace_prefix = prefix
        self.host.attach_trace(tracer, prefix)

    def attach_telemetry(self, registry) -> None:
        """Route CAX scope attribution into ``registry``: the flat planner
        records through the offload engine; the tiered path (which skips
        plan construction) attributes its byte volumes directly."""
        self.engine.telemetry = registry

    def _flat_bill_totals(self, read_blocks: int, write_blocks: int,
                          busy_us: float) -> None:
        """Mirror one transaction into the single channel's totals, so
        ``tier_stats()`` reports the reference's schema."""
        t = self.host.totals[0]
        bb = self.host.block_bytes
        t["page_in_blocks"] += read_blocks
        t["page_out_blocks"] += write_blocks
        t["read_bytes"] += read_blocks * bb
        t["write_bytes"] += write_blocks * bb
        t["busy_us"] += busy_us

    def _flat_trace_txn(self, read_blocks: int, write_blocks: int,
                        duplex_us: float, co_issued: bool,
                        name: str) -> None:
        """Flat-pool twin of the tiered billing's timeline hook: one
        channel, per-direction pure times under the (possibly degraded)
        link model, the transaction's billed time as the advance."""
        link = self.engine.link
        if self._fx is not None:
            factor = self._fx.bandwidth_factor(0)
            if factor < 1.0:
                link = link.degraded(factor)
        bb = self.host.block_bytes
        rd_b, wr_b = read_blocks * bb, write_blocks * bb
        self._trace.channel_transaction(
            [(f"{self._trace_prefix}{self.host.kinds[0]}:0", rd_b, wr_b,
              phase_separated_time_us(link, rd_b, 0.0),
              phase_separated_time_us(link, 0.0, wr_b),
              duplex_us, co_issued)],
            duplex_us, name=name)

    # -- allocation (request lifecycle) ------------------------------------
    def alloc(self, k: int = 1) -> list[int]:
        free = np.flatnonzero(~self._allocated)
        if len(free) < k:
            raise RuntimeError(
                f"KV pool exhausted: {k} blocks requested, "
                f"{len(free)}/{self.n_blocks} free")
        ids = free[:k].tolist()
        self._allocated[ids] = True
        return ids

    def free(self, blocks) -> None:
        """Release logical blocks; drop their residency without writeback."""
        blocks = np.asarray(blocks, np.int32)
        if blocks.size == 0:
            return
        self._allocated[blocks] = False
        self._dirty[blocks] = False
        self._has_host[blocks] = False
        self.host.release(blocks)
        slots = self.slot_of[blocks]
        self.block_at[slots[slots >= 0]] = -1
        self.slot_of[blocks] = -1
        # a reused id must not inherit the old request's recency clock
        self.last_use[blocks] = 0

    def reclaim(self, blocks) -> None:
        """Undo a speculative ``free`` (the engine's pipelined-dispatch
        divergence rollback): re-mark the blocks allocated. Residency,
        host copies and recency are not restored — the blocks come back
        cold, like a fresh ``alloc``."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        if blocks.size == 0:
            return
        taken = blocks[self._allocated[blocks]]
        if taken.size:
            raise RuntimeError(
                f"reclaim of blocks {taken.tolist()} that are already "
                f"allocated — speculative-free journal out of order")
        self._allocated[blocks] = True

    def invalidate(self, blocks) -> None:
        """Declare full-block overwrites: the caller rewrites these blocks
        entirely this step (a batched whole-value SET), so a non-resident
        block's host copy is dead data — it installs fresh instead of
        paging in. Resident blocks are untouched (their overwrite is a
        plain ``write``)."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        if blocks.size == 0:
            return
        nonres = blocks[self.slot_of[blocks] < 0]
        self._has_host[nonres] = False
        self._dirty[nonres] = False
        # the dead host copy's slot is released; the next spill re-places
        # the block.
        self.host.release(nonres)

    # -- residency ---------------------------------------------------------
    def resident_blocks(self) -> np.ndarray:
        return np.flatnonzero(self.slot_of >= 0)

    def is_resident(self, blocks) -> np.ndarray:
        return self.slot_of[np.asarray(blocks, int)] >= 0

    def check_invariants(self) -> None:
        """Raise if the block table is inconsistent."""
        slot_of = self.slot_of
        block_at = self.block_at
        res = np.flatnonzero(slot_of >= 0)
        slots = slot_of[res]
        if len(set(slots.tolist())) != len(slots):
            raise AssertionError("two blocks mapped to one HBM slot")
        if len(res) > self.hbm_capacity:
            raise AssertionError("more resident blocks than HBM slots")
        for b, s in zip(res.tolist(), slots.tolist()):
            if block_at[s] != b:
                raise AssertionError(
                    f"slot map out of sync: slot_of[{b}]={s} but "
                    f"block_at[{s}]={block_at[s]}")
        for s in np.flatnonzero(block_at >= 0).tolist():
            if slot_of[block_at[s]] != s:
                raise AssertionError(f"dangling slot {s}")
        self.host.check_invariants()
        unplaced = np.flatnonzero(self._has_host
                                  & (self.host.slot_of < 0))
        if unplaced.size:
            raise AssertionError(
                f"blocks {unplaced.tolist()} have a host copy but no "
                f"host-tier slot")

    # -- the per-step batched paging transaction ---------------------------
    def step(self, needed, hint_path: str = "/serve/kv_cache") -> dict:
        """Ensure residency for the whole batch's block demand, in one
        transaction (see ``step_multi``)."""
        return self.step_multi([(hint_path, needed)])

    def step_multi(self, groups) -> dict:
        """One paging transaction for a step's demand, grouped by hint
        scope: ``[(hint_path, block_ids), ...]``. Victims are picked
        jointly (no group evicts another group's demand); each group's
        traffic is planned and billed under its own scope — opted-in
        scopes ride the duplex plan and the fused kernel, withdrawn
        scopes (``duplex_opt_in=False``) are planned serially and run
        through the single-direction halves. Brand-new blocks (no host
        copy yet) install into slots directly and bill nothing."""
        seen: set[int] = set()
        per_group: list[tuple[str, np.ndarray]] = []
        for path, ids in groups:
            ids = np.asarray(ids, np.int32).reshape(-1)
            uniq = [int(b) for b in dict.fromkeys(ids.tolist())
                    if int(b) not in seen]
            seen.update(uniq)
            per_group.append((path, np.asarray(uniq, np.int32)))
        all_needed = np.asarray(sorted(seen), np.int32)
        if all_needed.size > self.hbm_capacity:
            raise ValueError(
                f"step demands {all_needed.size} blocks but HBM holds "
                f"{self.hbm_capacity}; cap the per-step working set")
        self.stats["steps"] += 1
        report = {"page_ins": 0, "page_outs": 0}
        if self._fx is not None:
            # quarantined blocks lose _has_host and fall through to the
            # fresh-install path below (zero-filled rows): reads stay
            # legal, the data loss is the modelled consequence, and the
            # engine fails the owning request off this report.
            report.update(self._service_faults(all_needed))
        if all_needed.size:
            n_missing = int((self.slot_of[all_needed] < 0).sum())
            free_slots = np.flatnonzero(self.block_at < 0)
            n_evict = max(0, n_missing - free_slots.size)
            victims = self._pick_victims(n_evict, all_needed)
            fcur = vcur = 0
            for path, ids in per_group:
                if ids.size == 0:
                    continue
                missing = ids[self.slot_of[ids] < 0]
                if missing.size == 0:
                    continue
                stale = missing[self._has_host[missing]]   # real page-ins
                fresh = missing[~self._has_host[missing]]  # first installs
                n_free = min(missing.size, free_slots.size - fcur)
                g_free = free_slots[fcur:fcur + n_free]
                fcur += n_free
                n_vict = missing.size - n_free
                g_vict = victims[vcur:vcur + n_vict]
                vcur += n_vict
                r = self._execute(stale, fresh, g_vict, g_free,
                                  hint_path=path)
                report["page_ins"] += r["page_ins"]
                report["page_outs"] += r["page_outs"]
        self._touch(all_needed)
        return report

    # -- fault servicing (one pass per transaction, injector attached) ------
    def _service_faults(self, all_needed: np.ndarray) -> dict:
        """Advance the fault clock and service armed events: corrupt the
        host copies of newly poisoned blocks, hot-unplug newly offline
        channels (placement write-off + emergency evacuation), and
        verify checksums on every host copy this transaction is about to
        page in — mismatches quarantine the host slot and surface in the
        report for the engine to fail the owning request."""
        fx = self._fx
        fx.tick()
        rep = {"poisoned": [], "offline": [], "casualties": [],
               "evacuated": 0}
        for b in fx.drain_poison():
            if 0 <= b < self.n_blocks and self._has_host[b]:
                self._csum_data[b] += 1     # modelled media corruption
            else:
                fx.rearm_poison(b)          # nothing to corrupt yet
        for c in fx.drain_offline():
            if self.host.identity:
                raise RuntimeError(
                    "offline fault on a flat (single-channel) host pool "
                    "— configure tiers to model channel loss")
            self.host.set_offline(c)
            casualties, moved = self._evacuate_channel(c)
            rep["offline"].append(c)
            rep["casualties"].extend(casualties)
            rep["evacuated"] += moved
        if all_needed.size:
            cand = all_needed[(self.slot_of[all_needed] < 0)
                              & self._has_host[all_needed]]
            bad = cand[self._csum_data[cand] != self._csum_stamp[cand]]
            if bad.size:
                hs = self.host.slot_of[bad]
                self.host.quarantine(hs[hs >= 0])
                self._has_host[bad] = False
                self._dirty[bad] = False
                fx.stats["quarantined"] += int(bad.size)
                rep["poisoned"] = bad.tolist()
        return rep

    def _evacuate_channel(self, c: int) -> tuple[list[int], int]:
        """Move a dying channel's live host rows onto surviving channels
        (``TieredHostPool.evacuate`` picks destinations and bills the
        legs); the data copy is the row move boundary migrations use.
        Blocks with no surviving slot lose their host copy — the engine
        fails their owners off the report. Returns ``(casualty_blocks,
        n_moved)``."""
        mig0 = self.host.migrate_us
        blocks, src, dst, casualties = self.host.evacuate(c)
        # the evacuation legs billed on the host channels also land in
        # the pool-level migration clock tier_stats() reports.
        self.stats["migrate_us"] += self.host.migrate_us - mig0
        n = int(blocks.size)
        if n:
            self._move_rows(src, dst)
        lost = []
        if casualties:
            ca = np.asarray(casualties, np.int32)
            self._has_host[ca] = False
            # HBM-resident casualties still hold valid data on-device:
            # mark them dirty so the next eviction re-writes a host copy
            # (losing the slot, not the bytes). Non-resident casualties
            # ARE data loss — report them so the engine fails the owner.
            resident = ca[self.slot_of[ca] >= 0]
            gone = ca[self.slot_of[ca] < 0]
            self._dirty[resident] = True
            self._dirty[gone] = False
            lost = [int(b) for b in gone]
        self._fx.stats["evacuated"] += n
        self._fx.stats["recovered"] += n
        return lost, n

    def _move_rows(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Copy quantized host rows ``src -> dst`` verbatim (int8 payload
        + scales: moves are bit-exact), in place: the gather completes
        before the scatter, and ``host_q`` / ``host_scale`` stay the same
        tensors. Dispatch only — no device-to-host sync."""
        si, di = self._idx(src), self._idx(dst)
        self.host_q.index_copy_(0, di, self.host_q.index_select(0, si))
        self.host_scale.index_copy_(0, di,
                                    self.host_scale.index_select(0, si))

    def _pick_victims(self, k: int, keep: np.ndarray) -> np.ndarray:
        """k least-recently-used resident blocks outside ``keep``."""
        if k == 0:
            return np.zeros((0,), np.int32)
        evictable = self.slot_of >= 0
        evictable[keep] = False
        cand = np.flatnonzero(evictable)
        if cand.size < k:
            raise RuntimeError(
                f"need {k} evictions but only {cand.size} evictable blocks")
        order = cand[np.argsort(self.last_use[cand], kind="stable")]
        return order[:k].astype(np.int32)

    def _execute(self, stale: np.ndarray, fresh: np.ndarray,
                 victims: np.ndarray, free_slots: np.ndarray,
                 hint_path: str = "/serve/kv_cache") -> dict:
        """Make ``stale + fresh`` resident, evicting ``victims``.

        Only real data moves: ``stale`` blocks (host copies from earlier
        evictions) and *written* victims travel through the plan and the
        kernel pass; ``fresh`` blocks are zero-installed and clean victims
        just drop residency, neither billed.
        """
        victim_slots = self.slot_of[victims]
        outs = victims[self._dirty[victims]]       # real out traffic
        out_slots = self.slot_of[outs]
        silent_slots = self.slot_of[victims[~self._dirty[victims]]]
        block_bytes = self.host.block_bytes
        in_deq = out_q = out_scale = None
        out_hslots = np.zeros((0,), np.int32)
        if stale.size or outs.size:
            resolved = self.engine.hints.resolve(hint_path).resolved()
            duplex_ok = resolved.duplex_opt_in
            pref = self.host.preferred_kind(resolved)
            in_hslots = self.host.place(stale, pref)
            out_hslots = self.host.place(outs, pref, refresh=False)
            if self.tiered:
                # per-channel billing: each channel's share of the
                # transaction under ITS model (half-duplex DDR5 with
                # turnaround, duplex-overlapped CXL), channels parallel;
                # plus the all-DDR5 serial counterfactual tier_speedup
                # measures against. (The flat pool's plan construction is
                # skipped: its modelled times would be discarded.)
                ch_rd, ch_wr, duplex_us, serial_us = \
                    self.host.bill_transaction(in_hslots, out_hslots,
                                               co_issued=bool(duplex_ok))
                self.stats["tier_us"] += duplex_us
                self.stats["ddr5_us"] += self.host.ddr5_baseline_us(
                    ch_rd, ch_wr)
                if self.engine.telemetry is not None:
                    # the tiered path skips plan construction, so the
                    # CAX scope attribution the flat planner does in
                    # ``plan_kv_paging`` happens here instead.
                    self.engine.telemetry.attribute(
                        hint_path,
                        read_bytes=float(stale.size) * block_bytes,
                        write_bytes=float(outs.size) * block_bytes)
            else:
                plan = self.engine.plan_kv_paging(
                    needed_host_blocks=stale.tolist(),
                    evict_hbm_blocks=out_slots.tolist(),
                    free_hbm_blocks=np.concatenate(
                        [free_slots, silent_slots]).tolist(),
                    host_dst_blocks=outs.tolist(),
                    block_bytes=block_bytes,
                    hint_path=hint_path)
                serial = plan_serial(
                    [s.page_in for s in plan.slots if s.page_in],
                    [s.page_out for s in plan.slots if s.page_out],
                    self.engine.link)
                duplex_us = plan.modelled_time_us()
                serial_us = serial.modelled_time_us()
                if self._fx is not None:
                    # flat pool = one channel (index 0): a degrade window
                    # scales both modelled times inversely (pure
                    # bandwidth scaling) and transient retries bill their
                    # failed attempts + backoff into both views.
                    factor = self._fx.bandwidth_factor(0)
                    if factor < 1.0:
                        duplex_us /= factor
                        serial_us /= factor
                    extra = self._fx.retry_penalty_us(0, duplex_us)
                    duplex_us += extra
                    serial_us += extra
                self._flat_bill_totals(int(stale.size), int(outs.size),
                                       duplex_us)
                if self._trace is not None:
                    self._flat_trace_txn(int(stale.size), int(outs.size),
                                         duplex_us, duplex_ok, "paging")
            bp = self.stats["by_path"].setdefault(hint_path,
                                                  _fresh_path_stats())
            for st, key, val in (
                    (self.stats, "duplex_us", duplex_us),
                    (self.stats, "serial_us", serial_us),
                    (self.stats, "page_ins", int(stale.size)),
                    (self.stats, "page_outs", int(outs.size)),
                    (bp, "duplex_us", duplex_us),
                    (bp, "serial_us", serial_us),
                    (bp, "page_ins", int(stale.size)),
                    (bp, "page_outs", int(outs.size))):
                st[key] += val

            # ONE kernel pass per direction pair over this scope's real
            # traffic (fused when opted in and both directions are busy).
            if stale.size and outs.size and duplex_ok:
                m = max(stale.size, outs.size)
                m += -m % STAGE_BLOCKS
                in_idx = self._idx(in_hslots)
                in_q = _pad_rows(self.host_q[in_idx], m)
                in_scale = _pad_rows(self.host_scale[in_idx], m)
                out_x = _pad_rows(self.hbm[self._idx(out_slots)], m)
                in_deq, out_q, out_scale = kernel_ops.duplex_kv_stream(
                    in_q, in_scale, out_x, stage_blocks=STAGE_BLOCKS)
                self.stats["kernel_calls"] += 1
                bp["fused_calls"] += 1
            else:
                # single-direction halves: exactly the real blocks per
                # direction (withdrawn scopes take this path even with
                # both directions busy).
                if outs.size:
                    out_q, out_scale = kernel_ops.quant_kv_stream(
                        self.hbm[self._idx(out_slots)])
                    self.stats["kernel_calls"] += 1
                if stale.size:
                    in_idx = self._idx(in_hslots)
                    in_deq = kernel_ops.dequant_kv_stream(
                        self.host_q[in_idx], self.host_scale[in_idx])
                    self.stats["kernel_calls"] += 1

        if victims.size:
            self.block_at[victim_slots] = -1
            self.slot_of[victims] = -1

        # stale blocks take the leading dst slots (they consume in_deq);
        # fresh blocks zero-fill the rest pending their first write.
        missing = np.concatenate([stale, fresh]).astype(np.int32)
        dst = np.concatenate([free_slots, victim_slots])[:missing.size]
        dst = dst.astype(np.int32)
        # commit in place (the reference donates the tier buffers here):
        # spill departures to the host tier, install arrivals, zero-fill
        # fresh installs.
        if outs.size:
            oh = self._idx(out_hslots)
            self.host_q.index_copy_(0, oh, out_q[:outs.size])
            self.host_scale.index_copy_(0, oh, out_scale[:outs.size])
        if stale.size:
            self.hbm.index_copy_(0, self._idx(dst[:stale.size]),
                                 in_deq[:stale.size])
        if fresh.size:
            self.hbm.index_fill_(0, self._idx(dst[stale.size:]), 0)
        if outs.size:
            self._has_host[outs] = True
            self._dirty[outs] = False   # host copy now matches
            if self._fx is not None:
                # stamp the page-out checksum; verified at page-in.
                self._stamp += 1
                self._csum_data[outs] = self._stamp
                self._csum_stamp[outs] = self._stamp
        self.slot_of[missing] = dst
        self.block_at[dst] = missing
        return {"page_ins": int(stale.size), "page_outs": int(outs.size)}

    def _touch(self, blocks: np.ndarray) -> None:
        self._clock += 1
        self.last_use[blocks] = self._clock

    # -- batched data plane ------------------------------------------------
    def write(self, blocks, data: torch.Tensor) -> None:
        """Write-through freshly produced blocks (must be resident).

        ``blocks``: (n,) logical ids; ``data``: (n, tokens, kv_dims).
        Ids outside [0, n_blocks) are padding sentinels whose rows are
        dropped (on the host, before the scatter).
        """
        rows, dst, real = self._write_dst(blocks)
        if dst is None:
            return
        self.hbm.index_copy_(0, self._idx(dst),
                             data[self._idx(rows)].to(torch.bfloat16))
        self._dirty[real] = True
        self._touch(real)

    def write_staged(self, blocks, staged, step: int) -> None:
        """Write-through one megastep inner step's freshly filled blocks
        from the megastep's staged slabs (``staged[step]``: (W, tokens,
        kv_dims) on the device; it never touches the host). Ids follow
        ``write``'s sentinel-padding contract."""
        self.write(blocks, staged[step])

    def _write_dst(self, blocks):
        """Shared write-through validation: map logical ids to HBM slots;
        returns (data rows kept, their slots, their block ids), dropping
        sentinel-padded rows."""
        blocks = np.asarray(blocks, np.int32)
        valid = (blocks >= 0) & (blocks < self.n_blocks)
        real = blocks[valid]
        if real.size == 0:
            return None, None, real
        slots = self.slot_of[real]
        if (slots < 0).any():
            raise ValueError("write to non-resident block; call step() first")
        return np.flatnonzero(valid), slots, real

    def read(self, blocks) -> torch.Tensor:
        """Gather resident blocks: (n, tokens, kv_dims) bf16, touching
        their LRU clock."""
        blocks = np.asarray(blocks, np.int32)
        slots = self.slot_of[blocks]
        if (slots < 0).any():
            raise ValueError("read of non-resident block; call step() first")
        self._touch(blocks)
        return self.hbm[self._idx(slots)]

    # -- host-tier migrations (megastep boundaries) -------------------------
    def migrate_tiers(self, max_moves: int | None = None) -> dict:
        """Rebalance host-tier placement at a megastep boundary.

        Planning is pure host metadata (the hotness clock ``last_use``,
        the placement map, the boundary window's per-channel traffic);
        execution is one in-place row gather/scatter — dispatch only, so
        a boundary with migrations adds no host sync. CXL legs ride each
        link's idle minor direction (budgeted from the window the plan
        just closed); the half-duplex legs' modelled time lands in
        ``stats["migrate_us"]``. Data moves verbatim (quantized rows +
        scales), so served results are bit-exact whether or not
        migrations run. ``max_moves`` caps the plan below
        ``MIGRATE_MAX``.
        """
        if not self.tiered:
            return {"migrations": 0}
        width = MIGRATE_MAX if max_moves is None \
            else min(int(max_moves), MIGRATE_MAX)
        plan = self.host.plan_migrations(self.last_use, self._has_host,
                                         width)
        if len(plan):
            try:
                self._move_rows(plan.src_slots, plan.dst_slots)
            except Exception:
                # the plan reserved its destination slots; hand them back
                # so a failed dispatch cannot leak host-tier capacity.
                self.host.abandon(plan)
                raise
        self.host.apply(plan)   # also closes the traffic window
        self.stats["migrations"] += len(plan)
        self.stats["migrate_us"] += plan.migrate_us
        if len(plan) and self.engine.telemetry is not None:
            bb = self.host.block_bytes
            self.engine.telemetry.attribute(
                "/serve/tier_migrate", read_bytes=len(plan) * bb,
                write_bytes=len(plan) * bb)
        return {"migrations": len(plan)}

    # -- snapshot/restore ---------------------------------------------------
    def flush_dirty(self, hint_path: str = "/serve/kv_cache") -> dict:
        """Page out every dirty resident block through the billed path,
        keeping residency — the durability barrier a snapshot cut takes
        so its host tier holds a copy of all live KV state.

        This is ``_execute``'s departure leg with no arrivals: blocks get
        (or keep) a host-tier slot under the scope's preferred kind, the
        write traffic is billed per channel (``co_issued=False``: there is
        no read stream to pair against, so snapshot bandwidth is
        phase-separated, never free), the data moves through the
        ``quant_stream`` kernel, and checksums are stamped. The blocks
        stay resident and become clean. Dispatch only on the device."""
        outs = np.flatnonzero(self._dirty
                              & (self.slot_of >= 0)).astype(np.int32)
        if outs.size == 0:
            return {"page_outs": 0, "flush_us": 0.0}
        out_slots = self.slot_of[outs]
        resolved = self.engine.hints.resolve(hint_path).resolved()
        pref = self.host.preferred_kind(resolved)
        out_hslots = self.host.place(outs, pref, refresh=False)
        if self.tiered:
            ch_rd, ch_wr, duplex_us, serial_us = \
                self.host.bill_transaction(np.zeros((0,), np.int32),
                                           out_hslots, co_issued=False)
            self.stats["tier_us"] += duplex_us
            self.stats["ddr5_us"] += self.host.ddr5_baseline_us(
                ch_rd, ch_wr)
            if self.engine.telemetry is not None:
                self.engine.telemetry.attribute(
                    hint_path, read_bytes=0.0,
                    write_bytes=float(outs.size) * self.host.block_bytes)
        else:
            plan = self.engine.plan_kv_paging(
                needed_host_blocks=[],
                evict_hbm_blocks=out_slots.tolist(),
                free_hbm_blocks=[],
                host_dst_blocks=outs.tolist(),
                block_bytes=self.host.block_bytes,
                hint_path=hint_path)
            serial = plan_serial(
                [], [s.page_out for s in plan.slots if s.page_out],
                self.engine.link)
            duplex_us = plan.modelled_time_us()
            serial_us = serial.modelled_time_us()
            if self._fx is not None:
                factor = self._fx.bandwidth_factor(0)
                if factor < 1.0:
                    duplex_us /= factor
                    serial_us /= factor
                extra = self._fx.retry_penalty_us(0, duplex_us)
                duplex_us += extra
                serial_us += extra
            self._flat_bill_totals(0, int(outs.size), duplex_us)
            if self._trace is not None:
                self._flat_trace_txn(0, int(outs.size), duplex_us,
                                     False, "flush")
        bp = self.stats["by_path"].setdefault(hint_path,
                                              _fresh_path_stats())
        for st in (self.stats, bp):
            st["duplex_us"] += duplex_us
            st["serial_us"] += serial_us
            st["page_outs"] += int(outs.size)
        out_q, out_scale = kernel_ops.quant_kv_stream(
            self.hbm.index_select(0, self._idx(out_slots)))
        self.stats["kernel_calls"] += 1
        oh = self._idx(out_hslots)
        self.host_q.index_copy_(0, oh, out_q)
        self.host_scale.index_copy_(0, oh, out_scale)
        self._has_host[outs] = True
        self._dirty[outs] = False
        if self._fx is not None:
            self._stamp += 1
            self._csum_data[outs] = self._stamp
            self._csum_stamp[outs] = self._stamp
        return {"page_outs": int(outs.size), "flush_us": duplex_us}

    def snapshot_state(self) -> dict:
        """Every mutable field as checkpoint-ready host values: the raw
        bf16 HBM rows as a CPU tensor (restoring from the int8 host
        copies would be ``dequant(quant(x))`` — lossy — and break
        bit-exact resume), the quantized host tier, the block table and
        the accounting. The fault injector's own state is engine-level
        and not captured here; the per-block checksum arrays are pool
        state and ride along when an injector is attached. On a CUDA
        device the copies wait for the device."""
        state = {
            "hbm": self.hbm.to("cpu", copy=True),
            "host_q": self.host_q.to("cpu", copy=True),
            "host_scale": self.host_scale.to("cpu", copy=True),
            "slot_of": self.slot_of.copy(),
            "block_at": self.block_at.copy(),
            "last_use": self.last_use.copy(),
            "allocated": self._allocated.copy(),
            "dirty": self._dirty.copy(),
            "has_host": self._has_host.copy(),
            "host": self.host.snapshot_state(),
            "meta": {
                "clock": self._clock,
                "stamp": self._stamp,
                "stats": {k: ({p: dict(v) for p, v in val.items()}
                              if k == "by_path" else val)
                          for k, val in self.stats.items()},
            },
        }
        if self._fx is not None:
            state["csum_data"] = self._csum_data.copy()
            state["csum_stamp"] = self._csum_stamp.copy()
        return state

    def load_state(self, state: dict) -> None:
        """Inverse of ``snapshot_state`` onto a pool built with the same
        config (shapes, tiers and faults come from construction). The
        tier tensors are written in place (``copy_``): they stay the
        same objects a captured CUDA graph may read."""
        for dst, key in ((self.hbm, "hbm"), (self.host_q, "host_q"),
                         (self.host_scale, "host_scale")):
            src = torch.as_tensor(state[key])
            if src.dtype != dst.dtype or src.shape != dst.shape:
                raise ValueError(
                    f"pool snapshot {key} is {src.dtype} {tuple(src.shape)}"
                    f", this pool's {dst.dtype} {tuple(dst.shape)} — restore "
                    "needs the crashed run's pool config")
            dst.copy_(src)
        self.slot_of = np.asarray(state["slot_of"], np.int32).copy()
        self.block_at = np.asarray(state["block_at"], np.int32).copy()
        self.last_use = np.asarray(state["last_use"], np.int64).copy()
        self._allocated = np.asarray(state["allocated"], bool).copy()
        self._dirty = np.asarray(state["dirty"], bool).copy()
        self._has_host = np.asarray(state["has_host"], bool).copy()
        self.host.load_state(state["host"])
        meta = state["meta"]
        self._clock = int(meta["clock"])
        self._stamp = int(meta["stamp"])
        self.stats = {k: ({p: dict(v) for p, v in val.items()}
                          if k == "by_path" else val)
                      for k, val in meta["stats"].items()}
        if self._fx is not None:
            self._csum_data = np.asarray(state["csum_data"],
                                         np.int64).copy()
            self._csum_stamp = np.asarray(state["csum_stamp"],
                                          np.int64).copy()

    # -- reporting ---------------------------------------------------------
    def tier_speedup(self) -> float:
        """Modelled all-DDR5-serial vs tiered link-time ratio for the
        pool's real paging traffic (1.0 for a flat pool — there is no
        counterfactual to beat)."""
        if self.stats["tier_us"] == 0:
            return 1.0
        return self.stats["ddr5_us"] / self.stats["tier_us"]

    def tier_stats(self) -> dict:
        """Per-channel placement/traffic/migration accounting plus the
        tier A/B summary. Flat pools emit the same keys (their single
        channel, zeroed tier fields)."""
        return {"tiered": self.tiered,
                "channels": self.host.stats(),
                "migrations": self.stats["migrations"],
                "migrate_us": round(self.stats["migrate_us"], 3),
                "tier_us": round(self.stats["tier_us"], 3),
                "ddr5_us": round(self.stats["ddr5_us"], 3),
                "tier_speedup": round(self.tier_speedup(), 4)}

    def duplex_speedup(self, hint_path: str | None = None) -> float:
        """Modelled serial/duplex link-time ratio — overall, or for one
        hint scope's traffic. Withdrawn scopes report exactly 1.0."""
        st = (self.stats if hint_path is None
              else self.stats["by_path"].get(hint_path, _fresh_path_stats()))
        if st["duplex_us"] == 0:
            return 1.0
        return st["serial_us"] / st["duplex_us"]

    def reset_stats(self) -> None:
        self.stats = _fresh_stats()
        self.host.reset_stats()
