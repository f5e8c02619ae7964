"""TieredHostPool — heterogeneous DDR5+CXL host-memory channels (§3).

The paper's characterization contrasts flat half-duplex DDR5 against
full-duplex CXL: at balanced read/write ratios the CXL link's opposing
directions overlap for 55-61% more bandwidth, while unidirectional
traffic is served just as well by the lower-latency DDR5 bus. The flat
``PagedKVPool`` host side modelled ONE homogeneous full-duplex pool, so
that trade-off was invisible. This module backs the host side with N
heterogeneous channels instead:

  * every channel is an existing ``core.channel.ChannelModel`` — the
    half-duplex ``DDR5_HOST`` preset pays batch-amortized turnaround on
    read<->write alternation, the full-duplex ``CXL_HOST`` preset
    overlaps its minor direction (``channel.TIER_PRESETS``;
    ``parse_tier_spec("ddr5:2,cxl:2")`` builds the channel set);
  * a block -> (channel, slot) **placement map** assigns each spilled
    block a host slot; placement is *hint-driven weighted interleave*:
    the scope's resolved ``MemoryHint`` picks the preferred tier
    (``hints.preferred_tier`` — mixed scopes to CXL, read-mostly and
    duplex-withdrawn scopes to DDR5), and a smooth weighted round-robin
    interleaves across that tier's channels (weights = channel
    bandwidth, the Micron/Intel weighted-interleave recipe), falling
    back to the other tier only under capacity pressure;
  * per-channel traffic is billed under each channel's own model
    (channels run in parallel — a transaction's time is the max over
    channels), which is what makes ``duplex_speedup`` and the new
    ``tier_speedup`` (tiered vs the all-DDR5 serial counterfactual)
    honest;
  * a **hotness clock** (the pool's ``last_use``) drives background
    promotion/demotion migrations planned at megastep boundaries:
    blocks whose current channel kind no longer matches their scope's
    preference move over — but a migration's CXL leg is scheduled ONLY
    into the idle minor direction of that CXL link's per-megastep
    traffic window (the duplex thesis applied to tiering itself), so
    migrations ride bandwidth the megastep plan left on the floor. The
    data copy itself is an in-place row gather/scatter in the pool
    (``PagedKVPool._move_rows``): zero added host syncs, bit-identical
    host rows.

Everything here is host-side numpy metadata; the quantized block data
stays in the pool's ``host_q``/``host_scale`` arrays, indexed by the
global host-slot namespace this class owns (channel c's slots occupy
``[base[c], base[c] + cap[c])``).

Port of ``repro/serve/tiers.py``, with its trace hooks (``attach_trace``:
per-channel busy intervals of billing, migrations and evacuations on a
``serve.trace.Tracer``'s modelled clock) and its snapshot round-trip
(``snapshot_state`` / ``load_state``: placement, free lists and billing
totals, for ``serve.snapshot``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import channel as channel_lib
from repro_torch.core import hints as hints_lib
from repro_torch.core import offload as offload_lib
from repro_torch.core.channel import ChannelModel


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """One boundary's planned host-tier rebalance (metadata only; the
    pool executes the row copies and then calls ``apply``)."""
    blocks: np.ndarray       # (n,) logical block ids
    src_slots: np.ndarray    # (n,) global host slots (current)
    dst_slots: np.ndarray    # (n,) global host slots (target)
    transfers: tuple         # offload.MIGRATE Transfer records
    migrate_us: float        # modelled half-duplex-leg time (the CXL
                             # legs ride the idle minor direction free)

    def __len__(self) -> int:
        return int(self.blocks.size)


class TieredHostPool:
    """Placement map + per-channel accounting for the pool's host side.

    ``channels`` — (kind, ChannelModel) pairs (``parse_tier_spec``
    output). Each *kind* can hold every block (per-kind capacity ==
    ``n_blocks``, split evenly across that kind's channels), so the
    preferred tier never hard-fails and cross-tier fallback only occurs
    for exotic channel sets.

    A flat pool (``TieredHostPool.flat``) is the degenerate single
    channel with **identity placement** (host slot == block id): the
    pre-tiered data layout, bit-for-bit.
    """

    def __init__(self, n_blocks: int,
                 channels: Sequence[tuple[str, ChannelModel]],
                 block_bytes: float, identity: bool = False):
        if not channels:
            raise ValueError("need at least one host channel")
        self.n_blocks = n_blocks
        self.block_bytes = float(block_bytes)
        self.kinds = [k for k, _ in channels]
        self.channels = [c for _, c in channels]
        self.identity = identity
        self.tiered = not identity
        C = len(self.channels)
        kind_count: dict[str, int] = {}
        for k in self.kinds:
            kind_count[k] = kind_count.get(k, 0) + 1
        if identity:
            if C != 1:
                raise ValueError("identity placement needs one channel")
            self.cap = np.asarray([n_blocks], np.int64)
        else:
            self.cap = np.asarray(
                [-(-n_blocks // kind_count[k]) for k in self.kinds],
                np.int64)
        self.base = np.concatenate([[0], np.cumsum(self.cap)[:-1]])
        self.total_slots = int(self.cap.sum())
        self.channel_of_slot = np.repeat(
            np.arange(C, dtype=np.int8), self.cap)
        # block -> global host slot / inverse; -1 = unplaced
        self.slot_of = np.full((n_blocks,), -1, np.int32)
        self.block_of = np.full((self.total_slots,), -1, np.int32)
        # per-block preferred kind (index into self.kinds' unique kinds)
        self.kind_names = sorted(kind_count)
        self._kind_id = {k: i for i, k in enumerate(self.kind_names)}
        self.pref = np.full((n_blocks,), -1, np.int8)
        # per-channel free-slot stacks (lowest slot popped first)
        self._free = [list(range(int(self.base[c]),
                                 int(self.base[c] + self.cap[c])))[::-1]
                      for c in range(C)]
        # smooth weighted round-robin state per channel
        self._weights = np.asarray(
            [c.read_bw + c.write_bw for c in self.channels], np.float64)
        self._wrr = np.zeros((C,), np.float64)
        # per-channel byte window since the last migration boundary (the
        # idle-minor-direction budget source) + cumulative totals
        self._win = np.zeros((C, 2), np.float64)        # [read, write]
        # fault state: an offline channel is excluded from placement and
        # holds no free slots; quarantined/lost slots are permanently out
        # of circulation (occupancy invariant: used + free + quarantined
        # + lost == cap per channel).
        self._fx = None
        self._trace = None            # serve.trace.Tracer, when attached
        self._trace_prefix = ""
        self.offline = np.zeros((C,), bool)
        self._quarantined = np.zeros((C,), np.int64)
        self._lost = np.zeros((C,), np.int64)
        self.totals = [
            {"kind": self.kinds[c], "page_in_blocks": 0,
             "page_out_blocks": 0, "read_bytes": 0.0, "write_bytes": 0.0,
             "busy_us": 0.0, "migrated_in": 0, "migrated_out": 0}
            for c in range(C)
        ]
        self.migrations = 0
        self.migrate_us = 0.0

    # -- construction helpers ----------------------------------------------
    @classmethod
    def flat(cls, n_blocks: int, link: ChannelModel,
             block_bytes: float) -> "TieredHostPool":
        return cls(n_blocks, [(link.name, link)], block_bytes,
                   identity=True)

    @classmethod
    def from_spec(cls, n_blocks: int, spec, block_bytes: float
                  ) -> "TieredHostPool":
        """``spec``: a ``"ddr5:2,cxl:2"`` string, a (kind, model) pair
        sequence, or a bare kind-name sequence."""
        if isinstance(spec, str):
            channels = channel_lib.parse_tier_spec(spec)
        else:
            channels = []
            for entry in spec:
                if isinstance(entry, str):
                    if entry not in channel_lib.TIER_PRESETS:
                        known = ",".join(sorted(channel_lib.TIER_PRESETS))
                        raise ValueError(
                            f"unknown tier kind {entry!r}; known kinds: "
                            f"{known}")
                    channels.append((entry,
                                     channel_lib.TIER_PRESETS[entry]))
                else:
                    channels.append(tuple(entry))
        return cls(n_blocks, channels, block_bytes)

    # -- placement ----------------------------------------------------------
    def _pick_channel(self, kind_id: int, need_idle: float = 0.0,
                      idle_write: np.ndarray | None = None,
                      fallback: bool = True) -> int:
        """Smooth weighted round-robin over the preferred kind's channels
        with free slots (optionally also requiring ``need_idle`` bytes of
        idle minor-direction write budget — the migration path); falls
        back to any channel with space unless ``fallback=False``
        (migrations: a cross-tier move only makes sense into the
        preferred tier, and a pick the caller would reject must not
        advance the round-robin state). WRR state moves only when a
        channel is returned."""
        kind = self.kind_names[kind_id]

        def ok(c: int, same_kind: bool) -> bool:
            if self.offline[c]:
                return False
            if same_kind and self.kinds[c] != kind:
                return False
            if not self._free[c]:
                return False
            if (need_idle > 0.0 and self.channels[c].duplex
                    and idle_write is not None
                    and idle_write[c] < need_idle):
                return False
            return True

        passes = (True, False) if fallback else (True,)
        for same_kind in passes:
            cand = [c for c in range(len(self.channels))
                    if ok(c, same_kind)]
            if cand:
                self._wrr[cand] += self._weights[cand]
                pick = max(cand, key=lambda c: self._wrr[c])
                self._wrr[pick] -= self._weights[cand].sum()
                return pick
        return -1

    def preferred_kind(self, hint: hints_lib.MemoryHint) -> int:
        """Map a resolved scope hint to this pool's kind id; a preference
        for an absent kind degrades to the first configured kind."""
        return self._kind_id.get(hints_lib.preferred_tier(hint),
                                 self.pref_default())

    def pref_default(self) -> int:
        return self._kind_id[self.kinds[0]]

    def place(self, blocks: np.ndarray, kind_id: int,
              refresh: bool = True) -> np.ndarray:
        """Assign host slots for ``blocks`` under the scope's preferred
        kind; already-placed blocks keep their slot (the cheapest honest
        choice — a dirty rewrite targets its existing row).

        ``refresh=True`` (page-ins: the demanding scope is the block's
        own user) re-stamps the block's tier preference, which is what
        arms the boundary migrations when a scope changes tiers.
        ``refresh=False`` (evictions: ``step_multi`` picks victims
        *jointly*, so the evicting scope may not be the block's owner)
        only stamps a preference where none exists yet — a cross-scope
        eviction must not clobber the owner's preference, or the
        misplaced block would never migrate home."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        out = np.empty(blocks.shape, np.int32)
        if self.identity:
            self.slot_of[blocks] = blocks
            self.block_of[blocks] = blocks
            return blocks.copy()
        if refresh:
            self.pref[blocks] = kind_id
        else:
            fresh = blocks[self.pref[blocks] < 0]
            self.pref[fresh] = kind_id
        for i, b in enumerate(blocks.tolist()):
            s = int(self.slot_of[b])
            if s < 0:
                c = self._pick_channel(kind_id)
                if c < 0:
                    raise RuntimeError(
                        "host tiers exhausted: no channel has a free "
                        "slot (placement map leak?)")
                s = self._free[c].pop()
                self.slot_of[b] = s
                self.block_of[s] = b
            out[i] = s
        return out

    def release(self, blocks: np.ndarray) -> None:
        """Unplace ``blocks`` and return their host slots to the free
        lists. A block named twice (the KV-store tenant invalidates a key
        SET twice in one step) is released once: the reference pushes its
        slot twice, and two blocks later share that slot."""
        blocks = np.asarray(list(dict.fromkeys(
            np.asarray(blocks, np.int32).reshape(-1).tolist())), np.int32)
        if blocks.size == 0:
            return
        if self.identity:
            self.slot_of[blocks] = -1
            self.block_of[blocks] = -1
            return
        slots = self.slot_of[blocks]
        for b, s in zip(blocks.tolist(), slots.tolist()):
            if s >= 0:
                self._free[int(self.channel_of_slot[s])].append(s)
                self.block_of[s] = -1
        self.slot_of[blocks] = -1
        self.pref[blocks] = -1

    # -- per-transaction billing ---------------------------------------------
    def bill_transaction(self, in_slots: np.ndarray,
                         out_slots: np.ndarray, co_issued: bool
                         ) -> tuple[np.ndarray, np.ndarray, float, float]:
        """Account and bill one transaction's page-ins (channel reads)
        and page-outs (channel writes) in a single per-channel pass.

        Returns ``(read_bytes, write_bytes, duplex_us, serial_us)``:
        per-channel byte splits plus the transaction's modelled times —
        channels run in parallel, so each time view is the max over
        channels. A withdrawn scope (``co_issued=False``) executes
        phase-separated, so its billed duplex time IS the serial time,
        and per-channel ``busy_us`` accumulates under the same model the
        transaction is billed with (channel stats always sum to the
        transaction-level billing)."""
        C = len(self.channels)
        rd = np.bincount(self.channel_of_slot[np.asarray(in_slots,
                                                         np.int64)],
                         minlength=C).astype(np.float64) * self.block_bytes
        wr = np.bincount(self.channel_of_slot[np.asarray(out_slots,
                                                         np.int64)],
                         minlength=C).astype(np.float64) * self.block_bytes
        self._win[:, 0] += rd
        self._win[:, 1] += wr
        duplex = serial = 0.0
        fx = self._fx
        entries = None if self._trace is None else []
        for c in range(C):
            ch = self.channels[c]
            if fx is not None:
                factor = fx.bandwidth_factor(c)
                if factor < 1.0:
                    ch = ch.degraded(factor)
            phase_us = offload_lib.phase_separated_time_us(
                ch, rd[c], wr[c])
            billed_us = (offload_lib.channel_time_us(
                ch, rd[c], wr[c]) if co_issued
                else phase_us)
            if fx is not None and billed_us > 0.0:
                # transient-retry penalty: failed attempts re-pay the
                # transfer time plus backoff, in BOTH time views (a
                # retry storm isn't a duplex-vs-serial effect).
                extra = fx.retry_penalty_us(c, billed_us)
                billed_us += extra
                phase_us += extra
            duplex = max(duplex, billed_us)
            serial = max(serial, phase_us)
            t = self.totals[c]
            t["page_in_blocks"] += int(round(rd[c] / self.block_bytes))
            t["page_out_blocks"] += int(round(wr[c] / self.block_bytes))
            t["read_bytes"] += rd[c]
            t["write_bytes"] += wr[c]
            t["busy_us"] += billed_us
            if entries is not None and (rd[c] > 0.0 or wr[c] > 0.0):
                entries.append((
                    self._trace_track(c), rd[c], wr[c],
                    offload_lib.phase_separated_time_us(ch, rd[c], 0.0),
                    offload_lib.phase_separated_time_us(ch, 0.0, wr[c]),
                    billed_us, co_issued))
        if entries:
            self._trace.channel_transaction(entries, duplex,
                                            name="paging")
        return rd, wr, duplex, serial

    def ddr5_baseline_us(self, rd: np.ndarray, wr: np.ndarray) -> float:
        """The all-DDR5 serial counterfactual for one transaction: the
        same traffic round-robined *at block granularity* (a block
        cannot split across DIMM channels) over this pool's DDR5
        channels (the host without its CXL expanders) — or, for a
        DDR5-less channel set, over an equal count of DDR5 channels —
        the busiest channel billed phase-separated on the half-duplex
        model."""
        n = sum(1 for k in self.kinds if k == "ddr5")
        if n == 0:
            n = len(self.channels)
        bb = self.block_bytes
        per_in = -(-int(round(float(rd.sum()) / bb)) // n)
        per_out = -(-int(round(float(wr.sum()) / bb)) // n)
        ddr5 = channel_lib.TIER_PRESETS["ddr5"]
        return offload_lib.phase_separated_time_us(
            ddr5, per_in * bb, per_out * bb)

    # -- boundary migrations --------------------------------------------------
    def plan_migrations(self, last_use: np.ndarray, movable: np.ndarray,
                        max_moves: int) -> MigrationPlan:
        """Plan up to ``max_moves`` promotion/demotion moves for blocks
        whose channel kind mismatches their scope preference, hottest
        candidates first toward CXL (they are about to round-trip again)
        and coldest first toward DDR5 (they are squatting on duplex
        capacity). Every CXL leg must fit the link's *idle* direction
        capacity over the megastep window just ended: while the plan's
        busiest channel worked for ``t_horizon``, each duplex direction
        could have carried ``kappa * bw * t_horizon`` bytes and carried
        less — migrations consume only that leftover, adding zero
        modelled time on the duplex links. Half-duplex legs are billed
        into ``migrate_us``. The window resets when the plan is applied.

        Pipelined boundaries plan against *planned-not-yet-reconciled*
        residency: with ``pipeline_depth > 1`` the engine calls this
        while the previous megastep's readback is still in flight, so
        ``movable`` may include blocks whose host copy was written by a
        speculatively dispatched eviction. That is safe — moves relocate
        verbatim host bytes between channel slots and never touch the
        ``_has_host``/ownership bits the divergence rollback depends on,
        so a rolled-back boundary leaves placement consistent (the
        rollback restores ownership, not placement; see
        ``PagedKVPool.reclaim``).
        """
        empty = MigrationPlan(np.zeros((0,), np.int32),
                              np.zeros((0,), np.int32),
                              np.zeros((0,), np.int32), (), 0.0)
        if self.identity or max_moves <= 0:
            return empty
        placed = self.slot_of >= 0
        cand = np.flatnonzero(placed & movable & (self.pref >= 0))
        if cand.size == 0:
            return empty
        cur_kind_id = np.asarray(
            [self._kind_id[self.kinds[int(c)]]
             for c in self.channel_of_slot[self.slot_of[cand]]], np.int8)
        cand = cand[cur_kind_id != self.pref[cand]]
        if cand.size == 0:
            return empty

        # idle minor-direction byte budgets per duplex channel. The
        # horizon is the megastep plan's busiest channel time (channels
        # run in parallel, so while the busiest one works, every other
        # link direction's leftover capacity is free); each duplex
        # direction's budget is what it could have carried over that
        # horizon minus what it did carry. A boundary with no traffic at
        # all has no horizon — migrations only ever overlap real work.
        t_horizon = max(
            (offload_lib.channel_time_us(ch, float(r), float(w)) * 1e-6
             for ch, (r, w) in zip(self.channels, self._win)),
            default=0.0)
        idle_read = np.zeros((len(self.channels),), np.float64)
        idle_write = np.zeros((len(self.channels),), np.float64)
        for c, ch in enumerate(self.channels):
            if not ch.duplex:
                continue
            br, bw = (x * channel_lib.BYTES_PER_GB
                      for x in ch.direction_bw(sequential=True))
            r, w = self._win[c]
            k = ch.duplex_coupling
            idle_read[c] = max(0.0, k * br * t_horizon - r)
            idle_write[c] = max(0.0, k * bw * t_horizon - w)

        def is_duplex_kind(kid: int) -> bool:
            name = self.kind_names[kid]
            return any(ch.duplex for k, ch in zip(self.kinds,
                                                  self.channels)
                       if k == name)

        to_duplex = [b for b in cand.tolist()
                     if is_duplex_kind(int(self.pref[b]))]
        to_half = [b for b in cand.tolist()
                   if not is_duplex_kind(int(self.pref[b]))]
        to_duplex.sort(key=lambda b: -int(last_use[b]))   # hottest first
        to_half.sort(key=lambda b: int(last_use[b]))      # coldest first

        blocks, srcs, dsts = [], [], []
        migrate_us = 0.0
        bb = self.block_bytes
        for b in to_duplex + to_half:
            if len(blocks) >= max_moves:
                break
            src = int(self.slot_of[b])
            sc = int(self.channel_of_slot[src])
            src_ch = self.channels[sc]
            # the source leg reads the source channel: a duplex source
            # needs idle read budget, a half-duplex source bills time.
            if src_ch.duplex and idle_read[sc] < bb:
                continue
            dc = self._pick_channel(int(self.pref[b]), need_idle=bb,
                                    idle_write=idle_write,
                                    fallback=False)
            if dc < 0:
                continue   # no eligible destination in the target tier
            dst_ch = self.channels[dc]
            if src_ch.duplex:
                idle_read[sc] -= bb
            else:
                migrate_us += offload_lib.phase_separated_time_us(
                    src_ch, bb, 0.0)
            if dst_ch.duplex:
                idle_write[dc] -= bb
            else:
                migrate_us += offload_lib.phase_separated_time_us(
                    dst_ch, 0.0, bb)
            dst = self._free[dc].pop()
            blocks.append(b)
            srcs.append(src)
            dsts.append(dst)
        if not blocks:
            return empty
        blocks = np.asarray(blocks, np.int32)
        srcs = np.asarray(srcs, np.int32)
        dsts = np.asarray(dsts, np.int32)
        return MigrationPlan(
            blocks, srcs, dsts,
            tuple(offload_lib.migration_transfers(
                blocks.tolist(), srcs.tolist(), dsts.tolist(), bb)),
            migrate_us)

    def attach_trace(self, tracer, prefix: str = "") -> None:
        """Attach a ``serve.trace.Tracer``; billing appends per-channel
        per-direction busy intervals on its modelled clock. ``prefix``
        namespaces the track names. Every channel's rd/wr tracks are
        registered up front so idle channels still show an (empty)
        utilization timeline."""
        self._trace = tracer
        self._trace_prefix = prefix
        for c in range(len(self.channels)):
            for d in (".rd", ".wr"):
                tracer.timelines.setdefault(self._trace_track(c) + d, [])

    def _trace_track(self, c: int) -> str:
        return f"{self._trace_prefix}{self.kinds[c]}:{c}"

    def apply(self, plan: MigrationPlan) -> None:
        """Commit a plan's placement-map updates (the pool has already
        executed the device row copies) and reset the traffic window."""
        if self._trace is not None and len(plan):
            self._trace_migration(plan)
        for b, src, dst in zip(plan.blocks.tolist(),
                               plan.src_slots.tolist(),
                               plan.dst_slots.tolist()):
            sc = int(self.channel_of_slot[src])
            dc = int(self.channel_of_slot[dst])
            self._free[sc].append(src)
            self.block_of[src] = -1
            self.slot_of[b] = dst
            self.block_of[dst] = b
            self.totals[sc]["migrated_out"] += 1
            self.totals[dc]["migrated_in"] += 1
        self.migrations += len(plan)
        self.migrate_us += plan.migrate_us
        self._win[:] = 0.0

    def _trace_migration(self, plan: MigrationPlan) -> None:
        """Lay one boundary migration's legs on the channel timelines:
        reads on the source channels, writes on the destinations, at
        each channel's pure direction rate. Only the half-duplex legs'
        billed time (``plan.migrate_us``) advances the modelled clock —
        duplex legs ride the idle minor direction, visible as occupancy
        that adds no horizon."""
        C = len(self.channels)
        rd = np.bincount(self.channel_of_slot[plan.src_slots],
                         minlength=C).astype(np.float64) * self.block_bytes
        wr = np.bincount(self.channel_of_slot[plan.dst_slots],
                         minlength=C).astype(np.float64) * self.block_bytes
        entries = []
        for c in range(C):
            if rd[c] == 0.0 and wr[c] == 0.0:
                continue
            rd_us = offload_lib.phase_separated_time_us(
                self.channels[c], rd[c], 0.0)
            wr_us = offload_lib.phase_separated_time_us(
                self.channels[c], 0.0, wr[c])
            entries.append((self._trace_track(c), rd[c], wr[c],
                            rd_us, wr_us, rd_us + wr_us, True))
        if entries:
            self._trace.channel_transaction(entries, plan.migrate_us,
                                            name="migrate")
        self._trace.instant("migrations", "tier_migrate",
                            {"moves": len(plan),
                             "migrate_us": round(plan.migrate_us, 3)})

    def abandon(self, plan: MigrationPlan) -> None:
        """Return a plan's reserved destination slots (error paths)."""
        for dst in plan.dst_slots.tolist():
            self._free[int(self.channel_of_slot[dst])].append(dst)

    # -- fault handling -------------------------------------------------------
    def attach_faults(self, fx) -> None:
        """Attach a ``core.faults.FaultInjector``; billing consults its
        degrade/transient windows and the pool drives offline/poison
        servicing through ``set_offline``/``evacuate``/``quarantine``."""
        self._fx = fx

    @property
    def capacity_degraded(self) -> bool:
        """True once any channel is offline or any slot is quarantined —
        the engine's cue to apply admission backpressure and shed."""
        return bool(self.offline.any() or self._quarantined.sum() > 0)

    def live_capacity(self) -> int:
        """Host blocks still placeable: total slots minus lost and
        quarantined ones, capped at the block count."""
        usable = (self.total_slots - int(self._lost.sum())
                  - int(self._quarantined.sum()))
        return min(self.n_blocks, max(0, usable))

    def set_offline(self, c: int) -> None:
        """Hot-unplug channel ``c``: exclude it from placement and write
        off its free slots. Live blocks stay mapped until ``evacuate``
        moves them (the pool calls both in the same transaction)."""
        if self.identity:
            raise RuntimeError(
                "cannot offline the only channel of a flat host pool")
        if self.offline[c]:
            return
        self.offline[c] = True
        self._lost[c] += len(self._free[c])
        self._free[c] = []

    def quarantine(self, slots) -> None:
        """Permanently retire host slots (poisoned media). Occupied
        slots are unmapped — the caller fails/re-pages the owning block
        — and the slot never returns to the free list. Identity pools
        only unmap (slot==block; a later rewrite models the device
        scrubbing the page in place)."""
        for s in np.asarray(slots, np.int64).reshape(-1).tolist():
            b = int(self.block_of[s])
            if b >= 0:
                self.block_of[s] = -1
                self.slot_of[b] = -1
                self.pref[b] = -1
            if self.identity:
                continue
            c = int(self.channel_of_slot[s])
            if b < 0:
                try:
                    self._free[c].remove(s)
                except ValueError:
                    continue      # already retired (offline write-off)
            self._quarantined[c] += 1

    def evacuate(self, c: int) -> tuple[np.ndarray, np.ndarray,
                                        np.ndarray, list[int]]:
        """Emergency-evacuate channel ``c``'s live blocks onto surviving
        channels (WRR over each block's preferred kind, cross-tier
        fallback allowed — any port in a storm). Returns ``(blocks,
        src_slots, dst_slots, casualties)``; casualties are blocks with
        no surviving slot, whose host copy is lost (the pool drops their
        residency and the engine fails the owners). Unlike boundary
        migrations this is NOT idle-bandwidth traffic: the read leg is
        billed on the dying channel and each write leg on its
        destination channel — recovery bandwidth is never free."""
        lo, hi = int(self.base[c]), int(self.base[c] + self.cap[c])
        moved_b: list[int] = []
        moved_src: list[int] = []
        moved_dst: list[int] = []
        casualties: list[int] = []
        for s in range(lo, hi):
            b = int(self.block_of[s])
            if b < 0:
                continue
            kid = (int(self.pref[b]) if self.pref[b] >= 0
                   else self.pref_default())
            dc = self._pick_channel(kid, fallback=True)
            self.block_of[s] = -1
            self._lost[c] += 1
            if dc < 0:
                self.slot_of[b] = -1
                self.pref[b] = -1
                casualties.append(b)
                continue
            dst = self._free[dc].pop()
            self.slot_of[b] = dst
            self.block_of[dst] = b
            moved_b.append(b)
            moved_src.append(s)
            moved_dst.append(dst)
            self.totals[c]["migrated_out"] += 1
            self.totals[dc]["migrated_in"] += 1
        bb = self.block_bytes
        if moved_b:
            transfers = offload_lib.evacuation_transfers(
                moved_b, moved_src, moved_dst, bb)
            rd_us = offload_lib.phase_separated_time_us(
                self.channels[c], len(transfers) * bb, 0.0)
            self.totals[c]["read_bytes"] += len(transfers) * bb
            self.totals[c]["busy_us"] += rd_us
            self.migrate_us += rd_us
            wr = np.bincount(
                self.channel_of_slot[np.asarray(moved_dst, np.int64)],
                minlength=len(self.channels)).astype(np.float64) * bb
            wr_entries = []
            for dc in np.flatnonzero(wr > 0).tolist():
                wr_us = offload_lib.phase_separated_time_us(
                    self.channels[dc], 0.0, wr[dc])
                self.totals[dc]["write_bytes"] += wr[dc]
                self.totals[dc]["busy_us"] += wr_us
                self.migrate_us += wr_us
                if self._trace is not None:
                    wr_entries.append((self._trace_track(dc), 0.0,
                                       wr[dc], 0.0, wr_us, wr_us, False))
            if self._trace is not None:
                # the dying channel's read leg precedes the surviving
                # channels' write legs — two modelled-clock steps.
                rd_b = len(transfers) * bb
                self._trace.channel_transaction(
                    [(self._trace_track(c), rd_b, 0.0, rd_us, 0.0,
                      rd_us, False)], rd_us, name="evacuate")
                if wr_entries:
                    self._trace.channel_transaction(
                        wr_entries, max(e[4] for e in wr_entries),
                        name="evacuate")
                self._trace.instant(
                    "faults", "evacuation",
                    {"channel": self._trace_track(c),
                     "moved": len(moved_b),
                     "casualties": len(casualties)})
        return (np.asarray(moved_b, np.int32),
                np.asarray(moved_src, np.int32),
                np.asarray(moved_dst, np.int32), casualties)

    # -- snapshot/restore ----------------------------------------------------
    def snapshot_state(self) -> dict:
        """Every mutable field, as checkpoint-ready values: placement
        arrays are copied host arrays; the per-channel free stacks,
        accounting totals and migration counters go as JSON-able
        structures. Free-stack order is serialized verbatim — ``place``
        pops from the tail, so a reordered stack would place future
        blocks on other slots and break bit-exact resume."""
        return {
            "slot_of": self.slot_of.copy(),
            "block_of": self.block_of.copy(),
            "pref": self.pref.copy(),
            "wrr": self._wrr.copy(),
            "win": self._win.copy(),
            "offline": self.offline.copy(),
            "quarantined": self._quarantined.copy(),
            "lost": self._lost.copy(),
            "meta": {
                "free": [list(f) for f in self._free],
                "totals": [dict(t) for t in self.totals],
                "migrations": self.migrations,
                "migrate_us": self.migrate_us,
            },
        }

    def load_state(self, state: dict) -> None:
        """Inverse of ``snapshot_state`` onto a pool built from the same
        channel spec (the static layout — capacities, bases, kinds —
        comes from the config, not the snapshot)."""
        meta = state["meta"]
        free = meta["free"]
        if len(free) != len(self.channels):
            raise ValueError(
                f"tier snapshot has {len(free)} channels, pool has "
                f"{len(self.channels)} — restore needs the same tier "
                "spec the snapshot was taken under")
        self.slot_of = np.asarray(state["slot_of"], np.int32).copy()
        self.block_of = np.asarray(state["block_of"], np.int32).copy()
        self.pref = np.asarray(state["pref"], np.int8).copy()
        self._wrr = np.asarray(state["wrr"], np.float64).copy()
        self._win = np.asarray(state["win"], np.float64).copy()
        self.offline = np.asarray(state["offline"], bool).copy()
        self._quarantined = np.asarray(state["quarantined"],
                                       np.int64).copy()
        self._lost = np.asarray(state["lost"], np.int64).copy()
        self._free = [[int(s) for s in f] for f in free]
        self.totals = [dict(t) for t in meta["totals"]]
        self.migrations = int(meta["migrations"])
        self.migrate_us = float(meta["migrate_us"])

    # -- reporting / invariants ----------------------------------------------
    def reset_stats(self) -> None:
        """Zero the per-channel accounting (totals, the boundary traffic
        window, migration counters) — the placement map itself is state,
        not stats, and stays. ``PagedKVPool.reset_stats`` calls this so
        ``tier_stats()`` and the pool's counters always describe the
        same measurement window."""
        for t in self.totals:
            for k, v in t.items():
                if isinstance(v, (int, float)):
                    t[k] = type(v)(0)
        self._win[:] = 0.0
        self.migrations = 0
        self.migrate_us = 0.0

    def stats(self) -> dict:
        out: dict[str, dict] = {}
        occ = self.block_of >= 0
        for c, t in enumerate(self.totals):
            name = f"{self.kinds[c]}:{c}"
            lo, hi = int(self.base[c]), int(self.base[c] + self.cap[c])
            out[name] = {
                **{k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in t.items()},
                "slots_used": int(occ[lo:hi].sum()),
                "slots": int(self.cap[c]),
                "offline": bool(self.offline[c]),
                "quarantined": int(self._quarantined[c]),
                "lost": int(self._lost[c]),
            }
        return out

    def check_invariants(self) -> None:
        placed = np.flatnonzero(self.slot_of >= 0)
        slots = self.slot_of[placed]
        if len(set(slots.tolist())) != len(slots):
            raise AssertionError("two blocks share one host slot")
        for b, s in zip(placed.tolist(), slots.tolist()):
            if not 0 <= s < self.total_slots:
                raise AssertionError(f"host slot {s} out of range")
            if self.block_of[s] != b:
                raise AssertionError(
                    f"host map out of sync: slot_of[{b}]={s} but "
                    f"block_of[{s}]={self.block_of[s]}")
        occupied = np.flatnonzero(self.block_of >= 0)
        for s in occupied.tolist():
            if self.slot_of[self.block_of[s]] != s:
                raise AssertionError(f"dangling host slot {s}")
        if self.identity:
            return
        for c in range(len(self.channels)):
            lo, hi = int(self.base[c]), int(self.base[c] + self.cap[c])
            free = self._free[c]
            if any(not lo <= s < hi for s in free):
                raise AssertionError(f"free list of channel {c} leaked "
                                     f"out-of-range slots")
            if len(set(free)) != len(free):
                raise AssertionError(f"channel {c} free list duplicates")
            used = int(((occupied >= lo) & (occupied < hi)).sum())
            if self.offline[c] and (free or used):
                raise AssertionError(
                    f"offline channel {c} still holds slots")
            retired = int(self._quarantined[c]) + int(self._lost[c])
            if used + len(free) + retired != self.cap[c]:
                raise AssertionError(
                    f"channel {c} occupancy {used} + free {len(free)} "
                    f"+ retired {retired} != capacity {self.cap[c]}")
