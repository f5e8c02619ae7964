"""Host-side placement map and per-channel accounting of the KV pool.

The flat subset of ``repro/serve/tiers.py``: ``TieredHostPool.flat`` is
the single-channel host pool with identity placement (host slot ==
block id), and the methods the flat ``PagedKVPool`` calls. The
heterogeneous DDR5+CXL channel sets, weighted-interleave placement and
boundary migrations are not ported yet. Everything here is host numpy
metadata; the quantized block data stays in the pool's device tensors.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import hints as hints_lib
from repro_torch.core.channel import ChannelModel


class TieredHostPool:
    """Placement map + per-channel accounting for the pool's host side
    (one channel, identity placement)."""

    def __init__(self, n_blocks: int, link: ChannelModel,
                 block_bytes: float):
        self.block_bytes = float(block_bytes)
        self.kinds = [link.name]
        self.identity = True
        self.tiered = False
        self.cap = np.asarray([n_blocks], np.int64)
        self.total_slots = int(n_blocks)
        # block -> host slot / inverse; -1 = unplaced
        self.slot_of = np.full((n_blocks,), -1, np.int32)
        self.block_of = np.full((self.total_slots,), -1, np.int32)
        self._kind_id = {link.name: 0}
        self.totals = [
            {"kind": link.name, "page_in_blocks": 0, "page_out_blocks": 0,
             "read_bytes": 0.0, "write_bytes": 0.0, "busy_us": 0.0,
             "migrated_in": 0, "migrated_out": 0}
        ]

    @classmethod
    def flat(cls, n_blocks: int, link: ChannelModel,
             block_bytes: float) -> "TieredHostPool":
        return cls(n_blocks, link, block_bytes)

    # -- placement ----------------------------------------------------------
    def preferred_kind(self, hint: hints_lib.MemoryHint) -> int:
        """Map a resolved scope hint to this pool's kind id; a preference
        for an absent kind degrades to the first configured kind."""
        return self._kind_id.get(hints_lib.preferred_tier(hint), 0)

    def place(self, blocks: np.ndarray, kind_id: int,
              refresh: bool = True) -> np.ndarray:
        """Assign host slots for ``blocks`` (identity: slot == block)."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        self.slot_of[blocks] = blocks
        self.block_of[blocks] = blocks
        return blocks.copy()

    def release(self, blocks: np.ndarray) -> None:
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        if blocks.size == 0:
            return
        self.slot_of[blocks] = -1
        self.block_of[blocks] = -1

    # -- reporting / invariants ----------------------------------------------
    def stats(self) -> dict:
        occ = self.block_of >= 0
        t = self.totals[0]
        return {f"{self.kinds[0]}:0": {
            **{k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in t.items()},
            "slots_used": int(occ.sum()),
            "slots": int(self.cap[0]),
            "offline": False,
            "quarantined": 0,
            "lost": 0,
        }}

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
        for s in np.flatnonzero(self.block_of >= 0).tolist():
            if self.slot_of[self.block_of[s]] != s:
                raise AssertionError(f"dangling host slot {s}")
