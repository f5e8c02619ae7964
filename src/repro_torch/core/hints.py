"""Hierarchical memory-access hints — the cgroup mechanism of CXLAimPod §4.5.

Copy of ``repro/core/hints.py`` (pure Python; the port keeps its own so it
never imports the JAX package). A ``HintTree`` is a tree of named scopes
(``/`` = system, ``/serve``, ``/serve/kv_cache``...) each optionally
carrying a ``MemoryHint``; unset fields inherit from the nearest ancestor
that sets them. ``tier=None`` after resolution means "derive at placement
time" (``preferred_tier``): the system default sets no tier.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator

_UNSET = None


@dataclasses.dataclass(frozen=True)
class MemoryHint:
    """Declared expectations for one scope. ``None`` = inherit.

    Attributes:
      read_fraction: expected fraction of traffic (by bytes) that is reads.
      sequential: access pattern (True sequential / False random).
      priority: scheduling weight (vruntime weight in Algorithm 1).
      phase_period_us: period of alternating direction phases, if any.
      duplex_opt_in: scopes may opt out of duplex intervention entirely.
      tier: host-memory tier preference ("ddr5" | "cxl"); None = derive
        from the traffic mix at placement time (``preferred_tier``).
    """

    read_fraction: float | None = None
    sequential: bool | None = None
    priority: float | None = None
    phase_period_us: float | None = None
    duplex_opt_in: bool | None = None
    tier: str | None = None

    FIELDS = ("read_fraction", "sequential", "priority", "phase_period_us",
              "duplex_opt_in", "tier")

    def __post_init__(self):
        if self.tier is not None:
            from repro_torch.core.channel import TIER_PRESETS
            if self.tier not in TIER_PRESETS:
                raise ValueError(
                    f"unknown tier {self.tier!r}; known tier kinds: "
                    f"{','.join(sorted(TIER_PRESETS))}")

    def merged_over(self, parent: "MemoryHint") -> "MemoryHint":
        """Child values win; unset child fields inherit from parent."""
        values = {}
        for f in self.FIELDS:
            mine = getattr(self, f)
            values[f] = mine if mine is not _UNSET else getattr(parent, f)
        return MemoryHint(**values)

    def resolved(self) -> "MemoryHint":
        """Fill remaining unset fields with system defaults."""
        return self.merged_over(SYSTEM_DEFAULT)


SYSTEM_DEFAULT = MemoryHint(read_fraction=0.5, sequential=False,
                            priority=1.0, phase_period_us=0.0,
                            duplex_opt_in=True)


def preferred_tier(hint: MemoryHint) -> str:
    """Host-tier preference for a scope's spilled blocks: an explicit
    ``tier`` wins; otherwise mixed scopes go to CXL, unidirectional and
    duplex-withdrawn scopes to DDR5."""
    h = hint.resolved()
    if hint.tier is not None:
        return hint.tier
    if h.duplex_opt_in is False:
        return "ddr5"
    rf = 0.5 if h.read_fraction is None else float(h.read_fraction)
    return "ddr5" if (rf >= 0.8 or rf <= 0.2) else "cxl"


def _split(path: str) -> list[str]:
    if not path.startswith("/"):
        raise ValueError(f"hint path must be absolute, got {path!r}")
    return [p for p in path.split("/") if p]


class HintTree:
    """A cgroup-like hierarchy of MemoryHints."""

    def __init__(self) -> None:
        self._hints: dict[str, MemoryHint] = {"/": MemoryHint()}

    def set(self, path: str, hint: MemoryHint) -> None:
        parts = _split(path)
        # materialize intermediate scopes so iteration order is stable
        for i in range(1, len(parts)):
            inter = "/" + "/".join(parts[:i])
            self._hints.setdefault(inter, MemoryHint())
        self._hints["/" + "/".join(parts)] = hint

    def remove(self, path: str) -> None:
        if path == "/":
            self._hints["/"] = MemoryHint()
        else:
            self._hints.pop(path, None)

    def resolve(self, path: str) -> MemoryHint:
        """Walk root->leaf merging hints, then fill system defaults.
        Paths need not have been ``set``; they resolve through ancestors."""
        parts = _split(path) if path != "/" else []
        merged = self._hints.get("/", MemoryHint()).merged_over(SYSTEM_DEFAULT)
        prefix = ""
        for part in parts:
            prefix += "/" + part
            node = self._hints.get(prefix)
            if node is not None:
                merged = node.merged_over(merged)
        return merged

    def paths(self) -> Iterator[str]:
        return iter(sorted(self._hints))

    # -- serialization (the "filesystem interface") -------------------------
    def to_json(self) -> str:
        payload = {
            path: {f: getattr(h, f) for f in MemoryHint.FIELDS
                   if getattr(h, f) is not None}
            for path, h in sorted(self._hints.items())
        }
        return json.dumps(payload, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "HintTree":
        tree = cls()
        for path, fields in json.loads(text).items():
            tree.set(path, MemoryHint(**fields))
        return tree


def default_training_hints() -> HintTree:
    """Framework defaults for a training job (the reference's scopes):
    forward activations are write-then-read, gradient reduce-scatter is
    TX-heavy, optimizer offload reads and writes host memory, checkpoint
    writes are pure-write sequential."""
    t = HintTree()
    t.set("/train", MemoryHint(priority=1.0))
    t.set("/train/fwd", MemoryHint(read_fraction=0.6))
    t.set("/train/bwd", MemoryHint(read_fraction=0.45))
    t.set("/train/grads", MemoryHint(read_fraction=0.1, sequential=True))
    t.set("/train/opt_offload",
          MemoryHint(read_fraction=0.5, sequential=True, priority=0.8))
    t.set("/train/checkpoint",
          MemoryHint(read_fraction=0.0, sequential=True, priority=0.2))
    return t


def default_serving_hints() -> HintTree:
    """Serving job defaults, per the paper's §6.4 layer analysis (the
    reference's scopes, unchanged: LLM decode, the KV-store and the
    vector-search tenant families)."""
    t = HintTree()
    t.set("/serve", MemoryHint(priority=1.0))
    t.set("/serve/attention",
          MemoryHint(read_fraction=0.85, phase_period_us=64.0))
    t.set("/serve/ffn", MemoryHint(read_fraction=0.60, phase_period_us=64.0))
    t.set("/serve/kv_cache/page_in",
          MemoryHint(read_fraction=1.0, sequential=True))
    t.set("/serve/kv_cache/page_out",
          MemoryHint(read_fraction=0.0, sequential=True))
    # read-heavy prompt processing opts out (paper: intervention withdrawn).
    t.set("/serve/prefill", MemoryHint(read_fraction=0.95,
                                       duplex_opt_in=False))
    t.set("/serve/llm", MemoryHint(priority=1.0))
    t.set("/serve/llm/prefill", MemoryHint(read_fraction=0.95,
                                           duplex_opt_in=False,
                                           tier="ddr5"))
    t.set("/serve/llm/decode",
          MemoryHint(read_fraction=0.85, phase_period_us=64.0,
                     tier="cxl"))
    t.set("/serve/kv_cache", MemoryHint(tier="cxl"))
    t.set("/serve/redis", MemoryHint(priority=1.0))
    t.set("/serve/redis/read_heavy",
          MemoryHint(read_fraction=10.0 / 11.0, duplex_opt_in=False))
    t.set("/serve/redis/write_heavy",
          MemoryHint(read_fraction=1.0 / 11.0, duplex_opt_in=False))
    t.set("/serve/redis/pipelined",
          MemoryHint(read_fraction=0.5, phase_period_us=8.0))
    t.set("/serve/redis/gaussian", MemoryHint(read_fraction=0.5))
    t.set("/serve/redis/seq",
          MemoryHint(read_fraction=0.5, sequential=True,
                     phase_period_us=64.0))
    t.set("/serve/redis/seq/read",
          MemoryHint(read_fraction=0.95, sequential=True))
    t.set("/serve/redis/seq/write",
          MemoryHint(read_fraction=0.05, sequential=True))
    t.set("/serve/vectordb",
          MemoryHint(read_fraction=0.85, phase_period_us=32.0))
    t.set("/serve/vectordb/build",
          MemoryHint(read_fraction=0.05, sequential=True))
    t.set("/serve/vectordb/results", MemoryHint(read_fraction=0.1))
    return t
