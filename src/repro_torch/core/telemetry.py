"""CAX — CXL Analysis Context telemetry (CXLAimPod §4.3, §5.1).

Copy of ``repro/core/telemetry.py`` (pure Python). Attribution walks the
ancestor chain like the paper's shadow profiling stack: a delta lands on
its leaf scope *and* every ancestor, so ``/serve`` aggregates everything
below it. The serving engine always wires one registry; the pool's
planner attributes each paging transaction's bytes to its hint scope.
"""

from __future__ import annotations

import dataclasses
import time

# Context types, mirroring the paper's CAX type enum.
SYSTEM = "system"
JOB = "job"          # paper: process
MODULE = "module"    # paper: thread
FUNCTION = "function"

_TYPES = (SYSTEM, JOB, MODULE, FUNCTION)


@dataclasses.dataclass
class CaxContext:
    """One attribution scope (paper §5.1: one BPF array-map entry)."""

    ctx_id: int
    path: str
    ctx_type: str
    parent_id: int | None
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    flops: float = 0.0
    collective_bytes: float = 0.0
    samples: int = 0
    last_update: float = 0.0

    @property
    def total_bytes(self) -> float:
        return self.read_bytes + self.write_bytes

    @property
    def read_fraction(self) -> float:
        t = self.total_bytes
        return self.read_bytes / t if t > 0 else 0.5


class CaxRegistry:
    """Hierarchy of CAX contexts with ancestor-chain attribution.

    Paths are ``/``-separated scope names; registering ``/serve/kv/page_in``
    materializes ``/serve`` (job) and ``/serve/kv`` (module) automatically so
    the hierarchy is always connected, like cgroup directories.
    """

    def __init__(self) -> None:
        self._by_path: dict[str, CaxContext] = {}
        self._by_id: dict[int, CaxContext] = {}
        self._next_id = 0
        self._root = self._materialize("/", SYSTEM, None)

    # -- scope management ----------------------------------------------------
    def _materialize(self, path: str, ctx_type: str,
                     parent: CaxContext | None) -> CaxContext:
        ctx = CaxContext(ctx_id=self._next_id, path=path, ctx_type=ctx_type,
                         parent_id=None if parent is None else parent.ctx_id)
        self._next_id += 1
        self._by_path[path] = ctx
        self._by_id[ctx.ctx_id] = ctx
        return ctx

    def context(self, path: str, ctx_type: str | None = None) -> CaxContext:
        """Get-or-create the context for ``path`` (and its ancestors)."""
        if not path.startswith("/"):
            raise ValueError(f"CAX path must be absolute, got {path!r}")
        if path in self._by_path:
            return self._by_path[path]
        parts = [p for p in path.split("/") if p]
        parent = self._root
        for depth, _ in enumerate(parts):
            prefix = "/" + "/".join(parts[: depth + 1])
            node = self._by_path.get(prefix)
            if node is None:
                # depth 0 => job, 1 => module, >=2 => function
                t = _TYPES[min(depth + 1, len(_TYPES) - 1)]
                node = self._materialize(prefix, t, parent)
            parent = node
        if ctx_type is not None:
            parent.ctx_type = ctx_type
        return parent

    # -- attribution (the eBPF hook analogue) --------------------------------
    def attribute(self, path: str, *, read_bytes: float = 0.0,
                  write_bytes: float = 0.0, flops: float = 0.0,
                  collective_bytes: float = 0.0) -> None:
        """Attribute a delta to ``path`` and every ancestor (shadow stack)."""
        node: CaxContext | None = self.context(path)
        now = time.monotonic()
        while node is not None:
            node.read_bytes += read_bytes
            node.write_bytes += write_bytes
            node.flops += flops
            node.collective_bytes += collective_bytes
            node.samples += 1
            node.last_update = now
            node = (self._by_id[node.parent_id]
                    if node.parent_id is not None else None)

    def reset(self) -> None:
        """Zero every context's accumulators in place. Scope identity
        (paths, ids, hierarchy) survives — attached producers keep
        their references — only the measurements restart."""
        for c in self._by_path.values():
            c.read_bytes = c.write_bytes = 0.0
            c.flops = c.collective_bytes = 0.0
            c.samples = 0
            c.last_update = 0.0

    def to_dict(self) -> dict:
        """The scope tree as one JSON-able dict keyed by path (the serve
        CLI's ``--telemetry`` report)."""
        return {
            p: {
                "type": c.ctx_type,
                "read_bytes": c.read_bytes,
                "write_bytes": c.write_bytes,
                "read_fraction": round(c.read_fraction, 4),
                "flops": c.flops,
                "collective_bytes": c.collective_bytes,
                "samples": c.samples,
            }
            for p, c in sorted(self._by_path.items())
        }
