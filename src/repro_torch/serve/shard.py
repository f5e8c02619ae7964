"""Sharded serving over a ``data x model`` mesh (port of
``repro/serve/shard.py``).

``ShardedServeEngine`` runs the same continuous-batching loop as
``ServeEngine`` over a ``launch.mesh.make_debug_mesh`` mesh of
``torch.device``s, from one controller, as the reference does (one host
scheduler, one pool facade, one packed readback per megastep):

* **data axis** — batch rows are sharded: data rank ``d`` owns the slot
  band ``[d * B/data, (d + 1) * B/data)``, runs the megastep over its rows
  only, and holds its own ``PagedKVPool`` shard (block table, host
  placement map, tier channels). A row's megastep arithmetic does not
  depend on the other rows, so the sharded engine serves the flat
  engine's tokens.
* **model axis** — the model ranks of a data band run the same decode on
  copies of their own (replicated, bitwise identical math on identical
  inputs), while the tensor-parallel collectives the reference's
  PartitionSpec rules imply (one all-reduce after the row-parallel
  attention output and MLP down projections per layer) are *modelled* and
  billed through the ``ici`` channel of ``core.channel``. One reduction
  does run per megastep: the replicas' packed readbacks meet in one
  ``torch.maximum`` on the first device (the reference's ``lax.pmax``),
  so a replica that drifted surfaces as a readback divergence.

Every rank holds its own tensors: its data band's cache leaves (each
(L, B/data, ...)) and slot state ((B/data, ...)), on its device; the
parameters are placed once per distinct device and shared by the ranks
there (they are read-only). A device may repeat in the mesh: the ranks on
it are logical ranks, the port's counterpart of the reference's forced
host devices. On a CUDA device each rank replays ``StepGraphs`` of its
own over its own static tensors; on the CPU it runs the eager
``_megastep_math``.

Slot ownership is the routing key for everything on the host: request
``r``'s KV blocks come from the pool shard owning ``r.slot``, block ids
live in a global namespace (``global = shard * blocks_per_shard +
local``), and migrations and fault evacuation never cross a shard
boundary. All pool shards live on the engine's device (the reference
keeps the pool's buffers on the default device), and the data ranks'
staged slabs land there, concatenated in slot order (``_stage_view``).

Cross-device traffic accounting (``IciMeter``) lands in
``paging_stats()["ici"]`` and in ``paging_stats()["by_path"]`` under
``/serve/ici/data`` and ``/serve/ici/model``, with the same
``channel_time_us`` duplex-vs-serial arithmetic as the DDR5/CXL host
channels.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core import offload
from repro_torch.core.hints import HintTree
from repro_torch.device import to_device
from repro_torch.models import layers as nn
from repro_torch.serve.engine import (EngineConfig, ServeEngine,
                                      _admit_rows, _device_megastep,
                                      _engine_step_math)
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.queue import Request, S_DONE, S_PREFILL


# ---------------------------------------------------------------------------
# ICI billing: cross-device collectives through the core.channel model
# ---------------------------------------------------------------------------

def _fresh_ici_path_stats() -> dict:
    return {"bytes": 0.0, "collectives": 0,
            "duplex_us": 0.0, "serial_us": 0.0}


class IciMeter:
    """Bill modelled cross-device collective traffic per mesh axis.

    Each axis is one ``ici`` link set (``core.channel.
    INTERCONNECT_PRESETS``); volumes use the ring-collective wire formulas
    (an all-reduce moves ``2(m-1)/m`` of the payload per device, an
    all-gather ``(m-1)/m`` of the gathered result). Billed time uses the
    same ``offload.channel_time_us`` duplex-vs-serial arithmetic as every
    other channel, so ``by_path["/serve/ici/*"]`` composes with the
    DDR5/CXL entries."""

    def __init__(self, mesh, link: channel_lib.ChannelModel | None = None):
        self.link = link or channel_lib.INTERCONNECT_PRESETS["ici"]
        self.axis_size = {str(a): int(mesh.shape[a])
                          for a in mesh.axis_names}
        self.by_path: dict[str, dict] = {}
        # the sharded engine attaches its Tracer (ICI busy intervals on the
        # DDR5/CXL tracks' modelled clock) and CaxRegistry; None = off
        self.trace = None
        self.telemetry = None

    def _bill(self, axis: str, read_bytes: float, write_bytes: float
              ) -> None:
        st = self.by_path.setdefault(f"/serve/ici/{axis}",
                                     _fresh_ici_path_stats())
        duplex_us = offload.channel_time_us(
            self.link, read_bytes, write_bytes)
        st["bytes"] += read_bytes + write_bytes
        st["collectives"] += 1
        st["duplex_us"] += duplex_us
        st["serial_us"] += offload.phase_separated_time_us(
            self.link, read_bytes, write_bytes)
        if self.trace is not None:
            self.trace.channel_transaction(
                [(f"ici:{axis}", read_bytes, write_bytes,
                  offload.phase_separated_time_us(
                      self.link, read_bytes, 0.0),
                  offload.phase_separated_time_us(
                      self.link, 0.0, write_bytes),
                  duplex_us, True)],
                duplex_us, name="collective")
        if self.telemetry is not None:
            self.telemetry.attribute(
                f"/serve/ici/{axis}",
                collective_bytes=read_bytes + write_bytes)

    def note_allreduce(self, axis: str, payload_bytes: float) -> None:
        """Ring all-reduce of ``payload_bytes`` per device over ``axis``:
        every device sends and receives ``2(m-1)/m`` of the payload, a
        full-duplex load."""
        m = self.axis_size.get(axis, 1)
        if m <= 1 or payload_bytes <= 0:
            return
        wire = 2.0 * (m - 1) / m * payload_bytes
        self._bill(axis, wire, wire)

    def note_allgather(self, axis: str, shard_bytes: float) -> None:
        """Ring all-gather of one ``shard_bytes`` contribution per device
        over ``axis``: each device forwards ``(m-1)`` shards, one
        direction."""
        m = self.axis_size.get(axis, 1)
        if m <= 1 or shard_bytes <= 0:
            return
        self._bill(axis, (m - 1) * shard_bytes, 0.0)

    def summary(self) -> dict:
        tot = _fresh_ici_path_stats()
        for st in self.by_path.values():
            for k in tot:
                tot[k] += st[k]
        tot["collectives"] = int(tot["collectives"])
        tot["links"] = dict(self.axis_size)
        return tot

    def snapshot_state(self) -> dict:
        return {p: dict(st) for p, st in self.by_path.items()}

    def load_state(self, state: dict) -> None:
        self.by_path = {p: dict(st) for p, st in state.items()}


# ---------------------------------------------------------------------------
# Per-shard fault routing
# ---------------------------------------------------------------------------

class ShardFaultView:
    """One pool shard's view of the shared ``FaultInjector``.

    The facade advances the fault clock once per paging transaction and
    pre-routes drained events; each shard's ``PagedKVPool`` sees an
    injector-shaped object whose ``tick`` does nothing, whose poison queue
    holds only the blocks that shard owns (in local ids), and whose
    offline list names the tier channels every shard loses (channel ``c``
    dies on every device's expander set; evacuation stays shard-local).
    Degradation, retry penalties and the stats dict go to the master
    injector, so the counters and the seeded retry stream stay global."""

    def __init__(self, master, shard: int, blocks_per_shard: int):
        self._master = master
        self._shard = shard
        self._per = blocks_per_shard
        self._poison: list[int] = []     # local ids, pre-routed
        self._offline: list[int] = []    # channel ids, shared

    # routed by the facade, once per transaction
    def push_poison(self, local_block: int) -> None:
        self._poison.append(local_block)

    def push_offline(self, channel: int) -> None:
        self._offline.append(channel)

    # the injector surface the shard pool consumes
    def tick(self) -> None:
        pass                             # the facade already ticked

    def drain_poison(self) -> list[int]:
        out, self._poison = self._poison, []
        return out

    def drain_offline(self) -> list[int]:
        out, self._offline = self._offline, []
        return out

    def rearm_poison(self, block: int) -> None:
        # nothing to corrupt on this shard yet: back onto the master queue
        # in global ids, so a later transaction routes it again
        self._master.rearm_poison(self._shard * self._per + int(block))

    def bandwidth_factor(self, c: int) -> float:
        return self._master.bandwidth_factor(c)

    def retry_penalty_us(self, c: int, attempt_us: float) -> float:
        return self._master.retry_penalty_us(c, attempt_us)

    def is_offline(self, c: int) -> bool:
        return self._master.is_offline(c)

    @property
    def stats(self) -> dict:
        return self._master.stats


# ---------------------------------------------------------------------------
# The sharded pool facade
# ---------------------------------------------------------------------------

class _ShardedHostView:
    """The engine-facing slice of the shards' ``TieredHostPool``s:
    capacity answered over the whole mesh (any shard degraded degrades
    the deployment; surviving capacity is the sum over shards)."""

    def __init__(self, shards):
        self._shards = shards

    @property
    def capacity_degraded(self) -> bool:
        return any(sh.host.capacity_degraded for sh in self._shards)

    def live_capacity(self) -> int:
        return sum(sh.host.live_capacity() for sh in self._shards)


class ShardedKVPool:
    """``n_shards`` independent ``PagedKVPool``s behind one pool interface,
    in a global block-id namespace.

    Each shard is configured as the flat engine's pool is (same
    ``n_blocks``, same ``hbm_blocks``, its own tier channels), so the
    engine's admission arithmetic, which reads ``hbm_capacity`` as
    per-slot-set headroom, schedules as the flat engine does. Block id
    ``g`` belongs to shard ``g // blocks_per_shard`` as local id
    ``g % blocks_per_shard``; every mutator routes by that rule, so
    migrations, victim picks and fault evacuation are shard-local.

    Non-LLM tenants pin to shard 0 (their ``alloc`` default): shard 0's
    global ids are its local ids, so the tenant-facing ``slot_of`` and
    ``hbm`` views hold unchanged. Every shard's tensors live on
    ``device``."""

    def __init__(self, n_shards: int, n_blocks: int, hbm_blocks: int,
                 block_shape, hints: HintTree | None = None,
                 tiers=None, faults=None,
                 device: torch.device | str = "cuda"):
        if n_shards < 1:
            raise ValueError("need at least one pool shard")
        self.n_shards = n_shards
        self.blocks_per_shard = n_blocks
        self.n_blocks = n_shards * n_blocks          # global id space
        self.hbm_capacity = hbm_blocks               # per shard (above)
        self.block_shape = tuple(block_shape)
        self._fx = faults
        self._views = []
        shard_faults: list = [None] * n_shards
        if faults is not None:
            self._views = [ShardFaultView(faults, s, n_blocks)
                           for s in range(n_shards)]
            shard_faults = self._views
        self.shards = [
            PagedKVPool(n_blocks, hbm_blocks, block_shape, hints=hints,
                        tiers=tiers, faults=shard_faults[s], device=device)
            for s in range(n_shards)]
        self.device = self.shards[0].device
        self.host = _ShardedHostView(self.shards)
        self.tiered = self.shards[0].tiered
        self._steps = 0                              # facade transactions

    # -- observability -------------------------------------------------------
    def attach_trace(self, tracer, prefix: str = "") -> None:
        """Fan the tracer out to every shard pool, each shard's channel
        tracks namespaced ``shard<s>/`` on the one modelled clock."""
        for s, sh in enumerate(self.shards):
            sh.attach_trace(tracer, prefix=f"{prefix}shard{s}/")

    def attach_telemetry(self, registry) -> None:
        for sh in self.shards:
            sh.attach_telemetry(registry)

    # -- id routing ---------------------------------------------------------
    def shard_of(self, block: int) -> int:
        return int(block) // self.blocks_per_shard

    def _split(self, blocks) -> list[np.ndarray]:
        """Global ids grouped per owning shard, order kept, as local ids."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        out = []
        for s in range(self.n_shards):
            lo = s * self.blocks_per_shard
            sel = blocks[(blocks >= lo)
                         & (blocks < lo + self.blocks_per_shard)]
            out.append(sel - lo)
        return out

    # -- allocation (request lifecycle) ------------------------------------
    def alloc(self, k: int = 1, shard: int = 0) -> list[int]:
        lo = shard * self.blocks_per_shard
        return [lo + b for b in self.shards[shard].alloc(k)]

    def free(self, blocks) -> None:
        for s, ids in enumerate(self._split(blocks)):
            if ids.size:
                self.shards[s].free(ids)

    def reclaim(self, blocks) -> None:
        for s, ids in enumerate(self._split(blocks)):
            if ids.size:
                self.shards[s].reclaim(ids)

    def invalidate(self, blocks) -> None:
        for s, ids in enumerate(self._split(blocks)):
            if ids.size:
                self.shards[s].invalidate(ids)

    def resident_blocks(self) -> np.ndarray:
        return np.concatenate(
            [sh.resident_blocks() + s * self.blocks_per_shard
             for s, sh in enumerate(self.shards)])

    # -- the per-transaction paging step ------------------------------------
    def step(self, needed, hint_path: str = "/serve/kv_cache") -> dict:
        return self.step_multi([(hint_path, needed)])

    def step_multi(self, groups) -> dict:
        """One mesh-wide paging transaction: the fault clock ticks once,
        drained events are routed to their owning shard (poison by block
        band, offline channels to every shard, each evacuating its own
        channel), then each shard with demand or pending events runs its
        own ``PagedKVPool.step_multi`` (its stream kernels launched on its
        own tensors). Reports come back in global ids."""
        self._steps += 1
        touched = set()
        if self._fx is not None:
            self._fx.tick()
            for b in self._fx.drain_poison():
                if 0 <= b < self.n_blocks:
                    s = self.shard_of(b)
                    self._views[s].push_poison(
                        b - s * self.blocks_per_shard)
                    touched.add(s)
                else:
                    # nothing to corrupt anywhere: keep the single pool's
                    # "re-arm until it lands"
                    self._fx.rearm_poison(b)
            for c in self._fx.drain_offline():
                for s, v in enumerate(self._views):
                    v.push_offline(c)
                    touched.add(s)

        per_shard: list[list[tuple[str, np.ndarray]]] = [
            [] for _ in range(self.n_shards)]
        for path, ids in groups:
            for s, local in enumerate(self._split(ids)):
                if local.size:
                    per_shard[s].append((path, local))
                    touched.add(s)

        report = {"page_ins": 0, "page_outs": 0}
        if self._fx is not None:
            report.update({"poisoned": [], "offline": [],
                           "casualties": [], "evacuated": 0})
        for s in sorted(touched):
            rep = self.shards[s].step_multi(per_shard[s])
            report["page_ins"] += rep["page_ins"]
            report["page_outs"] += rep["page_outs"]
            if self._fx is not None:
                lo = s * self.blocks_per_shard
                report["poisoned"].extend(
                    lo + b for b in rep.get("poisoned", ()))
                report["casualties"].extend(
                    lo + b for b in rep.get("casualties", ()))
                for c in rep.get("offline", ()):
                    if c not in report["offline"]:
                        report["offline"].append(c)
                report["evacuated"] += rep.get("evacuated", 0)
        return report

    # -- batched data plane --------------------------------------------------
    def _localize_write_ids(self, blocks: np.ndarray, s: int) -> np.ndarray:
        """Global ids -> shard-local for the write; whatever the shard does
        not own (the facade's sentinel pad, foreign rows) becomes the
        shard's own out-of-range sentinel, which ``PagedKVPool.write``
        drops on the host."""
        lo = s * self.blocks_per_shard
        mine = (blocks >= lo) & (blocks < lo + self.blocks_per_shard)
        out = np.full(blocks.shape, self.blocks_per_shard, np.int32)
        out[mine] = blocks[mine] - lo
        return out

    def write(self, blocks, data: torch.Tensor) -> None:
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        for s, sh in enumerate(self.shards):
            ids = self._localize_write_ids(blocks, s)
            if (ids < self.blocks_per_shard).any():
                sh.write(ids, data)

    def write_staged(self, blocks, staged, step: int) -> None:
        """Split inner step ``step``'s staged slab by slot ownership: ids
        are slot-major (``slot * max_fills + j``) over the global batch,
        so shard ``s`` owns the contiguous row band of its slots."""
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        slab = staged[step]
        rows = blocks.size // self.n_shards
        for s, sh in enumerate(self.shards):
            band = blocks[s * rows:(s + 1) * rows]
            ids = self._localize_write_ids(band, s)
            if (ids < self.blocks_per_shard).any():
                sh.write(ids, slab[s * rows:(s + 1) * rows])

    def read(self, blocks) -> torch.Tensor:
        blocks = np.asarray(blocks, np.int32).reshape(-1)
        parts = []
        order = []
        for s, sh in enumerate(self.shards):
            lo = s * self.blocks_per_shard
            idx = np.flatnonzero(
                (blocks >= lo) & (blocks < lo + self.blocks_per_shard))
            if idx.size:
                parts.append(sh.read(blocks[idx] - lo))
                order.append(idx)
        if not parts:
            raise ValueError("read of no blocks")
        gathered = torch.cat(parts, dim=0)
        inv = np.argsort(np.concatenate(order))
        return gathered[to_device(inv.astype(np.int64), self.device)]

    # -- tier migrations -----------------------------------------------------
    def migrate_tiers(self, max_moves: int | None = None) -> dict:
        moves = 0
        for sh in self.shards:
            moves += sh.migrate_tiers(max_moves)["migrations"]
        return {"migrations": moves}

    # -- snapshot/restore ----------------------------------------------------
    def flush_dirty(self, hint_path: str = "/serve/kv_cache") -> dict:
        """The snapshot's durability barrier, per shard. Each shard's
        flush bills its own tier channels (the per-device expander sets
        write in parallel), so the mesh's flush time is the slowest
        shard's, while ``page_outs`` counts every shard's."""
        report = {"page_outs": 0, "flush_us": 0.0}
        for sh in self.shards:
            r = sh.flush_dirty(hint_path)
            report["page_outs"] += r["page_outs"]
            report["flush_us"] = max(report["flush_us"], r["flush_us"])
        return report

    def snapshot_state(self) -> dict:
        """One state sub-tree per shard plus the facade's transaction
        counter, persisted by the caller as one checkpoint."""
        state = {f"shard{s}": sh.snapshot_state()
                 for s, sh in enumerate(self.shards)}
        state["meta"] = {"steps": self._steps, "n_shards": self.n_shards}
        return state

    def load_state(self, state: dict) -> None:
        meta = state["meta"]
        if int(meta["n_shards"]) != self.n_shards:
            raise ValueError(
                f"pool snapshot has {meta['n_shards']} shards, mesh has "
                f"{self.n_shards} — restore needs the crashed run's mesh")
        for s, sh in enumerate(self.shards):
            sh.load_state(state[f"shard{s}"])
        self._steps = int(meta["steps"])

    # -- tenant-facing views (tenants pin to shard 0) ------------------------
    @property
    def hbm(self) -> torch.Tensor:
        return self.shards[0].hbm

    @property
    def slot_of(self) -> np.ndarray:
        # indexable by global id; shard 0's band leads, so a tenant's
        # (shard-0) ids index their own shard's HBM slots
        return np.concatenate([sh.slot_of for sh in self.shards])

    @property
    def _allocated(self) -> np.ndarray:
        return np.concatenate([sh._allocated for sh in self.shards])

    # -- reporting -----------------------------------------------------------
    @property
    def stats(self) -> dict:
        merged = None
        for sh in self.shards:
            if merged is None:
                merged = {k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in sh.stats.items()}
                merged["by_path"] = {p: dict(st) for p, st
                                     in sh.stats["by_path"].items()}
                continue
            for k, v in sh.stats.items():
                if k == "by_path":
                    for p, st in v.items():
                        dst = merged["by_path"].setdefault(
                            p, {kk: 0 for kk in st})
                        for kk, vv in st.items():
                            dst[kk] += vv
                elif isinstance(v, (int, float)):
                    merged[k] += v
        merged["steps"] = self._steps      # transactions, not shard calls
        return merged

    def duplex_speedup(self, hint_path: str | None = None) -> float:
        st = self.stats
        if hint_path is not None:
            st = st["by_path"].get(hint_path)
            if st is None:
                return 1.0
        if st["duplex_us"] == 0:
            return 1.0
        return st["serial_us"] / st["duplex_us"]

    def tier_speedup(self) -> float:
        st = self.stats
        if st["tier_us"] == 0:
            return 1.0
        return st["ddr5_us"] / st["tier_us"]

    def tier_stats(self) -> dict:
        """The pools' schema (core.metrics) plus the sharded extras:
        per-shard detail under ``"shards"`` and the merged per-channel
        view keyed ``shard<s>/<channel>``."""
        st = self.stats
        per_shard = [sh.tier_stats() for sh in self.shards]
        return {"tiered": self.tiered,
                "channels": {f"shard{s}/{name}": ch
                             for s, ts in enumerate(per_shard)
                             for name, ch in ts["channels"].items()},
                "shards": per_shard,
                "migrations": st["migrations"],
                "migrate_us": round(st["migrate_us"], 3),
                "tier_us": round(st["tier_us"], 3),
                "ddr5_us": round(st["ddr5_us"], 3),
                "tier_speedup": round(self.tier_speedup(), 4)}

    def reset_stats(self) -> None:
        self._steps = 0
        for sh in self.shards:
            sh.reset_stats()

    # -- invariants ----------------------------------------------------------
    def check_invariants(self) -> None:
        """Every shard's block-table and placement invariants, plus the
        cross-shard ownership contract: the shards' allocated sets are
        disjoint in the global namespace and no shard's tables name an id
        outside its own band."""
        for sh in self.shards:
            sh.check_invariants()
            if sh.n_blocks != self.blocks_per_shard:
                raise AssertionError("shard block-band size drifted")
        seen: set[int] = set()
        for s, sh in enumerate(self.shards):
            lo = s * self.blocks_per_shard
            owned = {lo + int(b) for b in np.flatnonzero(sh._allocated)}
            if seen & owned:
                raise AssertionError(
                    f"cross-shard ownership overlap: {sorted(seen & owned)}")
            seen |= owned


# ---------------------------------------------------------------------------
# The sharded engine
# ---------------------------------------------------------------------------

def _canon(device) -> torch.device:
    """``device`` with its CUDA index made explicit."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device: torch.device):
    """The CUDA device context of ``device`` (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _to(tree, device: torch.device):
    """A params tree (nested dicts, lists and tuples of tensors) moved to
    ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class _Rank:
    """One (data, model) rank: its device, the parameters placed there,
    its own copies of its data band's cache rows, pristine rows and slot
    state, and on a CUDA device its own step graphs."""

    def __init__(self, data: int, model: int, device: torch.device,
                 params, cache, cache0, dev: dict):
        self.data, self.model, self.device = data, model, device
        self.params, self.cache, self.cache0, self.dev = (params, cache,
                                                          cache0, dev)
        self.graphs: StepGraphs | None = None


class ShardedServeEngine(ServeEngine):
    """``ServeEngine`` over a ``data x model`` mesh.

    Everything on the host (admission, trajectory planning, paging plans,
    speculation, reconcile) is inherited unchanged: the schedule is host
    arithmetic that does not know the batch is sharded. The overrides are
    the device-placement seams:

    * the megastep runs once per rank over the rank's own tensors, and
      the ranks' packed readbacks meet in one readback per megastep;
    * admission and a snapshot restore write each slot's rows into every
      rank of its data band; a snapshot captures the bands gathered;
    * the KV pool is a ``ShardedKVPool`` (one shard per data rank) and
      block allocation routes by the owning slot's shard;
    * the staged write-through slabs land on the pool device
      (``_stage_view``), a device-to-device copy, never a host sync;
    * modelled ICI traffic for the megastep's collectives is billed at
      dispatch (``IciMeter``) and surfaces in ``paging_stats()``.

    ``_graphs`` is ``ServeEngine``'s: per rank here."""

    def __init__(self, api, params, cfg: EngineConfig,
                 hints: HintTree | None = None, mesh=None, *,
                 _graphs: bool | None = None):
        if mesh is None:
            from repro_torch.launch.mesh import make_debug_mesh
            mesh = make_debug_mesh()
        self.mesh = mesh
        self.data_size = int(mesh.shape["data"])
        self.model_size = int(mesh.shape["model"])
        if cfg.max_batch % self.data_size:
            raise ValueError(
                f"max_batch={cfg.max_batch} must divide evenly over the "
                f"data axis ({self.data_size} ranks) — every rank owns a "
                f"fixed slot band")
        self.slots_per_shard = cfg.max_batch // self.data_size
        self._ici = IciMeter(mesh)
        # the base engine builds the whole-batch state on the engine's
        # device; the ranks take their bands of it below
        super().__init__(api, params, cfg, hints, _graphs=False)
        kinds = {torch.device(d).type for d in mesh.devices.flat}
        if kinds != {self.device.type}:
            raise ValueError(f"the mesh's devices are {sorted(kinds)} but "
                             f"the engine is configured for {self.device}")
        # the ICI links join the tracer's modelled clock and the CAX tree
        self._ici.trace = self._tracer
        self._ici.telemetry = self.telemetry
        if _graphs is None:
            _graphs = self.device.type == "cuda"
        self.ranks = self._build_ranks(_graphs)
        self.cache = self._cache0 = self._dev = None
        # per-layer tensor-parallel psum payload (bf16 activations): the
        # row-parallel rules (attn/wo and mlp/w_down sharded on the
        # contraction dim) imply one all-reduce each
        d_model = (getattr(api.cfg, "d_model", None)
                   or getattr(api.cfg, "hidden", 0) or 0)
        n_layers = (getattr(api.cfg, "num_layers", None)
                    or getattr(api.cfg, "n_layers", 0) or 1)
        self._tp_psums_per_micro = 2 * int(n_layers)
        self._tp_psum_bytes = float(self.slots_per_shard * d_model * 2)

    def _build_ranks(self, graphs: bool) -> list[_Rank]:
        """One rank per mesh entry, in (data, model) order, each with
        copies of its band of the base engine's state on its device."""
        n = self.slots_per_shard
        placed: dict[torch.device, object] = {}
        ranks = []
        for d in range(self.data_size):
            band = slice(d * n, (d + 1) * n)
            for m in range(self.model_size):
                device = _canon(self.mesh.devices[d, m])
                if device not in placed:
                    placed[device] = (
                        self.params if device == _canon(self.device)
                        else _to(self.params, device))

                def rows(t, band=band, device=device):
                    return t[:, band].clone(
                        memory_format=torch.contiguous_format).to(device)

                ranks.append(_Rank(
                    d, m, device, placed[device],
                    nn.tree_map(rows, self.cache),
                    nn.tree_map(rows, self._cache0),
                    {k: v[band].clone().to(device)
                     for k, v in self._dev.items()}))
        if graphs:
            step = _engine_step_math(
                self.api, self.cfg.prefill_chunk,
                self.cfg.block_tokens if self.paged else None)
            for rk in ranks:
                with _on(rk.device):
                    rk.graphs = StepGraphs(
                        step, rk.params, rk.cache, rk.dev,
                        max(1, self.cfg.prefill_chunk), extract=self.paged,
                        capture=rk.device.type == "cuda")
        return ranks

    @property
    def n_graphs(self) -> int:
        """CUDA graphs over all ranks: at most prefill_chunk + 1 each."""
        return sum(len(rk.graphs) for rk in self.ranks
                   if rk.graphs is not None)

    @property
    def capture_s(self) -> float:
        """Seconds the ranks' step graphs took to capture."""
        return sum(rk.graphs.capture_s for rk in self.ranks
                   if rk.graphs is not None)

    # -- sharding seams ------------------------------------------------------
    def _make_pool(self, block_shape) -> ShardedKVPool:
        return ShardedKVPool(
            self.data_size, self.cfg.resolved_pool_blocks(),
            self.cfg.hbm_blocks, block_shape, hints=self.hints,
            tiers=self.cfg.tiers, faults=self.cfg.faults,
            device=self.device)

    def _alloc_block(self, r: Request) -> list[int]:
        return self.pool.alloc(1, shard=r.slot // self.slots_per_shard)

    def _run_megastep(self, k: int, micro: tuple):
        """The megastep on every rank, then one packed readback: the model
        replicas of each data band reduced with ``torch.maximum`` on the
        engine's device (a bitwise no-op on agreeing replicas, a real
        cross-device copy where the devices differ), the bands
        concatenated in slot order. ``staged`` is each data band's
        slabs, from its first model rank."""
        mega = self._mega_fn(k)
        lead = self.device
        packs: list[torch.Tensor | None] = [None] * self.data_size
        slabs: list = [None] * self.data_size
        for rk in self.ranks:
            with _on(rk.device):
                rk.dev, packed, staged = _device_megastep(
                    mega, rk.graphs, rk.params, rk.cache, rk.dev, micro,
                    self.paged)
            packed = packed.to(lead)
            if packs[rk.data] is None:
                packs[rk.data], slabs[rk.data] = packed, staged
            else:
                packs[rk.data] = torch.maximum(packs[rk.data], packed)
        packed = packs[0] if self.data_size == 1 else torch.cat(packs)
        return packed, (slabs if self.paged else None)

    def _stage_view(self, staged):
        """The data bands' staged slabs as one slab per inner step on the
        pool device, rows in slot order (device-to-device: the megastep's
        one deferred device-to-host sync stays the packed readback)."""
        if staged is None:
            return None
        if self.data_size == 1:
            return [st.to(self.device) for st in staged[0]]
        return [torch.cat([band[t].to(self.device) for band in staged])
                for t in range(len(staged[0]))]

    def _install_rows(self, mask: np.ndarray, prompts: np.ndarray,
                      plen: np.ndarray, mnew: np.ndarray) -> None:
        """Admission's device writes into every rank of each admitted
        slot's data band: pristine cache rows and the new slot state, in
        place."""
        n = self.slots_per_shard
        for rk in self.ranks:
            band = slice(rk.data * n, (rk.data + 1) * n)
            if not mask[band].any():
                continue
            dev = rk.device
            rows = to_device(np.flatnonzero(mask[band]).astype(np.int64),
                             dev)
            for leaf, leaf0 in zip(nn.tree_leaves(rk.cache),
                                   nn.tree_leaves(rk.cache0), strict=True):
                leaf[:, rows] = leaf0[:, rows]
            new = _admit_rows(
                rk.dev, to_device(mask[band], dev),
                to_device(prompts[band], dev), to_device(plen[band], dev),
                to_device(mnew[band], dev))
            for key, leaf in rk.dev.items():
                leaf.copy_(new[key])

    def _device_state(self) -> tuple[dict, dict]:
        """Whole-batch copies on the engine's device, each data band from
        its first model rank."""
        lead = [rk for rk in self.ranks if rk.model == 0]
        dev = {k: torch.cat([rk.dev[k].to(self.device) for rk in lead])
               for k in lead[0].dev}
        # the paged (flat K/V) cache: snapshots cover no other family
        cache = {k: torch.cat([rk.cache[k].to(self.device) for rk in lead],
                              dim=1)
                 for k in lead[0].cache}
        return dev, cache

    def _place_device_state(self, dev: dict, cache: dict) -> None:
        """Copy each data band of the restored whole-batch state into every
        rank that holds it, in place (the step graphs read those
        tensors)."""
        n = self.slots_per_shard
        for rk in self.ranks:
            band = slice(rk.data * n, (rk.data + 1) * n)
            for key, leaf in rk.dev.items():
                leaf.copy_(dev[key][band])
            for key, leaf in rk.cache.items():
                leaf.copy_(cache[key][:, band])

    # -- ICI accounting ------------------------------------------------------
    def _dispatch(self, rec):
        rec = super()._dispatch(rec)
        if rec.live:
            self._bill_ici(rec)
        return rec

    def _bill_ici(self, rec) -> None:
        """Bill the megastep's modelled collective traffic: per inner step,
        the tensor-parallel psums the partition rules imply (none on a
        step where every row is done: the model does not run) on the
        model axis; per megastep, the packed readback's reduction (model
        axis) and its gather, with the staged slabs', onto the pool
        device (data axis)."""
        n_micro = max(1, self.cfg.prefill_chunk)
        if self.model_size > 1:
            for t in range(rec.k):
                steps_t = [rec.traj[r.rid][t] for r in rec.live
                           if r.rid in rec.traj]
                if not any(st.emitted or st.state != S_DONE
                           for st in steps_t):
                    continue
                # prefill rows run every micro-step; decode-only steps
                # run micro-step 0 alone
                micro = n_micro if any(
                    st.state == S_PREFILL or st.transition
                    for st in steps_t) else 1
                for _ in range(micro * self._tp_psums_per_micro):
                    self._ici.note_allreduce("model", self._tp_psum_bytes)
            # the packed readback's reduction: (B_local, 3+K) int32
            self._ici.note_allreduce(
                "model", float(self.slots_per_shard * (3 + rec.k) * 4))
        if self.data_size > 1:
            # the packed readback crosses the mesh once per megastep...
            self._ici.note_allgather(
                "data", float(self.slots_per_shard * (3 + rec.k) * 4))
            if self.paged:
                # ...and the staged slabs' foreign rows ride ICI to the
                # pool device (the _stage_view copy)
                bt = self.cfg.block_tokens
                max_fills = -(-n_micro // bt)
                kv_dims = self.pool.block_shape[1]
                shard_bytes = (rec.k * self.slots_per_shard * max_fills
                               * bt * kv_dims * 2)
                self._ici.note_allgather("data", float(shard_bytes))

    # -- snapshot seams ------------------------------------------------------
    def _snapshot_extra_state(self) -> dict:
        return {"ici": self._ici.snapshot_state()}

    def _load_extra_state(self, extra: dict) -> None:
        self._ici.load_state(extra.get("ici", {}))

    # -- reporting -----------------------------------------------------------
    def paging_stats(self) -> dict:
        st = super().paging_stats()
        st["mesh"] = {"data": self.data_size, "model": self.model_size}
        st["ici"] = self._ici.summary()
        st["by_path"] = {**st.get("by_path", {}),
                         **{p: dict(s) for p, s
                            in self._ici.by_path.items()}}
        return st
