"""ServeEngine — continuous-batching decode over the duplex-paged KV pool.

Port of ``repro/serve/engine.py``, with tenants (``add_tenant``: the
KV-store and vector-search ``WorkloadAPI``s of ``serve/workloads.py``),
the tiered host pool (``EngineConfig.tiers``, boundary migrations), the
fault layer (``EngineConfig.faults``) and the tracing plane
(``EngineConfig.trace``: ``plan`` / ``dispatch`` / ``reconcile`` /
``snapshot_cut`` / ``restore`` spans on the host clock with the phases
nested in them, the requests' submission and admission stamps, the pool's
channel timelines on the modelled clock, fault instants; ``metrics()``)
and the crash-consistency layer (``EngineConfig.snapshot_every``:
consistent cuts, a write-ahead journal and ``restore()``,
``serve/snapshot.py``). The structure is the reference's:

  1. **admission** at megastep boundaries — free batch slots, and each
     tenant's free slots, are offered to the ``RequestQueue``, whose
     policy picks which arrived requests join the running set;
  2. **megastep** — up to K engine steps run as one host dispatch. Each
     engine step is up to ``prefill_chunk`` micro-steps that advance every
     active slot (prompt token while prefilling, last sampled token while
     decoding) with the argmax fed straight back on the device. Per-slot
     state lives in int32 device tensors (``_dev``); ``Request`` objects
     are host mirrors refreshed from ONE packed (B, 3+K) readback per
     megastep;
  3. **KV paging** — after each inner step the blocks it filled are staged
     on the device, written through to the ``PagedKVPool``, and the
     batch's block demand, merged with every tenant's, is made resident in
     one pool transaction (one plan and one stream-kernel launch per hint
     scope); then each tenant runs its device compute on the resident
     blocks. A megastep with tenant work and no live LLM row still runs
     each inner step's transaction and tenant compute, with no program
     dispatch and no readback;
  4. **boundary** — a tiered pool rebalances host placement
     (``PagedKVPool.migrate_tiers``), and under a fault plan each paging
     transaction's fault report fails the owning requests (poisoned
     blocks, evacuation casualties) and degraded capacity sheds load.
     All of it is host arithmetic plus in-place device copies between
     replays: no host sync, and the static tensors stay the same objects.

Everything about an engine step except the token values is deterministic
host arithmetic (``_simulate_row``), so the host plans all K steps'
paging without waiting for the device and uses the readback only for the
token values (a mismatch in the counters raises). The same determinism
gives the host the number of micro-steps in each inner step that advance
any row: the reference skips a micro-step with no movers with a
``lax.cond``; the port runs exactly the micro-steps that have movers and
never asks the device.

Where the reference jits and donates, the port updates in place: the
dense cache is written by ``decode_step`` in place, a recurrent cache
(RWKV6, Zamba2's Mamba state) gets the moving rows of ``decode_step``'s
new leaves written into it in place (the reference's frozen-row keep),
admission and slot recycling rewrite the slot state and cache rows in
place, and the pool
commits into its tier tensors in place. On a CUDA device the engine
steps are CUDA graphs over those static tensors (``serve/graphs.py``, the
counterpart of the reference's jitted program): a megastep is one replay
per inner step, and the paging transactions, tenant compute, policy
feedback and host planning run eagerly between replays. On the CPU the
megastep runs ``_megastep_math`` eagerly. A cache may be a nested dict
(Zamba2's ``{"mamba": ..., "attn": ...}``, Whisper's ``{"self": ...,
"cross_k", "cross_v"}``): the keep and the slot recycling walk its leaves
(``layers.tree_leaves``), each with the batch on dim 1. Only the dense
family's flat K/V cache pages; for every other cache paging is gated off,
as in the reference.

``pipeline_depth = 2`` splits each megastep into plan / dispatch /
reconcile and keeps one dispatched megastep's readback deferred while the
next boundary is planned and dispatched. On a CUDA device the packed
readback is copied with ``non_blocking=True`` into pinned host memory
behind a recorded CUDA event, and ``_reconcile`` waits on that event —
the host never blocks at a boundary with work still to enqueue.
``stats()['host_blocked']`` counts the boundaries where the host consumed
a readback with nothing dispatched ahead of it (== megasteps at depth 1;
1 per run — the final drain — at depth 2).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import policies as policies_lib
from repro_torch.core.faults import fresh_fault_stats
from repro_torch.core.hints import HintTree, default_serving_hints
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.telemetry import CaxRegistry
from repro_torch.device import resolve_device, to_device
from repro_torch.models import layers as nn
from repro_torch.models.registry import ModelAPI
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.queue import (DECODE, DONE, FAILED, PREFILL,
                                     STATE_OF_CODE, Request, RequestQueue,
                                     S_DECODE, S_DONE, S_EMPTY, S_PREFILL)
from repro_torch.serve.snapshot import SnapshotManager, fresh_snapshot_stats
from repro_torch.serve.trace import Tracer, maybe_phase


class EngineStallError(RuntimeError):
    """``run()`` made no progress for ``cfg.stall_boundaries`` consecutive
    megastep boundaries while requests are still pending. ``rids`` names
    the stuck requests."""

    def __init__(self, message: str, rids):
        super().__init__(message)
        self.rids = list(rids)


@dataclasses.dataclass(frozen=True)
class _RowStep:
    """One live row's predicted post-state for one inner step of a
    megastep (host-deterministic; see ``ServeEngine._simulate_row``)."""
    state: int          # S_* code after the step
    consumed: int       # prompt tokens consumed after the step
    n_gen: int          # tokens generated after the step
    written: int        # tokens resident in the dense cache after it
    emitted: bool       # did this step emit a sample?
    transition: bool    # was it the PREFILL->DECODE transition step?


class _Readback:
    """The megastep's packed (B, 3+K) int32 readback, in flight. On a CUDA
    device it is copied into pinned host memory with ``non_blocking=True``
    behind a recorded event, so enqueueing it never waits for the device;
    ``wait`` blocks on the event."""

    def __init__(self, packed: torch.Tensor):
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = packed, None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unreconciled megastep — the pipeline's unit of
    speculation. ``_plan`` fills the deterministic fields, ``_dispatch``
    attaches the in-flight readback plus a journal of the speculative pool
    mutations, ``_reconcile`` consumes it."""
    now: int            # first engine step covered by the megastep
    k: int              # inner steps fused into the dispatch
    admitted: int       # requests admitted at the boundary
    live: list          # rows live at dispatch time
    traj: dict          # rid -> k predicted _RowSteps
    micro: tuple        # per inner step: leading micro-steps with movers
    packed: _Readback | None = None
    report: dict = dataclasses.field(default_factory=dict)
    journal: list = dataclasses.field(default_factory=list)
                        # ("alloc" | "free", request, [block ids])


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 4          # running decode slots
    cache_len: int = 128        # dense cache depth per slot
    block_tokens: int = 16      # KV page granularity (tokens)
    hbm_blocks: int = 8         # pool HBM slots, shared by the whole batch
    pool_blocks: int = 0        # logical pool capacity (0 = auto)
    prefill_chunk: int = 4      # prompt tokens consumed per engine step
    max_queue: int = 32
    policy: str = "hinted"      # admission policy (core.policies registry)
    paging: bool = True         # False: pure continuous batching, no pool
    megastep: int = 1           # engine steps fused per host dispatch (K);
                                # run() adapts K <= megastep between
                                # admission events. 1 = classic step loop.
    tiers: str | tuple | None = None
                                # host-memory channel set for the pool
                                # ("ddr5:2,cxl:2"); None = flat pool
    tier_migrate: bool = True   # rebalance host placement at megastep
                                # boundaries (tiered pools only)
    pipeline_depth: int = 1     # megastep boundaries in flight: 1 = plan,
                                # dispatch, block on the readback; 2 = plan
                                # and dispatch t+1 before reconciling t.
    faults: object = None       # core.faults.FaultInjector (or None):
                                # a deterministic fault plan serviced by
                                # the pool's transactions; needs paging
    stall_boundaries: int = 64  # run(): consecutive zero-progress
                                # boundaries before EngineStallError
    snapshot_every: int = 0     # crash-consistent cut cadence in megastep
                                # boundaries (serve.snapshot); 0 = disabled,
                                # zero hooks anywhere on the hot path
    snapshot_dir: str | None = None
                                # snapshot + write-ahead-journal directory;
                                # required when snapshot_every > 0
    trace: object = None        # observability plane (serve.trace): a
                                # Tracer, True (in-memory), or a path str
                                # for Perfetto export. None = disabled,
                                # zero hooks anywhere on the hot path and
                                # bit-exact with an untraced engine.
    device: str = "cuda"        # where the cache, slot state and pool live

    def resolved_pool_blocks(self) -> int:
        if self.pool_blocks:
            return self.pool_blocks
        per_seq = math.ceil(self.cache_len / self.block_tokens)
        return max(2 * self.hbm_blocks, per_seq * self.max_batch)


def _kv_cache_leaves(cache):
    """The transformer-family stacked cache dict, or None if the arch's
    cache has no token-indexed K/V (paging is gated off for those)."""
    if (isinstance(cache, dict) and {"k", "v", "pos"} <= set(cache)
            and cache["k"].dim() == 5):
        return cache
    return None


def _extract_blocks_math(k, v, slot_idx, t0, *, block_tokens: int):
    """Gather KV blocks from the dense cache, batched over (slot, t0).

    k/v: (L, B, W, KV, hd). slot_idx/t0: (n,) int — a fixed-width vector
    padded with dummy entries. Returns (n, block_tokens, kv_dims) bf16
    slabs with kv_dims = L * 2 * KV * hd (per token: layer-major, then
    K/V, then heads) — the block-table-indexed read the pool pages."""
    W = k.shape[2]
    idx = ((t0[:, None] + torch.arange(block_tokens, device=k.device)
            [None, :]) % W).long()                       # (n, bt)
    sl = slot_idx.long()[:, None]
    kv = torch.stack([k[:, sl, idx], v[:, sl, idx]], dim=3)
    # (L, n, bt, 2, KV, hd) -> (n, bt, L, 2, KV, hd)
    kv = kv.permute(1, 2, 0, 3, 4, 5)
    return kv.reshape(kv.shape[0], block_tokens, -1).to(torch.bfloat16)


def _written_of(dev):
    """Tokens whose KV is in the dense cache, per slot: all consumed prompt
    tokens plus every generated token that has been fed back."""
    return torch.where(dev["state"] == S_PREFILL, dev["consumed"],
                       torch.clamp(dev["consumed"] + dev["n_gen"] - 1,
                                   min=0))


def _admit_rows(dev, mask, prompts, prompt_len, max_new):
    """Install admitted requests into their slots' device state rows
    (fixed-width: ``mask``/``prompts`` span the full batch)."""
    def sc(cur, new):
        return torch.where(mask, new, cur)

    return {
        "state": sc(dev["state"], S_PREFILL),
        "tok": sc(dev["tok"], prompts[:, 0]),
        "consumed": sc(dev["consumed"], 0),
        "n_gen": sc(dev["n_gen"], 0),
        "prompt_len": sc(dev["prompt_len"], prompt_len),
        "max_new": sc(dev["max_new"], max_new),
        "prompt": torch.where(mask[:, None], prompts, dev["prompt"]),
    }


def _pack(dev, toks):
    """The (B, 3+K) int32 readback: state | consumed | n_gen | tok_0 ..
    tok_{K-1}."""
    return torch.cat(
        [dev["state"][:, None], dev["consumed"][:, None],
         dev["n_gen"][:, None], torch.stack(toks, dim=1)], dim=1)


def _engine_step_math(api: ModelAPI, n_micro: int, block_tokens: int | None):
    """One engine step as ``step(params, cache, dev, active) -> (dev,
    staged)``: the first ``active`` of its ``n_micro`` micro-steps (the
    rest have no movers) and, with ``block_tokens`` set, the blocks the
    step filled, else ``staged`` is None. ``cache`` is updated in place
    (a recurrent cache only in the rows that move); ``dev`` is not
    written, the new slot state is returned."""
    ring = api.cache_kind == "ring"
    n_micro = max(1, n_micro)
    extract = block_tokens is not None
    max_fills = -(-n_micro // block_tokens) if extract else 0

    def micro_steps(params, cache, dev, active: int):
        B = dev["state"].shape[0]
        P = dev["prompt"].shape[1]
        brange = torch.arange(B, device=dev["state"].device)
        for m in range(min(active, n_micro)):
            prefilling = dev["state"] == S_PREFILL
            decoding = dev["state"] == S_DECODE
            # micro-step 0 advances every live row; later micro-steps only
            # the still-prefilling rows (chunked prefill without stalling
            # running decodes).
            movers = prefilling | (decoding & (m == 0))
            written = torch.where(
                prefilling, dev["consumed"],
                torch.clamp(dev["consumed"] + dev["n_gen"] - 1, min=0))
            toks = torch.where(movers, dev["tok"], 0)
            # non-movers see a dummy token; for a ring cache its K/V lands
            # at the row's next write position and is overwritten by the
            # row's next real token before any real query attends it, so
            # the ring step's in-place writes stand and its returned cache
            # is dropped.
            logits, new_cache = api.decode_step(params, cache, toks,
                                                written)
            if not ring:
                # a recurrent state (RWKV wkv state and shift tokens, Mamba
                # conv window and SSM state) is advanced irreversibly by
                # any token it sees, the dummy too: every non-mover row
                # keeps its pre-step leaves, and the movers' new rows are
                # written into the cache in place. A leaf returned as the
                # same tensor was written in place as a ring (zamba2's
                # shared attention): the ring argument above holds for it.
                for leaf, new in zip(nn.tree_leaves(cache),
                                     nn.tree_leaves(new_cache), strict=True):
                    if new is leaf:
                        continue
                    keep = movers.reshape((1, -1) + (1,) * (leaf.dim() - 2))
                    leaf.copy_(torch.where(keep, new, leaf))
            picked = torch.argmax(logits, dim=-1).to(torch.int32)

            pref_mover = movers & prefilling
            consumed = dev["consumed"] + pref_mover.to(torch.int32)
            fin_pref = pref_mover & (consumed == dev["prompt_len"])
            emit = (movers & decoding) | fin_pref
            n_gen = dev["n_gen"] + emit.to(torch.int32)
            state = torch.where(fin_pref, S_DECODE, dev["state"])
            state = torch.where(emit & (n_gen >= dev["max_new"]),
                                S_DONE, state)
            nxt = dev["prompt"][brange,
                                torch.clamp(consumed, max=P - 1).long()]
            tok = torch.where(
                movers, torch.where(state == S_PREFILL, nxt, picked),
                dev["tok"])
            dev = dict(dev, state=state, tok=tok, consumed=consumed,
                       n_gen=n_gen)
        return dev

    def step(params, cache, dev, active: int):
        if not extract:
            return micro_steps(params, cache, dev, active), None
        fill_base = _written_of(dev) // block_tokens
        dev = micro_steps(params, cache, dev, active)
        # fixed-width cursor arithmetic over the pre-step write positions:
        # row j of the slab is candidate block j % max_fills of slot
        # j // max_fills
        j = torch.arange(dev["state"].shape[0] * max_fills,
                         device=fill_base.device)
        slot_idx = j // max_fills
        t0 = (fill_base[slot_idx] + j % max_fills) * block_tokens
        return dev, _extract_blocks_math(cache["k"], cache["v"], slot_idx,
                                         t0, block_tokens=block_tokens)

    return step


def _megastep_math(api: ModelAPI, n_micro: int, n_steps: int,
                   block_tokens: int | None):
    """The megastep: ``n_steps`` consecutive engine steps as one function
    ``mega(params, cache, dev, micro) -> (dev, packed[, staged])``.

    ``cache`` is updated in place (a recurrent cache only in the rows that
    move). ``micro[t]`` is the number of leading
    micro-steps of inner step t that advance any row (from the host's
    trajectories); the remaining micro-steps of the step have no movers
    and change nothing, so they are not run. ``packed`` is the (B, 3+K)
    int32 readback (state | consumed | n_gen | tok_0 .. tok_{K-1}): a row
    emits at most one token per engine step and after an emitting
    micro-step the feed token *is* the sample, so these are the complete
    host-mirror delta. With ``block_tokens`` set, ``staged[t]`` holds the
    blocks inner step t filled — fixed-width cursor arithmetic over the
    pre-step write positions, ``max_fills`` candidate blocks per slot —
    as (B*max_fills, block_tokens, kv_dims) bf16 (padding rows are
    dropped by the pool's sentinel ids)."""
    step = _engine_step_math(api, n_micro, block_tokens)

    def mega(params, cache, dev, micro):
        toks, staged = [], []
        for t in range(n_steps):
            dev, st = step(params, cache, dev, micro[t])
            toks.append(dev["tok"])
            staged.append(st)
        if block_tokens is not None:
            return dev, _pack(dev, toks), staged
        return dev, _pack(dev, toks)

    return mega


def _device_megastep(mega, graphs, params, cache, dev, micro: tuple,
                     paged: bool):
    """One megastep over one set of device state: a replay of ``graphs``
    per inner step (each step's tokens and staged slab copied out before
    the next) when they are set, else the eager ``mega``. Returns (slot
    state, packed readback, staged slabs or None)."""
    if graphs is not None:
        toks, staged = [], []
        for m in micro:
            tok, st = graphs.step(m)
            toks.append(tok)
            staged.append(st)
        return dev, _pack(dev, toks), (staged if paged else None)
    out = mega(params, cache, dev, micro)
    return out if paged else (*out, None)


class ServeEngine:
    """Continuous-batching serving engine for one ``ModelAPI``.

    ``_graphs`` is private: None (the default) replays CUDA graphs of the
    engine steps on a CUDA device and runs the megastep eagerly on the
    CPU; False runs the eager megastep on either (the on-card comparison
    of the two); True on the CPU runs the graphs' static-buffer
    bookkeeping with direct calls in place of replays (the CPU tests)."""

    def __init__(self, api: ModelAPI, params, cfg: EngineConfig,
                 hints: HintTree | None = None, *,
                 _graphs: bool | None = None):
        if cfg.megastep < 1:
            raise ValueError("megastep must be >= 1")
        if cfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.device = resolve_device(cfg.device)
        if api.device != self.device:
            raise ValueError(f"model is on {api.device} but the engine is "
                             f"configured for {self.device}")
        self.api = api
        self.params = params
        self.cfg = cfg
        self.hints = hints or default_serving_hints()
        self.cache = api.init_cache(cfg.max_batch, cfg.cache_len)
        # pristine rows for slot recycling
        self._cache0 = api.init_cache(cfg.max_batch, cfg.cache_len)
        self.slots: list[Request | None] = [None] * cfg.max_batch
        B = cfg.max_batch

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        self._dev = {
            "state": torch.full((B,), S_EMPTY, dtype=torch.int32,
                                device=self.device),
            "tok": z(B), "consumed": z(B), "n_gen": z(B),
            "prompt_len": z(B), "max_new": z(B),
            "prompt": z(B, cfg.cache_len),
        }
        kv = _kv_cache_leaves(self.cache)
        self.paged = cfg.paging and kv is not None
        if cfg.faults is not None and not self.paged:
            raise ValueError(
                "fault injection targets the paged memory hierarchy; "
                "this engine has paging disabled (or a non-pageable "
                "cache family)")
        self._fx = cfg.faults if self.paged else None
        if self.paged:
            L, _, _, KV, hd = kv["k"].shape
            kv_dims = L * 2 * KV * hd
            self.pool = self._make_pool((cfg.block_tokens, kv_dims))
            kv_bytes = float(kv_dims * 2)
        else:
            self.pool = None
            kv_bytes = 4096.0
        self.queue = RequestQueue(cfg.max_queue, policy=cfg.policy,
                                  hints=self.hints,
                                  kv_bytes_per_token=kv_bytes)
        self._mega_fns: dict[int, object] = {}
        # the engine steps as graphs over the static cache and slot state;
        # None: the eager megastep (``_mega_fn``)
        if _graphs is None:
            _graphs = self.device.type == "cuda"
        self.graphs = StepGraphs(
            _engine_step_math(api, cfg.prefill_chunk,
                              cfg.block_tokens if self.paged else None),
            params, self.cache, self._dev, max(1, cfg.prefill_chunk),
            extract=self.paged,
            capture=self.device.type == "cuda") if _graphs else None
        self.decode_steps = 0      # micro-steps run (decode_step calls of
                                   # the eager megastep)
        self.row_advances = 0      # row-micro-steps that consumed a prompt
                                   # token or fed a generated one (the sum
                                   # of _reconcile's ``advanced``): over
                                   # decode_steps x max_batch, the share
                                   # of the steps' row work that moved a
                                   # request
        self.step_count = 0
        self.host_dispatches = 0   # megastep-program dispatches
        self.megasteps = 0         # megastep boundaries
        self.host_blocked = 0      # boundaries whose readback the host
                                   # consumed with nothing dispatched
                                   # ahead of it (the pipeline bubbles)
        self._inflight: list[_InFlight] = []   # dispatched, unreconciled
        self._fb_zero = np.zeros((self.queue.capacity,), np.float32)
        self.completed: dict[int, Request] = {}
        self.failed: dict[int, Request] = {}     # FAILED terminal records
        self._scan_cursor: dict[int, int] = {}   # rid -> cold-block cursor
        # CAX scope attribution, always wired (host-side dict arithmetic
        # off the billing the pool already does).
        self.telemetry = CaxRegistry()
        # the tracer is None when disabled, like the fault injector: every
        # hook below sits behind one ``is not None`` and reads no device
        # tensor, so the replayed graphs are the same either way.
        if cfg.trace is None:
            self._tracer = None
        elif isinstance(cfg.trace, Tracer):
            self._tracer = cfg.trace
        elif cfg.trace is True:
            self._tracer = Tracer()
        else:
            self._tracer = Tracer(path=str(cfg.trace))
        if self.paged:
            self.pool.attach_telemetry(self.telemetry)
            if self._tracer is not None:
                self.pool.attach_trace(self._tracer)
        if self._fx is not None:
            self._fx.trace = self._tracer
        self.queue.tracer = self._tracer
        # non-LLM tenants (WorkloadAPI) sharing the pool, the paging
        # transaction and the admission queue
        self.tenants: dict[str, object] = {}
        self._reserved_blocks = 0   # HBM headroom promised to tenants
        # crash consistency (serve.snapshot): None when disabled — every
        # hook sits behind one ``is not None``, so a disabled engine runs
        # as one built before this layer.
        self._snap = None
        if cfg.snapshot_every > 0:
            if cfg.snapshot_dir is None:
                raise ValueError("snapshot_every > 0 needs snapshot_dir")
            if not self.paged:
                raise ValueError(
                    "snapshot/restore covers the paged memory hierarchy; "
                    "this engine has paging disabled (or a non-pageable "
                    "cache family)")
            self._snap = SnapshotManager(cfg.snapshot_dir,
                                         cfg.snapshot_every)

    # -- sharding seams (overridden by serve.shard.ShardedServeEngine) ------
    def _make_pool(self, block_shape) -> PagedKVPool:
        """Build the engine's KV pool; the sharded engine returns a
        per-data-rank pool facade with the same interface instead."""
        cfg = self.cfg
        return PagedKVPool(
            cfg.resolved_pool_blocks(), cfg.hbm_blocks, block_shape,
            hints=self.hints, tiers=cfg.tiers, faults=cfg.faults,
            device=self.device)

    def _alloc_block(self, r: Request) -> list[int]:
        """Allocate the next KV block for one request's fill. The sharded
        engine routes this to the pool shard owning ``r.slot``."""
        return self.pool.alloc(1)

    def _stage_view(self, staged):
        """Adapt the megastep's staged write-through slabs for the pool
        (identity here; the sharded engine lands its data ranks' slabs on
        the pool device, a device-to-device copy, never a host sync)."""
        return staged

    def _run_megastep(self, k: int, micro: tuple):
        """Enqueue one K-step megastep on the device: (packed readback,
        staged slabs or None). The sharded engine runs one per rank."""
        self._dev, packed, staged = _device_megastep(
            self._mega_fn(k), self.graphs, self.params, self.cache,
            self._dev, micro, self.paged)
        return packed, staged

    def _install_rows(self, mask: np.ndarray, prompts: np.ndarray,
                      plen: np.ndarray, mnew: np.ndarray) -> None:
        """Admission's device writes, over the whole batch (``mask``
        marks the admitted slots): pristine cache rows for the recycled
        slots and the new slot state, both in place (the step graphs read
        these tensors). The sharded engine writes each rank's band."""
        rows = to_device(np.flatnonzero(mask).astype(np.int64), self.device)
        for leaf, leaf0 in zip(nn.tree_leaves(self.cache),
                               nn.tree_leaves(self._cache0), strict=True):
            leaf[:, rows] = leaf0[:, rows]
        dev = self.device
        new = _admit_rows(self._dev, to_device(mask, dev),
                          to_device(prompts, dev), to_device(plen, dev),
                          to_device(mnew, dev))
        for key, leaf in self._dev.items():
            leaf.copy_(new[key])

    def _device_state(self) -> tuple[dict, dict]:
        """The slot state and the cache as whole-batch tensors, for a
        snapshot to capture and a restore to write: the engine's own here;
        the sharded engine gathers copies of its data bands."""
        return self._dev, self.cache

    def _place_device_state(self, dev: dict, cache: dict) -> None:
        """Make ``dev``/``cache`` (from ``_device_state()``, rewritten by
        a snapshot restore) the engine's device state. Here they are the
        engine's own tensors, already written in place; the sharded
        engine copies each data band into every rank that holds it."""

    def _snapshot_extra_state(self) -> dict:
        """Engine-subclass state for the snapshot tree (the sharded
        engine's ICI meter totals). Must be JSON-serializable."""
        return {}

    def _load_extra_state(self, extra: dict) -> None:
        """Inverse of ``_snapshot_extra_state``."""

    # -- tenants -----------------------------------------------------------
    def add_tenant(self, workload):
        """Attach a ``WorkloadAPI`` tenant (KV store, vector search, ...).

        The tenant's requests go through the shared ``RequestQueue`` and
        its per-step block demand joins LLM KV paging in the same
        ``PagedKVPool.step_multi`` transaction. ``blocks_per_step`` HBM
        blocks are reserved so joint demand can never overflow the pool.
        """
        if not self.paged:
            raise ValueError(
                "tenants serve from the paged KV pool; this engine has "
                "paging disabled (or a non-pageable cache family)")
        if workload.name in self.tenants or workload.name == "llm":
            raise ValueError(f"tenant name {workload.name!r} already taken")
        reserved = self._reserved_blocks + workload.blocks_per_step
        if reserved >= self.pool.hbm_capacity:
            raise ValueError(
                f"tenants would reserve {reserved} of "
                f"{self.pool.hbm_capacity} HBM blocks; grow hbm_blocks or "
                f"shrink the tenant's per-step footprint")
        workload.bind(self)
        self.tenants[workload.name] = workload
        self._reserved_blocks = reserved
        return workload

    # -- intake ------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, arrival_step: int = 0,
               hint_path: str = "/serve/llm/prefill") -> Request:
        req = Request(prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens,
                      arrival_step=arrival_step, hint_path=hint_path)
        if req.prompt_len < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = req.prompt_len + max_new_tokens
        if total > self.cfg.cache_len:
            raise ValueError(
                f"request needs {total} cache positions but cache_len is "
                f"{self.cfg.cache_len}")
        if self.paged:
            # one engine step can newly fill at most ceil(chunk/bt) blocks
            # of one request, all of which must fit the pool's HBM.
            bt = self.cfg.block_tokens
            chunk = max(1, self.cfg.prefill_chunk)
            worst = min(math.ceil(total / bt), math.ceil(chunk / bt))
            if worst > self.cfg.hbm_blocks:
                raise ValueError(
                    f"request can fill {worst} KV blocks in one engine "
                    f"step but the pool holds {self.cfg.hbm_blocks} HBM "
                    f"blocks; grow hbm_blocks or shrink prefill_chunk/"
                    f"block_tokens")
        if self._tracer is not None:
            req.trace = {"rid": req.rid, "submit_us": self._tracer.now_us(),
                         "admit_us": None, "overtaken": 0}
        self.queue.submit(req)
        if self._snap is not None:
            self._snap.note_submit(self, req)
        return req

    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def pending(self) -> int:
        return (len(self.queue) + len(self.active())
                + sum(t.pending() for t in self.tenants.values()))

    # -- the step loop -----------------------------------------------------
    def _mega_fn(self, n_steps: int):
        """The (prefill_chunk, K, block_tokens) megastep this engine uses
        for a K-step dispatch."""
        if n_steps not in self._mega_fns:
            bt = self.cfg.block_tokens if self.paged else None
            self._mega_fns[n_steps] = _megastep_math(
                self.api, self.cfg.prefill_chunk, n_steps, bt)
        return self._mega_fns[n_steps]

    @property
    def n_graphs(self) -> int:
        """CUDA graphs this engine holds: at most prefill_chunk + 1."""
        return len(self.graphs) if self.graphs is not None else 0

    def step(self) -> dict:
        """One engine step — the K=1 megastep."""
        return self.megastep(1)

    def megastep(self, n_steps: int | None = None) -> dict:
        """Run up to K consecutive engine steps as one host dispatch: plan,
        dispatch, reconcile, blocking on this boundary's readback before
        returning. Older in-flight megasteps are reconciled first."""
        rec = self._dispatch(self._plan(n_steps))
        while self._inflight[0] is not rec:
            self._reconcile(self._inflight[0])
        return self._reconcile(rec)

    def _plan(self, n_steps: int | None = None) -> _InFlight:
        """Boundary planning: admission plus every live row's K-step
        trajectory, from the planning view of the request mirrors. No
        device sync."""
        tr = self._tracer
        t0 = tr.begin("plan") if tr is not None else 0.0
        k = int(n_steps) if n_steps else max(1, self.cfg.megastep)
        now = self.step_count
        with maybe_phase(tr, "plan.admit"):
            admitted = self._admit(now)
        live = self.active()
        with maybe_phase(tr, "plan.trajectory"):
            traj = {r.rid: self._simulate_row(r, k) for r in live}
            micro = self._active_micro(live, traj, k)
        if tr is not None:
            tr.span("plan", t0, step=now, k=k, admitted=admitted,
                    live=len(live))
        return _InFlight(now=now, k=k, admitted=admitted, live=live,
                         traj=traj, micro=micro)

    def _active_micro(self, live: list[Request], traj: dict,
                      k: int) -> tuple:
        """Per inner step, how many leading micro-steps advance any row:
        1 for a decoding row (micro-step 0 only), the remaining prompt
        (capped at ``prefill_chunk``) for a prefilling one. Movers only
        shrink across a step's micro-steps, so the rest have none."""
        n_micro = max(1, self.cfg.prefill_chunk)
        out = []
        for t in range(k):
            m = 0
            for r in live:
                if t == 0:
                    state, consumed = r.plan_state, r.plan_consumed
                    state = {PREFILL: S_PREFILL, DECODE: S_DECODE,
                             DONE: S_DONE}[state]
                else:
                    prev = traj[r.rid][t - 1]
                    state, consumed = prev.state, prev.consumed
                if state == S_DECODE:
                    m = max(m, 1)
                elif state == S_PREFILL:
                    m = max(m, min(n_micro, r.prompt_len - consumed))
            out.append(m)
        return tuple(out)

    def _dispatch(self, rec: _InFlight) -> _InFlight:
        """Enqueue one planned megastep without consuming its readback:
        the K-step program, the per-inner-step paging transactions against
        its staged slabs, mid-megastep block frees and the policy fold.
        Host state advances along the deterministic trajectory and every
        pool alloc/free is journaled on ``rec``. On a CUDA device the
        ``dispatch`` span covers the enqueue of the step graphs' replays,
        not their run on the card."""
        tr = self._tracer
        t0 = tr.begin("dispatch") if tr is not None else 0.0
        now, k, live, traj = rec.now, rec.k, rec.live, rec.traj
        staged = None
        if live:
            with maybe_phase(tr, "dispatch.replay"):
                packed, staged = self._run_megastep(k, rec.micro)
                staged = self._stage_view(staged)
                rec.packed = _Readback(packed)
            self.host_dispatches += 1
            self.decode_steps += sum(rec.micro)

        report = {"page_ins": 0, "page_outs": 0, "migrations": 0}
        feedbacks = []
        tenant_done = 0
        with maybe_phase(tr, "dispatch.page"):
            for t in range(k):
                rows = [(r, traj[r.rid][t]) for r in live
                        if r.state != FAILED
                        and traj[r.rid][t].state != S_DONE]
                if self.paged:
                    rep = self._page_kv_at(now + t, rows, staged, t,
                                           rec.journal)
                    report["page_ins"] += rep["page_ins"]
                    report["page_outs"] += rep["page_outs"]
                    if self._fx is not None:
                        self._service_fault_report(rep, now + t, rec)
                    # rows completing at this inner step release their
                    # pool blocks now, exactly when the per-step loop
                    # would have.
                    for r in live:
                        st = traj[r.rid][t]
                        if (st.state == S_DONE and r.blocks
                                and not r.blocks_freed
                                and (t == 0 or traj[r.rid][t - 1].state
                                     != S_DONE)):
                            self.pool.free(r.blocks)
                            r.blocks_freed = True
                            rec.journal.append(
                                ("free", r, list(r.blocks)))
                for tn in self.tenants.values():
                    for r in tn.retire(now + t):
                        self.completed[r.rid] = r
                        tenant_done += 1
                if k > 1:
                    feedbacks.append(policies_lib.Feedback(
                        moved_read=self._fb_zero,
                        moved_write=self._fb_zero,
                        utilization=np.float32(
                            len(rows) / max(1, self.cfg.max_batch))))

        with maybe_phase(tr, "dispatch.retire"):
            if self.paged and self.pool.tiered and self.cfg.tier_migrate:
                # boundary tier rebalance: planned from this megastep's
                # per-channel traffic window (host metadata), executed as
                # one in-place row copy on the device before the readback
                # is consumed. Plans may cover planned-not-yet-reconciled
                # residency: moves relocate verbatim host bytes, and a
                # divergence rollback only needs ownership consistency.
                report["migrations"] = \
                    self.pool.migrate_tiers()["migrations"]

            if self._fx is not None and self.pool.host.capacity_degraded:
                self._shed_over_capacity(rec)

            # the megastep's outcome — bar token values — is already
            # decided, so the planning view advances now (trajectory-driven
            # retirement).
            for r in live:
                if r.state == FAILED:
                    continue
                last = traj[r.rid][-1]
                r.speculate(STATE_OF_CODE[last.state], last.consumed,
                            last.n_gen)
            report["completed"] = tenant_done + self._retire_planned(rec)
        rec.report = report

        with maybe_phase(tr, "dispatch.policy"):
            if feedbacks and len(self.queue):
                # megastep-boundary policy feedback, padded to the
                # configured megastep width (a zero-service step is an
                # update no-op).
                util = float(np.mean([float(fb.utilization)
                                      for fb in feedbacks]))
                zero = policies_lib.Feedback(
                    moved_read=self._fb_zero, moved_write=self._fb_zero,
                    utilization=np.float32(0.0))
                pad = max(0, max(1, self.cfg.megastep) - len(feedbacks))
                self.queue.note_service(
                    policies_lib.stack_feedbacks(feedbacks + [zero] * pad),
                    mean_util=util)
        self.step_count += k
        self.megasteps += 1
        self._inflight.append(rec)
        if tr is not None:
            tr.span("dispatch", t0, step=now, k=k, live=len(live),
                    in_flight=len(self._inflight),
                    page_ins=report["page_ins"],
                    page_outs=report["page_outs"],
                    migrations=report["migrations"])
            tr.counter("in_flight", len(self._inflight))
        return rec

    def _retire_planned(self, rec: _InFlight) -> int:
        """Trajectory-driven retirement at dispatch time: rows whose
        predicted final state is DONE leave their slots before the
        readback lands, with the deterministic ``done_step``."""
        n = 0
        for r in rec.live:
            if r.state == FAILED:
                continue
            steps_r = rec.traj[r.rid]
            if steps_r[-1].state != S_DONE:
                continue
            r.done_step = rec.now + next(
                t for t, st in enumerate(steps_r) if st.state == S_DONE)
            if self.paged and r.blocks and not r.blocks_freed:
                self.pool.free(r.blocks)
                r.blocks_freed = True
                rec.journal.append(("free", r, list(r.blocks)))
            self._scan_cursor.pop(r.rid, None)
            self.slots[r.slot] = None
            self.completed[r.rid] = r
            n += 1
        return n

    def _reconcile(self, rec: _InFlight) -> dict:
        """Consume one in-flight megastep's deferred readback: append the
        sampled tokens to the real host mirrors and cross-check the
        device's final counters against the dispatched trajectory. A
        readback that contradicts its trajectory rolls back every
        speculative pool mutation before raising."""
        tr = self._tracer
        t0 = tr.begin("reconcile") if tr is not None else 0.0
        self._inflight.remove(rec)
        bubble = bool(rec.live and not self._inflight)
        if bubble:
            # the host blocks on this readback with nothing dispatched
            # ahead of it — a pipeline bubble.
            self.host_blocked += 1
        advanced = 0
        tok_pairs = [] if self._snap is not None else None
        if rec.live:
            with maybe_phase(tr, "reconcile.wait"):
                rb = rec.packed.wait()
        with maybe_phase(tr, "reconcile.sync"):
            if rec.live:
                advanced = self._sync_mirrors(rec, rb, tok_pairs)
            if self._snap is not None:
                self._snap.note_boundary(
                    self, rec.now, rec.k,
                    [r.rid for r in rec.live
                     if r.admitted_step == rec.now], tok_pairs)
        self.row_advances += advanced
        if tr is not None:
            tr.span("reconcile", t0, step=rec.now, k=rec.k,
                    host_blocked=bubble, advanced=advanced)
        return {"step": rec.now, "steps": rec.k,
                "admitted": rec.admitted, "advanced": advanced,
                **rec.report}

    def _sync_mirrors(self, rec: _InFlight, rb: np.ndarray,
                      tok_pairs: list | None) -> int:
        """Append one megastep's sampled tokens (``rb``, its readback) to
        the live rows' host mirrors, cross-checking the device's final
        counters against the trajectory; returns the row-micro-steps that
        moved a request. A contradiction rolls back every speculative pool
        mutation and raises."""
        advanced = 0
        try:
            for r in rec.live:
                if r.state == FAILED:
                    # failed mid-flight (poison/casualty/shed): its
                    # readback is moot — the request already carries
                    # its structured error.
                    continue
                steps_r = rec.traj[r.rid]
                toks = [int(rb[r.slot, 3 + t])
                        for t, st in enumerate(steps_r) if st.emitted]
                c0, g0 = r.consumed, len(r.generated)
                dev_state = int(rb[r.slot, 0])
                dev_consumed = int(rb[r.slot, 1])
                dev_ngen = int(rb[r.slot, 2])
                last = steps_r[-1]
                exp_ngen = g0 + sum(st.emitted for st in steps_r)
                fields = []
                if STATE_OF_CODE.get(dev_state) != \
                        STATE_OF_CODE[last.state]:
                    fields.append(
                        f"state (host planned "
                        f"{STATE_OF_CODE[last.state]}, device "
                        f"reported {STATE_OF_CODE.get(dev_state, f'code {dev_state}')})")
                if dev_consumed != last.consumed:
                    fields.append(
                        f"consumed (host planned {last.consumed}, "
                        f"device reported {dev_consumed})")
                if dev_ngen != exp_ngen:
                    fields.append(
                        f"n_gen (host planned {exp_ngen}, device "
                        f"reported {dev_ngen})")
                if fields:
                    raise RuntimeError(
                        f"rid {r.rid}: boundary at step {rec.now} "
                        f"(k={rec.k}): device readback diverged "
                        f"from the host trajectory on "
                        + "; ".join(fields))
                r.sync_megastep(dev_state, dev_consumed, dev_ngen, toks)
                advanced += ((last.consumed + last.n_gen) - (c0 + g0)
                             - sum(st.transition for st in steps_r))
                if tok_pairs is not None and toks:
                    tok_pairs.append((r.rid, toks))
        except RuntimeError:
            tr = self._tracer
            if tr is not None:
                tr.instant("engine", "divergence_rollback",
                           {"step": rec.now, "k": rec.k}, clock="host")
                tr.end("reconcile")
            self._rollback_speculation(rec)
            raise
        return advanced

    def _rollback_speculation(self, failed: _InFlight) -> None:
        """Divergence escape hatch: replay the journals of every
        unreconciled megastep backwards — speculative allocs are freed
        (and dropped from their request's tail), speculative frees are
        reclaimed — so block ownership is consistent on exit."""
        recs = [failed] + self._inflight
        self._inflight = []
        for rec in reversed(recs):
            for op, req, ids in reversed(rec.journal):
                if op == "alloc":
                    del req.blocks[len(req.blocks) - len(ids):]
                    self.pool.free(ids)
                else:
                    self.pool.reclaim(ids)
                    req.blocks_freed = False
            rec.journal = []

    # -- fault recovery (graceful degradation) -------------------------------
    def _total_blocks(self, r: Request) -> int:
        """Every KV block this LLM request will ever hold."""
        return math.ceil((r.prompt_len + r.max_new_tokens)
                         / self.cfg.block_tokens)

    def _committed_blocks(self) -> int:
        """Host-capacity commitment: live LLM rows' eventual full block
        footprint plus whatever else (tenants) holds pool blocks now."""
        live = [r for r in self.slots
                if r is not None and r.state != FAILED]
        need = sum(self._total_blocks(r) for r in live)
        other = (int(self.pool._allocated.sum())
                 - sum(len(r.blocks) for r in live))
        return need + max(0, other)

    def _fail_request(self, r: Request, error: dict, journal: list
                      ) -> None:
        """Move one request to the FAILED terminal state: structured
        ``error`` attached, pool blocks freed (journaled), slot vacated on
        the host. Its device row is left as it is, as in the reference:
        no later step reads it, and admission rewrites the slot state in
        place when the slot is reused. Partial output stays on the
        request (``engine.failed[rid]``)."""
        if r.state == FAILED:
            return
        r.state = FAILED
        r.spec = None
        r.error = dict(error)
        r.done_step = int(error.get("step", self.step_count))
        if self.paged and r.blocks and not r.blocks_freed:
            self.pool.free(r.blocks)
            r.blocks_freed = True
            journal.append(("free", r, list(r.blocks)))
        self._scan_cursor.pop(r.rid, None)
        if 0 <= r.slot < len(self.slots) and self.slots[r.slot] is r:
            self.slots[r.slot] = None
        self.failed[r.rid] = r
        if self._fx is not None:
            self._fx.stats["failed"] += 1
        if self._tracer is not None:
            self._tracer.instant(
                "faults", "request_failed",
                {"rid": r.rid, "kind": error.get("kind")})

    def _service_fault_report(self, rep: dict, step_now: int,
                              rec: _InFlight) -> None:
        """Translate one pool transaction's fault report into request
        consequences: a poisoned or evacuation-casualty block fails its
        owning LLM request — and only that request. Blocks of non-LLM
        tenants come back zero-installed (the pool's fresh-install path:
        the value is gone) and the tenant keeps running."""
        for kind, blocks in (("poisoned_block", rep.get("poisoned", ())),
                             ("evacuation_casualty",
                              rep.get("casualties", ()))):
            for b in blocks:
                owner = next(
                    (r for r in self.slots
                     if r is not None and r.state != FAILED
                     and b in r.blocks), None)
                if owner is not None:
                    self._fail_request(
                        owner, {"kind": kind, "block": int(b),
                                "step": int(step_now)}, rec.journal)

    def _shed_over_capacity(self, rec: _InFlight) -> None:
        """Deadline-based load shedding once host capacity degrades
        (channel offline / quarantined slots): while the committed block
        footprint exceeds surviving capacity, fail live rows — doomed
        deadlines first, then the largest footprints — and drop queued
        LLM requests that could never fit even alone."""
        fx = self._fx
        cap_live = self.pool.host.live_capacity()
        committed = self._committed_blocks()
        now = self.step_count
        if committed > cap_live:
            live = [r for r in self.slots
                    if r is not None and r.state != FAILED]

            def doomed(r: Request) -> bool:
                return (r.deadline_step is not None
                        and now + self._steps_until_done(r)
                        > r.deadline_step)

            for r in sorted(live, key=lambda r: (not doomed(r),
                                                 -self._total_blocks(r),
                                                 r.rid)):
                if committed <= cap_live:
                    break
                committed -= self._total_blocks(r)
                self._fail_request(
                    r, {"kind": "shed", "step": now,
                        "committed_blocks": committed
                        + self._total_blocks(r),
                        "live_capacity": cap_live}, rec.journal)
                fx.stats["shed"] += 1
        for r in list(self.queue.waiting()):
            if r.tenant == "llm" and self._total_blocks(r) > cap_live:
                self.queue.remove(r)
                self._fail_request(
                    r, {"kind": "shed", "step": now,
                        "needed_blocks": self._total_blocks(r),
                        "live_capacity": cap_live}, rec.journal)
                fx.stats["shed"] += 1

    def run(self, max_steps: int | None = None) -> dict[int, np.ndarray]:
        """Drive megasteps until every submitted request completes.

        Between admission events the engine free-runs: ``_auto_megastep``
        picks the widest K <= ``cfg.megastep`` that cannot skip a step
        where admission could change the live set, so admission happens at
        exactly the steps the K=1 loop would have used. With
        ``cfg.pipeline_depth > 1`` the loop plans and dispatches megastep
        t+1 before reconciling t's deferred readback. Results are
        bit-exact across depths and widths. Under fault injection the
        returned dict holds the survivors; failed requests land in
        ``self.failed`` with a structured ``Request.error``."""
        limit = max_steps if max_steps is not None else 10_000
        depth = max(1, self.cfg.pipeline_depth)
        stall_cap = max(1, self.cfg.stall_boundaries)
        done_steps = 0
        stall = 0
        while done_steps < limit:
            if self._snap is not None:
                # journaled resubmits due at this boundary come back
                # before the pending() check: a restored engine whose cut
                # had nothing live still owes them a replay.
                self._snap.inject_resubmits(self)
            if not self.pending():
                break
            if self._snap is not None:
                # a consistent cut if one is due (drains the pipeline,
                # flushes dirty HBM through the billed path).
                self._snap.maybe_cut(self)
            k = self._auto_megastep(limit - done_steps)
            rec = self._plan(k)
            self._dispatch(rec)
            done_steps += k
            progress = (rec.admitted > 0 or bool(rec.live)
                        or any(tn.running()
                               for tn in self.tenants.values()))
            stall = 0 if progress else stall + 1
            if stall >= stall_cap:
                while self._inflight:
                    self._reconcile(self._inflight[0])
                stuck = self._stuck_rids()
                raise EngineStallError(
                    f"no progress for {stall_cap} consecutive megastep "
                    f"boundaries (step {self.step_count}): rids {stuck} "
                    f"are stuck (never admitted, never advancing)",
                    stuck)
            while len(self._inflight) >= depth:
                self._reconcile(self._inflight[0])
        while self._inflight:
            self._reconcile(self._inflight[0])
        if self.pending():
            stuck = self._stuck_rids()
            raise RuntimeError(
                f"requests still pending after {limit} steps: "
                f"rids {stuck}")
        return {rid: np.asarray(r.generated, np.int32)
                for rid, r in sorted(self.completed.items())}

    def _stuck_rids(self) -> list[int]:
        return sorted([r.rid for r in self.queue.waiting()]
                      + [r.rid for r in self.active()]
                      + [r.rid for t in self.tenants.values()
                         for r in t.running()])

    # -- megastep planning (host-deterministic trajectories) ----------------
    def _simulate_row(self, r: Request, k: int) -> "list[_RowStep]":
        """Predict one live row's next ``k`` engine steps — the exact twin
        of the device state machine: a PREFILL row consumes up to
        ``prefill_chunk`` prompt tokens per step and emits once on its
        transition; a DECODE row emits one token per step; DONE rows
        freeze. Reads the planning view (``plan_*``)."""
        n_micro = max(1, self.cfg.prefill_chunk)
        state = {PREFILL: S_PREFILL, DECODE: S_DECODE,
                 DONE: S_DONE}[r.plan_state]
        consumed, n_gen = r.plan_consumed, r.plan_n_gen
        plen, mnew = r.prompt_len, r.max_new_tokens
        out = []
        for _ in range(k):
            emitted = transition = False
            if state == S_DECODE:
                n_gen += 1
                emitted = True
                if n_gen >= mnew:
                    state = S_DONE
            elif state == S_PREFILL:
                consumed = min(plen, consumed + n_micro)
                if consumed >= plen:
                    n_gen += 1
                    emitted = transition = True
                    state = S_DONE if n_gen >= mnew else S_DECODE
            written = (consumed if state == S_PREFILL
                       else max(consumed + n_gen - 1, 0))
            out.append(_RowStep(state=state, consumed=consumed,
                                n_gen=n_gen, written=written,
                                emitted=emitted, transition=transition))
        return out

    def _steps_until_done(self, r: Request) -> int:
        """Engine steps until this live row completes (planning view)."""
        if r.plan_state == DONE:
            return 0
        n = 0
        if r.plan_state == PREFILL:
            n = self._steps_until_decode(r)
            gen_left = r.max_new_tokens - r.plan_n_gen - 1
        else:
            gen_left = r.max_new_tokens - r.plan_n_gen
        return max(1, n + gen_left)

    def _steps_until_decode(self, r: Request) -> int:
        """Steps until a prefilling row's PREFILL->DECODE transition."""
        if r.plan_state != PREFILL:
            return 0
        n_micro = max(1, self.cfg.prefill_chunk)
        return max(1, -(-(r.prompt_len - r.plan_consumed) // n_micro))

    def _auto_megastep(self, remaining: int) -> int:
        """Widest safe megastep from the current boundary: never skip a
        step where admission could change the live set (an arrival, or —
        while admissible work waits — the earliest completion or
        prefill->decode transition). Quantized down to a power of two."""
        cap = min(max(1, self.cfg.megastep), max(1, remaining))
        if cap == 1:
            return 1
        now = self.step_count
        live = self.active()
        waiting = self.queue.waiting()
        events = [r.arrival_step - now for r in waiting
                  if r.arrival_step > now]
        if any(r.arrival_step <= now for r in waiting):
            evs = []
            for r in live:
                evs.append(self._steps_until_done(r))
                if r.plan_state == PREFILL:
                    evs.append(self._steps_until_decode(r))
            for tn in self.tenants.values():
                for tr in tn.running():
                    ci = tn.completion_in(tr)
                    evs.append(1 if ci is None else max(1, ci))
            events.append(min(evs) if evs else 1)
        if events:
            k = min(cap, max(1, min(events)))
        else:
            # nothing can be admitted before the live set drains: free-run
            # to the end of the longest remaining work (or the cap).
            rem = [self._steps_until_done(r) for r in live]
            for tn in self.tenants.values():
                rem.extend(max(1, tn.completion_in(tr) or 1)
                           for tr in tn.running())
            k = min(cap, max(rem)) if rem else 1
        return 1 << (k.bit_length() - 1)

    # -- admission ---------------------------------------------------------
    def _worst_step_blocks(self, prompt_len: int, max_new: int,
                           prefilling: bool) -> int:
        """Worst-case KV blocks one request can newly fill in one step."""
        if not prefilling:
            return 1
        bt = self.cfg.block_tokens
        chunk = max(1, self.cfg.prefill_chunk)
        return min(math.ceil((prompt_len + max_new) / bt),
                   math.ceil(chunk / bt))

    def _admission_budget(self, now: int, n_free: int) -> int:
        """Cap admissions on write-through headroom: the batch's
        worst-case newly filled blocks per step, plus the HBM blocks
        reserved for attached tenants, must fit the pool's HBM."""
        if not self.paged:
            return n_free
        running = sum(
            self._worst_step_blocks(r.prompt_len, r.max_new_tokens,
                                    r.plan_state == PREFILL)
            for r in self.active())
        headroom = (self.pool.hbm_capacity - self._reserved_blocks
                    - running)
        arrived = [r for r in self.queue.waiting(now)
                   if r.tenant == "llm"]
        if not arrived or headroom < 1:
            return 0 if arrived else n_free
        per_adm = max(self._worst_step_blocks(r.prompt_len,
                                              r.max_new_tokens, True)
                      for r in arrived)
        budget = min(n_free, headroom // per_adm)
        if self._fx is not None and self.pool.host.capacity_degraded:
            # degraded-capacity backpressure: never commit more eventual
            # host blocks than the surviving channels can hold — place()
            # is sticky, so every admitted block needs a live slot.
            per_total = max(self._total_blocks(r) for r in arrived)
            room = (self.pool.host.live_capacity()
                    - self._committed_blocks())
            budget = min(budget, max(0, room) // per_total)
        return budget

    def _admit(self, now: int) -> int:
        free = [i for i, r in enumerate(self.slots) if r is None]
        budget: int | dict[str, int] = self._admission_budget(
            now, len(free)) if free else 0
        if self.tenants:
            budget = {"llm": max(0, budget)}
            for t in self.tenants.values():
                budget[t.name] = t.free_slots()
        elif budget <= 0:
            return 0
        admitted = self.queue.dispatch(now, budget)
        if not admitted:
            return 0
        llm = [r for r in admitted if r.tenant == "llm"]
        for req in admitted:
            if req.tenant != "llm":
                self.tenants[req.tenant].start(req, now)
        if not llm:
            return len(admitted)
        B = self.cfg.max_batch
        P = self.cfg.cache_len
        mask = np.zeros((B,), bool)
        prompts = np.zeros((B, P), np.int32)
        plen = np.zeros((B,), np.int32)
        mnew = np.zeros((B,), np.int32)
        for req in llm:
            slot = free.pop(0)
            req.slot = slot
            self.slots[slot] = req
            self._scan_cursor[req.rid] = 0
            mask[slot] = True
            prompts[slot, :req.prompt_len] = req.prompt
            plen[slot] = req.prompt_len
            mnew[slot] = req.max_new_tokens
        self._install_rows(mask, prompts, plen, mnew)
        return len(admitted)

    # -- batched KV paging (one transaction per inner step) -----------------
    def _page_kv_at(self, now: int, rows: "list[tuple[Request, _RowStep]]",
                    staged, t: int, journal: list) -> dict:
        """One paging transaction for inner step ``t`` of a megastep: LLM
        KV traffic planned from the trajectory, written through from the
        megastep's staged slab, plus every tenant's block demand grouped
        by hint scope, through one ``PagedKVPool.step_multi``; then each
        tenant's device compute on the resident blocks. Dispatch-only;
        every alloc is journaled."""
        bt = self.cfg.block_tokens
        new_pairs: list[tuple[Request, int, int]] = []  # (req, bi, stage_j)
        for r, st in rows:
            # entering inner step t, len(r.blocks) is the block count
            # before the step — the device staged this step's fills at
            # stage rows j = bi - fill_base.
            fill_base = len(r.blocks)
            n_filled = st.written // bt
            while len(r.blocks) < n_filled:
                bi = len(r.blocks)
                r.blocks.extend(self._alloc_block(r))
                journal.append(("alloc", r, [r.blocks[bi]]))
                new_pairs.append((r, bi, bi - fill_base))

        # tenant demand first: it is bounded by the per-tenant
        # reservations, and the LLM cold-scan budget shrinks to whatever
        # the tenants left unclaimed this step.
        tenant_groups: list[tuple[str, list[int]]] = []
        tenant_blocks = 0
        for tn in self.tenants.values():
            for path, ids in tn.block_demand(now):
                if ids:
                    tenant_groups.append((path, ids))
                    tenant_blocks += len(set(ids))

        new_ids = [r.blocks[bi] for r, bi, _ in new_pairs]
        budget = self.pool.hbm_capacity - tenant_blocks
        if len(new_ids) > budget:
            raise RuntimeError(
                f"{len(new_ids)} blocks filled in one step but pool HBM "
                f"holds {self.pool.hbm_capacity} ({tenant_blocks} claimed "
                f"by tenants); shrink prefill_chunk or grow hbm_blocks")
        # new blocks first — they must be resident for the write-through;
        # demand beyond capacity is advisory and may be trimmed.
        holders = [r for r, _ in rows]
        demand = self._block_demand(holders)
        needed = list(dict.fromkeys(new_ids + [b for _, b, _ in demand]))
        needed = needed[:budget]
        self._advance_cursors(holders, demand, set(needed))
        groups = ([("/serve/kv_cache", needed)] if needed else []) \
            + tenant_groups
        if not groups and not self.tenants:
            return {"page_ins": 0, "page_outs": 0}
        report = (self.pool.step_multi(groups) if groups
                  else {"page_ins": 0, "page_outs": 0})
        if new_pairs:
            # fixed-width write-through from the staged slab: row
            # slot*max_fills + j holds the block extracted right after this
            # inner step; padding rows carry an out-of-range sentinel id.
            max_fills = -(-max(1, self.cfg.prefill_chunk) // bt)
            ids = np.full((self.cfg.max_batch * max_fills,),
                          self.pool.n_blocks, np.int32)
            for r, bi, j in new_pairs:
                ids[r.slot * max_fills + j] = r.blocks[bi]
            self.pool.write_staged(ids, staged, t)
        for tn in self.tenants.values():
            tn.compute(self.pool, now)
        return report

    def _block_demand(self, live: list[Request]
                      ) -> list[tuple[int, int, bool]]:
        """The step's resident set as (rid, block, is_cold) triples:
        per-slot fair share of the pool's HBM, newest blocks pinned,
        remaining share cycling through the cold tail."""
        holders = [r for r in live if r.blocks]
        if not holders:
            return []
        budget = max(1, self.pool.hbm_capacity // len(holders))
        demand: list[tuple[int, int, bool]] = []
        for r in holders:
            demand.append((r.rid, r.blocks[-1], False))
            older = r.blocks[:-1]
            k = min(budget - 1, len(older))
            if k > 0:
                c = self._scan_cursor.get(r.rid, 0) % len(older)
                ring = older[c:] + older[:c]
                demand.extend((r.rid, b, True) for b in ring[:k])
        return demand

    def _advance_cursors(self, holders: list[Request],
                         demand: list[tuple[int, int, bool]],
                         kept: set[int]) -> None:
        """Move each request's cold-scan cursor past the cold picks that
        survived the capacity trim."""
        stepped: dict[int, int] = {}
        for rid, block, cold in demand:
            if cold and block in kept:
                stepped[rid] = stepped.get(rid, 0) + 1
        for r in holders:
            k = stepped.get(r.rid)
            if k and len(r.blocks) > 1:
                n = len(r.blocks) - 1
                c = self._scan_cursor.get(r.rid, 0) % n
                self._scan_cursor[r.rid] = (c + k) % n

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """Dispatch accounting in the reference's schema, with the fault
        injector's and the snapshot layer's counters (zeros when
        disabled)."""
        return {"steps": self.step_count,
                "host_dispatches": self.host_dispatches,
                "megasteps": self.megasteps,
                "host_blocked": self.host_blocked,
                "faults": (dict(self._fx.stats) if self._fx is not None
                           else fresh_fault_stats()),
                "snapshot": (dict(self._snap.stats)
                             if self._snap is not None
                             else fresh_snapshot_stats())}

    def reset_stats(self) -> None:
        """Zero the counters without touching the clocks: ``step_count``
        and ``megasteps`` keep running (the fault plan and admission
        timing key on them), while dispatch/bubble counters, pool
        billing, fault stats, snapshot stats and the CAX scope tree
        restart."""
        self.host_dispatches = 0
        self.host_blocked = 0
        if self.paged:
            self.pool.reset_stats()
        if self._fx is not None:
            self._fx.stats.clear()
            self._fx.stats.update(fresh_fault_stats())
        if self._snap is not None:
            self._snap.reset_stats()
        self.telemetry.reset()

    def restore(self, step: int | None = None, *,
                disarm_crashes: bool = True) -> dict:
        """Load the newest valid snapshot (or ``step``) from
        ``cfg.snapshot_dir`` into this engine and arm deterministic
        journal replay; the next ``run()`` resumes bit-exactly. The
        device state is copied into the engine's own tensors, which its
        step graphs read. Returns the restore report (restored step,
        journal stats, casualties)."""
        if self._snap is None:
            raise ValueError(
                "restore needs snapshots enabled (snapshot_every > 0 "
                "and snapshot_dir)")
        return self._snap.restore_into(self, step,
                                       disarm=disarm_crashes)

    def paging_stats(self) -> dict:
        if not self.paged:
            return {"paged": False, **self.stats()}
        # the engine's dispatch accounting wins the shared "steps" key;
        # the pool's transaction count survives as "paging_steps".
        stats = {"paged": True, **self.pool.stats,
                 "paging_steps": self.pool.stats["steps"], **self.stats(),
                 "duplex_speedup": self.pool.duplex_speedup()}
        stats["tiers"] = self.pool.tier_stats()
        stats["tier_speedup"] = self.pool.tier_speedup()
        stats["by_path"] = {
            path: {**st, "duplex_speedup": self.pool.duplex_speedup(path)}
            for path, st in self.pool.stats["by_path"].items()}
        if self.tenants:
            stats["tenants"] = {t.name: t.stats()
                                for t in self.tenants.values()}
        return stats

    @property
    def tracer(self):
        """The engine's ``serve.trace.Tracer`` (None when disabled)."""
        return self._tracer

    def export_trace(self, path: str | None = None) -> str:
        """Write the Perfetto trace; needs ``cfg.trace`` enabled."""
        if self._tracer is None:
            raise ValueError("tracing is disabled; build the engine "
                             "with EngineConfig(trace=...)")
        return self._tracer.export(path)

    def metrics(self):
        """One typed ``core.metrics.MetricsRegistry`` snapshot of the
        whole engine: stats()/paging_stats() flattened into counters
        and gauges, the tracer's span histograms (when tracing), and
        the CAX scope tree under ``"cax"``."""
        reg = MetricsRegistry()
        reg.ingest("engine", self.paging_stats())
        snap = reg.snapshot()
        if self._tracer is not None:
            snap["trace"] = self._tracer.summary()
            snap["histograms"].update(
                self._tracer.metrics.snapshot()["histograms"])
        snap["cax"] = self.telemetry.to_dict()
        return snap


def reference_decode(api: ModelAPI, params, prompts, num_tokens: int,
                     cache_len: int = 128) -> torch.Tensor:
    """Static-batch greedy decode — the token-for-token oracle the engine
    is tested against. prompts: (B, P) ints; returns (B, num_tokens) int32
    on the model's device."""
    prompts = torch.as_tensor(np.asarray(prompts, np.int32),
                              device=api.device)
    B, P = prompts.shape
    cache = api.init_cache(B, cache_len)

    def pos(t):
        return torch.full((B,), t, dtype=torch.int32, device=api.device)

    logits = None
    for t in range(P):
        logits, cache = api.decode_step(params, cache, prompts[:, t], pos(t))
    outs = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(num_tokens):
        outs.append(tok)
        logits, cache = api.decode_step(params, cache, tok, pos(P + i))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(outs, dim=1)
