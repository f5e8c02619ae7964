"""WorkloadAPI — non-LLM serving tenants on the paged duplex data plane.

Port of ``repro/serve/workloads.py``. The paper's headline spans three
workloads (LLM, Redis, vector DB) under ONE cgroup-hint-aware scheduler.
``WorkloadAPI`` is the serving-side sibling of ``models.registry.ModelAPI``:
where a ModelAPI tells ``ServeEngine`` how to advance a token batch, a
WorkloadAPI tells it how to advance a *tenant* — a KV store serving
GET/SET ops or a vector-search index walking candidate blocks — against
the same ``PagedKVPool``, the same per-step paging transaction, and the
same policy-driven admission queue as LLM decode.

Tenant contract (each engine step, in order):

  1. ``start`` — the shared ``RequestQueue`` admitted one of this
     tenant's requests into a free tenant slot (policy-ordered, using the
     request's declared ``TrafficProfile`` + hint scope);
  2. ``block_demand`` — the tenant names the pool blocks this step's ops
     touch, grouped by hint path; the engine merges every tenant's demand
     (plus LLM KV paging) into ONE ``PagedKVPool.step_multi`` transaction
     — opted-in scopes ride the fused duplex kernel, withdrawn scopes
     (``duplex_opt_in=False``) the single-direction halves;
  3. ``compute`` — device-only work on the now-resident blocks: value
     writes, gathers, the L2 distance kernel, accumulated into
     device-resident tensors. Tenants perform **zero** device->host syncs
     per step: completion accounting is host-deterministic, index arrays
     go up through pinned memory without blocking, and results sync once
     at the end of a run (``result()``). That is what lets the engine run
     tenants through K-step megasteps; ``completion_in`` (a never-late
     steps-to-finish bound) tells the adaptive megastep where the next
     admission-relevant tenant event can land;
  4. ``retire`` — finished tenant requests leave their slots.

Ops are block-granular (a GET/SET moves one pool block — a batched
MGET/MSET at ``block_tokens`` keys per block), so tenant traffic and LLM
KV traffic are the same currency and one HBM budget covers both.

The reference's four jitted device programs are plain torch functions on
the pool's device here; only ``_visit_blocks`` reaches a kernel
(``kernels.ops.l2_distance``). Fixed-width inputs (sentinel-padded ids,
zero masks) are kept, so the work per step has the reference's shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import requests as requests_lib
from repro_torch.device import to_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve.queue import DECODE, DONE, Request, TrafficProfile

# ---------------------------------------------------------------------------
# tenant device programs
# ---------------------------------------------------------------------------


def _synth_blocks(seeds: torch.Tensor, *, tokens: int,
                  dims: int) -> torch.Tensor:
    """Deterministic block contents from int32 seeds: (n, tokens, dims)
    bf16, ``sin(s*0.7310 + i*0.1730 + j*0.0191)`` over f32 iotas. Both
    tenants generate their stored values on the device with this; tests
    reconstruct expected contents by calling it with the same seeds."""
    dev = seeds.device
    i = torch.arange(tokens, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(dims, dtype=torch.float32, device=dev)[None, None, :]
    s = seeds.to(torch.float32)[:, None, None]
    return torch.sin(s * 0.7310 + i * 0.1730 + j * 0.0191).to(torch.bfloat16)


def _gather_checksum(hbm, slots, mask, acc):
    """Read the masked resident blocks and fold them into the running
    checksum — the GET data path."""
    x = hbm[slots].to(torch.float32)
    per = x.sum(dim=(1, 2)) * mask
    return acc + per.sum()


def _visit_blocks(hbm, slots, mask, queries, best, acc):
    """One step of the HNSW-style walk: gather the visited candidate
    blocks, run the L2 distance kernel, update per-query best distances
    and the traffic checksum. All device-resident."""
    blocks = hbm[slots]                                  # (V, T, D)
    d = kernel_ops.l2_distance(queries, blocks)          # (V, Q, T)
    valid = mask[:, None, None] > 0
    best = torch.minimum(
        best, torch.where(valid, d, torch.inf).amin(dim=(0, 2)))
    acc = acc + torch.where(valid, d, 0.0).sum()
    return best, acc


def _pack_result(best, *, tokens: int, dims: int) -> torch.Tensor:
    """Pack per-query best distances into one result-cache block — the
    write-back burst of the vector walk (§6.5's distance caching)."""
    n = tokens * dims
    reps = -(-n // best.shape[0])
    flat = best.repeat(reps)[:n]
    return flat.reshape(1, tokens, dims).to(torch.bfloat16)


def kv_value_seed(block_id: int, version: int) -> int:
    """Seed for a KV-store block's contents at a given SET version."""
    return (block_id * 100003 + version * 7919) % (2 ** 31 - 1)


class WorkloadAPI:
    """Base serving-tenant contract (see module docstring).

    Subclasses set ``name``, ``n_slots`` (concurrent requests) and
    ``blocks_per_step`` (worst-case pool blocks demanded per engine step
    — the engine reserves this much HBM headroom at ``add_tenant``), and
    implement the four phase hooks.
    """

    name: str = "workload"
    n_slots: int = 1
    blocks_per_step: int = 0

    def __init__(self) -> None:
        self.engine = None
        self._slots: list[Request | None] = []
        self.completed: dict[int, Request] = {}
        self._acc: torch.Tensor | None = None

    # -- lifecycle ---------------------------------------------------------
    def bind(self, engine) -> None:
        """Called by ``ServeEngine.add_tenant``; gives the tenant its pool
        and queue handles, and its device-resident checksum."""
        self.engine = engine
        self._slots = [None] * self.n_slots
        self._acc = torch.zeros((), dtype=torch.float32,
                                device=engine.pool.device)

    def _require_bound(self):
        if self.engine is None:
            raise RuntimeError(
                f"tenant {self.name!r} is not attached to an engine; call "
                f"ServeEngine.add_tenant first")
        return self.engine

    # -- slots -------------------------------------------------------------
    def free_slots(self) -> int:
        return sum(1 for r in self._slots if r is None)

    def running(self) -> list[Request]:
        return [r for r in self._slots if r is not None]

    def pending(self) -> int:
        return len(self.running())

    def start(self, req: Request, now: int) -> None:
        for i, cur in enumerate(self._slots):
            if cur is None:
                req.slot = i
                req.state = DECODE
                req.admitted_step = now
                self._slots[i] = req
                return
        raise RuntimeError(f"tenant {self.name!r} has no free slot")

    def retire(self, now: int) -> list[Request]:
        done = []
        for i, r in enumerate(self._slots):
            if r is not None and self._finished(r):
                r.state = DONE
                r.done_step = now
                self._slots[i] = None
                self.completed[r.rid] = r
                done.append(r)
        return done

    # -- phase hooks (subclass responsibility) -----------------------------
    def _finished(self, req: Request) -> bool:
        raise NotImplementedError

    def completion_in(self, req: Request) -> int | None:
        """Engine steps until this running request finishes, if the
        tenant can predict it. ``None`` = unknown; the engine's adaptive
        megastep then stops at every step while this tenant's work is
        waiting."""
        return None

    def block_demand(self, now: int) -> list[tuple[str, list[int]]]:
        """Blocks this step's ops touch, as (hint_path, ids) groups."""
        raise NotImplementedError

    def compute(self, pool, now: int) -> None:
        """Device-only work on the resident blocks (no host syncs)."""
        raise NotImplementedError

    def stats(self) -> dict:
        return {}

    def result(self):
        """Sync device-resident results to the host (end of run, not per
        step)."""
        return None


# ---------------------------------------------------------------------------
# Redis-style KV-store tenant
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _KVWork:
    """One KV-store request: a stream of block-granular GET/SET ops."""
    pattern: str
    schedule: np.ndarray                 # (n_steps, 2) int32 [gets, sets]
    rng: np.random.Generator
    cursor: int = 0
    read_cursor: int = 0
    step_reads: list = dataclasses.field(default_factory=list)
    step_writes: list = dataclasses.field(default_factory=list)
    ops_done: int = 0
    ops_target: int = -1                 # finish after serving this many
                                         # ops (-1: run the schedule out)
    bk_get: int = 0                      # queued, not-yet-served ops
    bk_set: int = 0                      # (service-driven mode only)


class KVStoreTenant(WorkloadAPI):
    """GET/SET ops over pool-resident values (§6.3, Fig. 5).

    The tenant owns a keyspace of up to ``store_blocks`` pool blocks
    (each a batched value row: ``block_tokens`` keys wide). Requests are
    op *streams* shaped by the five Fig. 5 access patterns — the
    ``core.requests.redis_pattern_specs`` generators, converted to
    per-step block-op counts that really execute: SETs write synthesized
    values through ``PagedKVPool.write``, GETs gather resident blocks into
    a device checksum, and misses/evictions become the pool's real page
    traffic.

    All of the tenant's traffic is scoped under ``/serve/<name>`` (per
    pattern: ``/serve/<name>/<pattern>``). The default name ``redis`` maps
    onto the registered ``default_serving_hints`` scopes (including the
    read-/write-heavy withdrawal).
    """

    def __init__(self, name: str = "redis", n_slots: int = 4,
                 ops_per_step: int = 2, store_blocks: int = 24,
                 offered_gbps: float = 8.0, phase_steps: int = 8,
                 seed: int = 0):
        super().__init__()
        self.name = name
        self.hint_root = f"/serve/{name}"
        self.n_slots = n_slots
        self.ops_per_step = ops_per_step
        self.store_blocks = store_blocks
        self.offered_gbps = offered_gbps
        # engine steps per direction phase for the phased patterns, so
        # requests span several phases even in short runs.
        self.phase_steps = phase_steps
        self.blocks_per_step = n_slots * ops_per_step
        self._seed = seed
        self._n_submitted = 0
        self._store: list[int] = []          # owned block ids, write order
        self._version: dict[int, int] = {}   # block id -> SET count
        self._write_cursor = 0
        self.ops_done = 0

    # -- intake ------------------------------------------------------------
    def submit(self, pattern: str, n_steps: int, arrival_step: int = 0,
               hint_path: str | None = None,
               phase: str | None = None,
               n_ops: int | None = None) -> Request:
        """Queue one op stream of a Fig. 5 pattern.

        The per-step (gets, sets) schedule is derived from the pattern's
        ``core.requests`` arrival generator, scaled to at most
        ``ops_per_step`` block ops per step. ``sequential`` streams
        alternate read-first / write-first phase offsets across
        submissions (force one leaning with ``phase="read"``/``"write"``)
        and are tagged with the ``/serve/redis/seq/{read,write}`` scopes.

        ``n_ops`` makes completion *service-driven*: the request finishes
        once that many ops were served, and its ops queue behind a
        per-step duplex service budget (``_serve_queued``). Without it the
        request runs the whole ``n_steps`` schedule, unthrottled.
        """
        engine = self._require_bound()
        idx = self._n_submitted
        self._n_submitted += 1
        specs = requests_lib.redis_pattern_specs(
            pattern, offered_gbps=self.offered_gbps * self.n_slots,
            n_streams=max(4, self.n_slots))
        spec = specs[idx % len(specs)]
        scale = max(1, spec.phase_steps // self.phase_steps)
        spec = dataclasses.replace(
            spec, phase_steps=max(2, spec.phase_steps // scale))
        arr = np.asarray(requests_lib.generate(
            [spec], n_steps, seed=self._seed + idx), np.float64)[:, 0, :]
        if pattern == "sequential":
            # write-first streams shift one phase earlier so opposite
            # directions coexist across the running set.
            if phase is None:
                phase = "write" if idx % 2 else "read"
            if phase == "write":
                arr = np.roll(arr, -spec.phase_steps, axis=0)
            if hint_path is None:
                hint_path = f"{self.hint_root}/seq/{phase}"
        elif hint_path is None:
            hint_path = f"{self.hint_root}/{pattern}"
        tot = arr.sum(axis=1)
        scale = max(float(tot.max()), 1e-9)
        per_step = np.ceil(self.ops_per_step * tot / scale).astype(np.int32)
        with np.errstate(invalid="ignore"):
            frac_r = np.where(tot > 0, arr[:, 0] / np.maximum(tot, 1e-9),
                              0.0)
        # error-diffused rounding: skewed mixes (read-heavy 10:1) keep
        # their minority direction instead of rounding it away entirely.
        gets = np.zeros_like(per_step)
        err = 0.0
        for t in range(len(per_step)):
            x = float(per_step[t]) * float(frac_r[t]) + err
            g = int(np.clip(np.round(x), 0, per_step[t]))
            err = x - g
            gets[t] = g
        sets = per_step - gets
        work = _KVWork(pattern=pattern,
                       schedule=np.stack([gets, sets], axis=1),
                       rng=np.random.default_rng(self._seed + 7 * idx),
                       ops_target=-1 if n_ops is None else int(n_ops))
        profile = TrafficProfile(
            backlog_read=float(arr[:, 0].sum()),
            backlog_write=float(arr[:, 1].sum()),
            head_read=float(arr[0, 0]), head_write=float(arr[0, 1]))
        req = Request(prompt=np.zeros(1, np.int32), max_new_tokens=1,
                      arrival_step=arrival_step, hint_path=hint_path,
                      tenant=self.name, work=work, profile=profile)
        return engine.queue.submit(req)

    def preload(self, n_blocks: int) -> list[int]:
        """Populate the keyspace before serving (the RDB-snapshot load):
        allocate and write ``n_blocks`` value blocks through the pool in
        HBM-capacity-sized chunks, so GETs address a full keyspace from
        step 0."""
        engine = self._require_bound()
        pool = engine.pool
        n = min(n_blocks, self.store_blocks - len(self._store))
        ids = pool.alloc(n)
        chunk = max(1, min(self.blocks_per_step, pool.hbm_capacity))
        T, D = pool.block_shape
        for i in range(0, n, chunk):
            part = ids[i:i + chunk]
            pool.step(part, hint_path=self.hint_root)
            seeds = []
            for b in part:
                self._version[b] = 1
                seeds.append(kv_value_seed(b, 1))
            pad = np.full((chunk,), pool.n_blocks, np.int32)
            sv = np.zeros((chunk,), np.int32)
            pad[:len(part)] = part
            sv[:len(seeds)] = seeds
            pool.write(pad, _synth_blocks(to_device(sv, pool.device),
                                          tokens=T, dims=D))
        self._store.extend(ids)
        return ids

    # -- phases ------------------------------------------------------------
    def _finished(self, req: Request) -> bool:
        w = req.work
        if w.ops_target >= 0 and w.ops_done >= w.ops_target:
            return True
        return w.cursor >= len(w.schedule)

    def completion_in(self, req: Request) -> int | None:
        """Steps until the op stream finishes: exact for schedule-driven
        streams; for service-driven (``n_ops``) streams a bound that
        assumes the request gets the whole tenant service rate, which is
        never later than the real completion."""
        w = req.work
        if self._finished(req):
            return 0
        if w.ops_target >= 0:
            rate = max(1, self.ops_per_step * self.n_slots)
            return max(1, -(-(w.ops_target - w.ops_done) // rate))
        return max(1, len(w.schedule) - w.cursor)

    def _serve_queued(self, svc: "list[Request]", pool) -> None:
        """Drain service-driven backlogs against the per-step duplex
        budget: up to half the active streams' aggregate op rate per
        direction, round-robin across requests (each preferring its
        deeper direction)."""
        n = len(svc)
        cap = max(1, (self.ops_per_step * n) // 2)
        budget_r = budget_w = cap
        total = self.ops_per_step * n
        progress = True
        while progress and total > 0 and (budget_r or budget_w):
            progress = False
            for req in svc:
                if total <= 0:
                    break
                w = req.work
                # with an empty store a GET has no target: keep the op
                # queued until SETs populate the keyspace.
                get_ok = (w.bk_get > 0 and budget_r > 0
                          and bool(self._store))
                set_ok = w.bk_set > 0 and budget_w > 0
                if get_ok and set_ok:
                    if w.bk_get >= w.bk_set:
                        set_ok = False
                    else:
                        get_ok = False
                if get_ok:
                    b = self._read_target(w)
                    if b is not None:
                        w.step_reads.append(b)
                    w.bk_get -= 1
                    budget_r -= 1
                    total -= 1
                    progress = True
                elif set_ok:
                    w.step_writes.append(self._write_target(pool, w))
                    w.bk_set -= 1
                    budget_w -= 1
                    total -= 1
                    progress = True

    def _write_target(self, pool, w: _KVWork) -> int:
        if len(self._store) < self.store_blocks:
            b = pool.alloc(1)[0]
            self._store.append(b)
            return b
        if w.pattern == "sequential":
            b = self._store[self._write_cursor % len(self._store)]
            self._write_cursor += 1
        else:
            b = self._store[int(w.rng.integers(len(self._store)))]
        return b

    def _read_target(self, w: _KVWork) -> int | None:
        if not self._store:
            return None
        if w.pattern == "sequential":
            b = self._store[w.read_cursor % len(self._store)]
            w.read_cursor += 1
        else:
            b = self._store[int(w.rng.integers(len(self._store)))]
        return b

    def block_demand(self, now: int) -> list[tuple[str, list[int]]]:
        pool = self._require_bound().pool
        demand: dict[str, list[int]] = {}
        svc: list[Request] = []
        for req in self.running():
            w = req.work
            if self._finished(req):
                continue
            n_get, n_set = (int(x) for x in w.schedule[w.cursor])
            if w.ops_target >= 0:
                # service-driven: this step's scheduled ops join the
                # backlog; the duplex budget decides what serves now.
                w.bk_get += n_get
                w.bk_set += n_set
                svc.append(req)
                continue
            # open loop: every scheduled op serves this step.
            w.step_writes = [self._write_target(pool, w)
                             for _ in range(n_set)]
            w.step_reads = [b for b in (self._read_target(w)
                                        for _ in range(n_get))
                            if b is not None]
        if svc:
            self._serve_queued(svc, pool)
        for req in self.running():
            w = req.work
            if self._finished(req) or not (w.step_writes or w.step_reads):
                continue
            # full-block SETs replace the whole value: a swapped-out
            # target installs fresh instead of paging its dead contents in.
            pool.invalidate(w.step_writes)
            ids = w.step_writes + w.step_reads
            demand.setdefault(req.hint_path, []).extend(ids)
        return list(demand.items())

    def compute(self, pool, now: int) -> None:
        # last-wins per block: two SETs hitting one block in a step reach
        # the scatter once, with the version _version records.
        write_seeds: dict[int, int] = {}
        reads: list[int] = []
        for req in self.running():
            w = req.work
            if self._finished(req):
                continue
            for b in w.step_writes:
                self._version[b] = self._version.get(b, 0) + 1
                write_seeds[b] = kv_value_seed(b, self._version[b])
            reads.extend(w.step_reads)
            served = len(w.step_writes) + len(w.step_reads)
            w.ops_done += served
            self.ops_done += served
            w.step_writes, w.step_reads = [], []
            w.cursor += 1
        T, D = pool.block_shape
        W = max(1, self.blocks_per_step)
        if write_seeds:
            writes = list(write_seeds)
            ids = np.full((W,), pool.n_blocks, np.int32)   # sentinel pad
            sv = np.zeros((W,), np.int32)
            ids[:len(writes)] = writes
            sv[:len(writes)] = [write_seeds[b] for b in writes]
            pool.write(ids, _synth_blocks(to_device(sv, pool.device),
                                          tokens=T, dims=D))
        if reads:
            slots = np.zeros((W,), np.int64)
            mask = np.zeros((W,), np.float32)
            slots[:len(reads)] = pool.slot_of[np.asarray(reads, np.int32)]
            mask[:len(reads)] = 1.0
            self._acc = _gather_checksum(
                pool.hbm, to_device(slots, pool.device),
                to_device(mask, pool.device), self._acc)

    def stats(self) -> dict:
        return {"ops": self.ops_done, "store_blocks": len(self._store)}

    def result(self) -> float:
        """End-of-run checksum sync (the only device->host transfer the
        tenant performs)."""
        return float(self._acc)


# ---------------------------------------------------------------------------
# Vector-search tenant
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _VecWork:
    """One query-stream request: an HNSW-style walk with result caching."""
    n_steps: int
    rng: np.random.Generator
    queries: torch.Tensor                # (Q, D) f32, device
    best: torch.Tensor                   # (Q,) f32 running minima, device
    result_block: int = -1
    cursor: int = 0
    step_visits: list = dataclasses.field(default_factory=list)
    write_result: bool = False
    visited: set = dataclasses.field(default_factory=set)


class VectorSearchTenant(WorkloadAPI):
    """HNSW-style batched candidate walk with write-back result caching
    (§6.5, Fig. 7).

    The dataset lives in pool blocks (``block_tokens`` vectors of
    dimension ``kv_dims`` each), built by a sequential write stream while
    queries run. Each step, every running query batch visits a few
    candidate blocks, folds them through the ``l2_distance`` kernel into
    device-resident best-so-far minima, and every ``result_every`` steps
    writes its distance cache back to a result block — the write bursts
    that make the walk's traffic mixed-direction.
    """

    def __init__(self, name: str = "vectordb", n_slots: int = 2,
                 n_queries: int = 4, visits_per_step: int = 2,
                 data_blocks: int = 12, load_per_step: int = 1,
                 result_every: int = 4, seed: int = 0):
        super().__init__()
        self.name = name
        self.hint_root = f"/serve/{name}"
        self.n_slots = n_slots
        self.n_queries = n_queries
        self.visits_per_step = visits_per_step
        self.data_blocks = data_blocks
        self.load_per_step = load_per_step
        self.result_every = result_every
        self.blocks_per_step = (load_per_step
                                + n_slots * (visits_per_step + 1))
        self._seed = seed
        self._n_submitted = 0
        self._data: list[int] = []           # loaded dataset block ids
        self._load_plan: list[int] = []
        self.queries_done = 0

    def data_seed(self, index: int) -> int:
        """Seed of the index-th dataset block's contents."""
        return (self._seed * 31 + index) * 2654435761 % (2 ** 31 - 1)

    # -- intake ------------------------------------------------------------
    def submit(self, n_steps: int, arrival_step: int = 0,
               hint_path: str | None = None) -> Request:
        engine = self._require_bound()
        if hint_path is None:
            hint_path = self.hint_root
        idx = self._n_submitted
        self._n_submitted += 1
        T, D = engine.pool.block_shape
        dev = engine.pool.device
        rng = np.random.default_rng(self._seed + 13 * idx)
        queries = to_device(
            rng.standard_normal((self.n_queries, D)).astype(np.float32), dev)
        work = _VecWork(n_steps=n_steps, rng=rng, queries=queries,
                        best=torch.full((self.n_queries,), torch.inf,
                                        dtype=torch.float32, device=dev))
        block_bytes = float(T * D * 2)
        reads = n_steps * self.visits_per_step * block_bytes
        writes = (n_steps / max(self.result_every, 1)) * block_bytes
        profile = TrafficProfile(
            backlog_read=reads, backlog_write=writes,
            head_read=self.visits_per_step * block_bytes, head_write=0.0)
        req = Request(prompt=np.zeros(1, np.int32), max_new_tokens=1,
                      arrival_step=arrival_step, hint_path=hint_path,
                      tenant=self.name, work=work, profile=profile)
        return engine.queue.submit(req)

    # -- phases ------------------------------------------------------------
    def _finished(self, req: Request) -> bool:
        return req.work.cursor >= req.work.n_steps

    def completion_in(self, req: Request) -> int | None:
        return max(1, req.work.n_steps - req.work.cursor)

    def block_demand(self, now: int) -> list[tuple[str, list[int]]]:
        pool = self._require_bound().pool
        demand: dict[str, list[int]] = {}
        live = [r for r in self.running() if not self._finished(r)]
        # dataset build stream: load the next blocks while queries run.
        self._load_plan = []
        if live and len(self._data) < self.data_blocks:
            n = min(self.load_per_step,
                    self.data_blocks - len(self._data))
            self._load_plan = pool.alloc(n)
            demand.setdefault(f"{self.hint_root}/build",
                              []).extend(self._load_plan)
        for req in live:
            w = req.work
            if w.result_block < 0:
                w.result_block = pool.alloc(1)[0]
            if self._data:
                picks = w.rng.integers(len(self._data),
                                       size=self.visits_per_step)
                w.step_visits = [int(p) for p in picks]
                w.visited.update(w.step_visits)
                demand.setdefault(req.hint_path, []).extend(
                    self._data[p] for p in w.step_visits)
            else:
                w.step_visits = []
            w.write_result = (w.cursor + 1) % self.result_every == 0
            if w.write_result:
                demand.setdefault(f"{self.hint_root}/results",
                                  []).append(w.result_block)
        return list(demand.items())

    def compute(self, pool, now: int) -> None:
        T, D = pool.block_shape
        dev = pool.device
        if self._load_plan:
            seeds = [self.data_seed(len(self._data) + i)
                     for i in range(len(self._load_plan))]
            ids = np.full((self.load_per_step,), pool.n_blocks, np.int32)
            sv = np.zeros((self.load_per_step,), np.int32)
            ids[:len(self._load_plan)] = self._load_plan
            sv[:len(seeds)] = seeds
            pool.write(ids, _synth_blocks(to_device(sv, dev), tokens=T,
                                          dims=D))
            self._data.extend(self._load_plan)
            self._load_plan = []
        V = self.visits_per_step
        for req in self.running():
            w = req.work
            if self._finished(req):
                continue
            if w.step_visits:
                slots = np.zeros((V,), np.int64)
                mask = np.zeros((V,), np.float32)
                ids = np.asarray([self._data[p] for p in w.step_visits],
                                 np.int32)
                slots[:ids.size] = pool.slot_of[ids]
                mask[:ids.size] = 1.0
                w.best, self._acc = _visit_blocks(
                    pool.hbm, to_device(slots, dev), to_device(mask, dev),
                    w.queries, w.best, self._acc)
            if w.write_result:
                pool.write(np.asarray([w.result_block], np.int32),
                           _pack_result(w.best, tokens=T, dims=D))
                w.write_result = False
            w.step_visits = []
            w.cursor += 1

    def retire(self, now: int) -> list[Request]:
        done = super().retire(now)
        for req in done:
            self.queries_done += self.n_queries
            # the result cache block is released with the request; its
            # final contents were already written through the pool.
            if req.work.result_block >= 0:
                self._require_bound().pool.free([req.work.result_block])
        return done

    def stats(self) -> dict:
        return {"queries": self.queries_done,
                "data_blocks": len(self._data)}

    def result(self) -> dict:
        """End-of-run sync of per-request best distances + checksum."""
        return {
            "checksum": float(self._acc),
            "best": {rid: r.work.best.cpu().numpy()
                     for rid, r in sorted(self.completed.items())},
        }
