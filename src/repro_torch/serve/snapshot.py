"""Crash-consistent snapshot/restore for the serve engine.

Port of ``repro/serve/snapshot.py``. The engine's megastep loop is
host-deterministic: given the same request stream, the same policy and
the same pool-transaction clock, every boundary makes the same admission
decisions and every row emits the same tokens. So a snapshot only has to
capture a *consistent cut* at a megastep boundary; everything after the
cut is re-executed rather than logged.

The layer has two artifacts:

* **Snapshots** — every ``snapshot_every`` megasteps the engine drains its
  pipeline, flushes dirty HBM-resident blocks through the billed paging
  path (``PagedKVPool.flush_dirty``, through the ``quant_stream`` kernel)
  and persists the full engine state — request mirrors, queue and policy
  state, the pool's block tables and tensors, tiered host placement and
  per-channel billing totals, the fault injector's clock and rng —
  through :class:`repro_torch.checkpoint.CheckpointManager` (atomic
  rename, sha256 manifest, torn snapshots detected and skipped on load).

* **A write-ahead journal** — between cuts, an append-only jsonl file (one
  generation per cut) records every ``submit()`` after the cut, with the
  full prompt, so restore can resubmit it, and a per-boundary digest
  (admitted rids and a token checksum) that replay verifies against.

Restore loads the newest valid snapshot (``load_checkpoint`` falls back
over older steps when checksums fail), replays the journal chain from that
cut, resubmits journaled requests at their original megastep, and lets
``run()`` re-execute. Any divergence from a boundary record raises
:class:`SnapshotError`. Journal records after the first corrupt line
cannot be trusted to be a prefix of the real history: submits found there
become casualties — FAILED requests with a structured ``error``.

Where the reference rebinds the engine's device state at restore, the
port copies the snapshot's values into the engine's existing tensors
(``_dev``, ``cache`` and the pool's ``hbm`` / ``host_q`` /
``host_scale``): on a CUDA device the engine's step graphs were captured
over those very tensors, so they must stay the same objects.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, decode_json,
                                    encode_json, load_checkpoint)
from repro_torch.serve.queue import FAILED, Request, _rid


def fresh_snapshot_stats() -> dict:
    """Schema for ``engine.stats()["snapshot"]`` — all-zero when disabled."""
    return {
        "snapshots_taken": 0,
        "journal_entries": 0,
        "restore_replayed": 0,
        "resubmitted": 0,
        "casualties": 0,
    }


class SnapshotError(RuntimeError):
    """A snapshot/restore invariant was violated (divergent replay, bad use)."""


# --------------------------------------------------------------------------
# canonical json + crc-framed journal lines
# --------------------------------------------------------------------------


def _py(obj):
    """Recursively convert numpy scalars/arrays to plain Python for json."""
    if isinstance(obj, np.ndarray):
        return [_py(x) for x in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, dict):
        return {k: _py(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_py(x) for x in obj]
    return obj


def _canon(obj) -> str:
    return json.dumps(_py(obj), sort_keys=True, separators=(",", ":"))


def _frame(payload: str) -> str:
    return "%08x %s" % (zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF, payload)


def _unframe(line: str):
    """Return the decoded record, or None if the line is torn/corrupt."""
    line = line.rstrip("\n")
    if len(line) < 10 or line[8] != " ":
        return None
    try:
        want = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF != want:
        return None
    try:
        return json.loads(payload)
    except json.JSONDecodeError:
        return None


def _tok_digest(tok_pairs) -> str:
    """Checksum of this boundary's emitted tokens, keyed by rid."""
    canon = _canon(sorted((int(rid), [int(t) for t in toks]) for rid, toks in tok_pairs))
    return "%08x" % (zlib.crc32(canon.encode("utf-8")) & 0xFFFFFFFF)


def _journal_name(gen: int) -> str:
    return "journal-%09d.jsonl" % gen


# --------------------------------------------------------------------------
# tree pack/unpack: tensors become host copies, "meta" keys are
# json-in-uint8 leaves
# --------------------------------------------------------------------------


def _pack(node):
    if isinstance(node, dict):
        return {
            k: (encode_json(_py(v)) if k == "meta" else _pack(v)) for k, v in node.items()
        }
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    return np.asarray(node)


def _unpack(node):
    if isinstance(node, dict):
        return {
            k: (decode_json(v) if k == "meta" else _unpack(v)) for k, v in node.items()
        }
    return node


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    """Write a captured leaf (numpy array or CPU tensor) into a live
    tensor in place, in the live tensor's dtype and shape."""
    src = torch.as_tensor(src)
    if src.numel() != dst.numel():
        raise SnapshotError(f"{what}: snapshot holds {tuple(src.shape)}, "
                            f"the engine {tuple(dst.shape)} — wrong "
                            "model/config?")
    dst.copy_(src.to(dst.dtype).reshape(dst.shape))


# --------------------------------------------------------------------------
# request mirrors
# --------------------------------------------------------------------------


def _pack_request(r: Request, loc) -> dict:
    return {
        "prompt": np.asarray(r.prompt, np.int32),
        "generated": np.asarray(r.generated, np.int32),
        "meta": {
            "rid": r.rid,
            "max_new": r.max_new_tokens,
            "arrival": r.arrival_step,
            "hint": r.hint_path,
            "tenant": r.tenant,
            "state": r.state,
            "consumed": r.consumed,
            "blocks": [int(b) for b in r.blocks],
            "blocks_freed": bool(r.blocks_freed),
            "slot": r.slot,
            "admitted": r.admitted_step,
            "done": r.done_step,
            "error": r.error,
            "deadline": r.deadline_step,
            "loc": loc,
        },
    }


def _unpack_request(entry: dict) -> tuple[Request, list]:
    meta = entry["meta"]
    r = Request(
        prompt=[int(t) for t in np.asarray(entry["prompt"]).tolist()],
        max_new_tokens=int(meta["max_new"]),
        arrival_step=int(meta["arrival"]),
        hint_path=meta["hint"],
        tenant=meta["tenant"],
        rid=int(meta["rid"]),
    )
    r.state = str(meta["state"])
    r.consumed = int(meta["consumed"])
    r.generated = [int(t) for t in np.asarray(entry["generated"]).tolist()]
    r.blocks = [int(b) for b in meta["blocks"]]
    r.blocks_freed = bool(meta["blocks_freed"])
    r.slot = int(meta["slot"])
    r.admitted_step = int(meta["admitted"])
    r.done_step = int(meta["done"])
    r.error = meta["error"]
    r.deadline_step = None if meta["deadline"] is None else int(meta["deadline"])
    return r, meta["loc"]


def _journal_request(rec: dict) -> Request:
    """A Request rebuilt from a journaled submit record."""
    req = Request(prompt=np.asarray(rec["prompt"], np.int32),
                  max_new_tokens=int(rec["mnew"]),
                  arrival_step=int(rec["arr"]),
                  hint_path=rec["hint"], tenant=rec["ten"],
                  rid=int(rec["rid"]))
    if "dl" in rec:
        req.deadline_step = int(rec["dl"])
    return req


# --------------------------------------------------------------------------
# fault-injector state round-trip
# --------------------------------------------------------------------------


def _fx_state(fx) -> dict:
    return {
        "step": fx.step,
        "seed": fx.seed,
        "rng": fx.rng.bit_generator.state,
        "stats": _py(dict(fx.stats)),
        "degrade": [[int(c), float(v), float(u)] for c, (v, u) in fx._degrade.items()],
        "transient": [[int(c), float(v), float(u)] for c, (v, u) in fx._transient.items()],
        "offline": sorted(int(c) for c in fx._offline),
        # drain order matters to the pool: keep list order, don't sort.
        "newly_offline": [int(c) for c in fx._newly_offline],
        "poison_armed": [int(b) for b in fx._poison_armed],
    }


def _load_fx_state(fx, state: dict) -> None:
    fx.step = int(state["step"])
    fx._cursor = sum(1 for e in fx.events if e.at_step <= fx.step)
    fx.rng = np.random.default_rng(int(state["seed"]))
    fx.rng.bit_generator.state = state["rng"]
    # fx.stats is shared by reference with the pool's and the engine's
    # stats readers: mutate in place rather than rebinding.
    fx.stats.clear()
    fx.stats.update(state["stats"])
    fx._degrade = {int(c): (float(v), float(u)) for c, v, u in state["degrade"]}
    fx._transient = {int(c): (float(v), float(u)) for c, v, u in state["transient"]}
    fx._offline = set(int(c) for c in state["offline"])
    fx._newly_offline = [int(c) for c in state["newly_offline"]]
    fx._poison_armed = [int(b) for b in state["poison_armed"]]


# --------------------------------------------------------------------------
# whole-engine capture / install
# --------------------------------------------------------------------------


def _capture(engine) -> dict:
    """Pack the full engine state at a drained megastep boundary.

    Preconditions (the cut path establishes them): pipeline drained
    (``_inflight`` empty, so no request carries speculative state) and
    dirty HBM blocks already flushed through the billed paging path.
    """
    if engine._inflight:
        raise SnapshotError("cannot snapshot with megasteps in flight — "
                            "drain the pipeline first")
    if engine.tenants:
        raise SnapshotError("snapshot/restore does not cover attached "
                            "tenant workloads yet")

    requests: dict[str, dict] = {}

    def add(r: Request, loc) -> None:
        if r.spec is not None:
            raise SnapshotError(
                f"request {r.rid} carries speculative state at the cut — "
                "the pipeline was not drained")
        requests[f"r{r.rid}"] = _pack_request(r, loc)

    for i, r in enumerate(engine.slots):
        if r is not None:
            add(r, ["slot", i])
    for w, r in enumerate(engine.queue._slots):
        if r is not None:
            add(r, ["wait", w])
    for r in engine.completed.values():
        add(r, ["done"])
    for r in engine.failed.values():
        add(r, ["failed"])

    leaves, prev_util = engine.queue.snapshot_state()
    fx = engine._fx
    dev, cache = engine._device_state()
    tree = {
        "dev": dict(dev),
        # the cache dict's leaves in sorted key order, as the reference's
        # pytree flatten lists them
        "cache": {f"l{i}": cache[k] for i, k in enumerate(sorted(cache))},
        "pool": engine.pool.snapshot_state(),
        "queue": {
            "policy": {f"l{i}": leaf for i, leaf in enumerate(leaves)},
            "meta": {"prev_util": float(prev_util)},
        },
        "requests": requests,
        # the sharded engine's state (its ICI meter); a single-device
        # engine has none, but the reference's restore reads the key
        "extra": {"meta": engine._snapshot_extra_state()},
        "meta": {
            "step_count": int(engine.step_count),
            "megasteps": int(engine.megasteps),
            "host_dispatches": int(engine.host_dispatches),
            "host_blocked": int(engine.host_blocked),
            "rid_next": _rid.peek(),
            "scan_cursor": {str(rid): int(c)
                            for rid, c in engine._scan_cursor.items()},
            "fx": None if fx is None else _fx_state(fx),
            # config sanity stamp: restore refuses a mismatched engine.
            "policy": engine.cfg.policy,
            "max_batch": int(engine.cfg.max_batch),
            "cache_len": int(engine.cfg.cache_len),
        },
    }
    return _pack(tree)


def _install(engine, tree: dict) -> None:
    """Load a captured tree into a freshly constructed engine, writing the
    device state into the engine's own tensors in place."""
    meta = tree["meta"]
    for field in ("policy", "max_batch", "cache_len"):
        got = getattr(engine.cfg, field)
        if got != meta[field]:
            raise SnapshotError(
                f"restore needs the crashed run's engine config: "
                f"{field}={meta[field]} in snapshot, {got} here")

    # request mirrors (rid order: deterministic dict iteration everywhere)
    engine.slots = [None] * engine.cfg.max_batch
    engine.completed, engine.failed = {}, {}
    wait_slots: dict[int, Request] = {}
    rids = sorted(int(k[1:]) for k in tree["requests"])
    for rid in rids:
        r, loc = _unpack_request(tree["requests"][f"r{rid}"])
        if loc[0] == "slot":
            engine.slots[int(loc[1])] = r
        elif loc[0] == "wait":
            wait_slots[int(loc[1])] = r
        elif loc[0] == "done":
            engine.completed[r.rid] = r
        else:
            engine.failed[r.rid] = r

    q = tree["queue"]
    # stateless policies have zero leaves; the checkpoint tree drops the
    # then-empty "policy" subtree entirely.
    pol = q.get("policy", {})
    leaves = [pol[f"l{i}"] for i in range(len(pol))]
    engine.queue.load_state(leaves, q["meta"]["prev_util"], wait_slots)

    # device-side state: the int32 slot mirrors and the KV cache, copied
    # into the engine's tensors (raw dtypes as captured); a sharded engine
    # hands out whole-batch copies and places them on its ranks after
    dev, cache = engine._device_state()
    if set(tree["dev"]) != set(dev):
        raise SnapshotError("slot-state arity mismatch — wrong engine?")
    for k, leaf in dev.items():
        _copy_into(leaf, tree["dev"][k], f"slot state {k}")
    keys = sorted(cache)
    if len(tree["cache"]) != len(keys):
        raise SnapshotError("cache arity mismatch — wrong model/config?")
    for i, k in enumerate(keys):
        _copy_into(cache[k], tree["cache"][f"l{i}"], f"cache {k}")
    engine._place_device_state(dev, cache)

    engine.pool.load_state(tree["pool"])
    engine._load_extra_state(tree["extra"]["meta"])

    engine.step_count = int(meta["step_count"])
    engine.megasteps = int(meta["megasteps"])
    engine.host_dispatches = int(meta["host_dispatches"])
    engine.host_blocked = int(meta["host_blocked"])
    engine._scan_cursor = {int(k): int(v)
                           for k, v in meta["scan_cursor"].items()}
    _rid.seek(int(meta["rid_next"]))
    if meta["fx"] is not None:
        if engine._fx is None:
            raise SnapshotError("snapshot carries fault-injector state but "
                                "this engine has no injector attached")
        _load_fx_state(engine._fx, meta["fx"])


# --------------------------------------------------------------------------
# SnapshotManager
# --------------------------------------------------------------------------


class SnapshotManager:
    """Owns the snapshot directory: periodic cuts, the write-ahead
    journal, and restore/replay. One instance per engine; the engine
    calls the ``note_*`` / ``inject_resubmits`` / ``maybe_cut`` hooks, and
    a disabled engine (``cfg.snapshot_every == 0``) never constructs a
    manager — zero hot-path cost."""

    def __init__(self, directory: str, every: int, *, keep: int = 3):
        if every <= 0:
            raise ValueError("snapshot_every must be positive")
        self.dir = str(directory)
        self.every = int(every)
        os.makedirs(self.dir, exist_ok=True)
        self.ckpt = CheckpointManager(self.dir, keep=keep, num_shards=4)
        self.stats = fresh_snapshot_stats()
        self._journal = None          # open file handle of the current gen
        self._gen: int | None = None  # generation id == cut megastep
        self._last_cut: int | None = None
        self._restored = False        # restored, first re-cut still pending
        # replay state (populated by restore_into)
        self._oracle: list[dict] = []
        self._oracle_pos = 0
        self._resubmit: list[dict] = []   # submit records, sorted by "ms"

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    def reset_stats(self) -> None:
        self.stats.clear()
        self.stats.update(fresh_snapshot_stats())

    # -- journal plumbing ---------------------------------------------------
    def _open_gen(self, gen: int) -> None:
        self.close()
        self._gen = int(gen)
        self._journal = open(
            os.path.join(self.dir, _journal_name(self._gen)), "w")

    def _append(self, record: dict) -> None:
        if self._journal is None:
            if self._restored:
                raise SnapshotError(
                    "restored engine must be driven by run() so the first "
                    "boundary re-cuts the snapshot before journaling")
            self._open_gen(0)
        self._journal.write(_frame(_canon(record)) + "\n")
        self._journal.flush()
        self.stats["journal_entries"] += 1

    # -- engine hooks -------------------------------------------------------
    def note_submit(self, engine, req: Request) -> None:
        """WAL a submit: full prompt, so restore can resubmit it at the
        same megastep. Submits landing between restore() and the first
        re-cut are covered by the imminent re-cut snapshot instead."""
        if self._journal is None and self._restored:
            return
        rec = {"t": "s", "rid": int(req.rid),
               "ms": int(engine.megasteps),
               "arr": int(req.arrival_step),
               "mnew": int(req.max_new_tokens),
               "hint": req.hint_path, "ten": req.tenant,
               "prompt": [int(t) for t in np.asarray(req.prompt).tolist()]}
        if req.deadline_step is not None:
            rec["dl"] = int(req.deadline_step)
        self._append(rec)

    def note_boundary(self, engine, now: int, k: int, adm_rids,
                      tok_pairs) -> None:
        """Journal one reconciled boundary and, during replay, verify it
        against the crashed run's record — bit-exact resume as an
        assertion, not a hope."""
        fx = engine._fx
        record = {
            "t": "b", "now": int(now), "k": int(k),
            "adm": sorted(int(r) for r in adm_rids),
            "tok": _tok_digest(tok_pairs),
            "fx": -1 if fx is None else int(fx.step),
            "nc": len(engine.completed),
            # crash casualties (restore-time FAILures) are not part of
            # the original run's history — keep them out of the oracle.
            "nf": sum(1 for r in engine.failed.values()
                      if not (r.error or {}).get("kind") == "crash"),
        }
        if self._oracle_pos < len(self._oracle):
            want = self._oracle[self._oracle_pos]
            if record != want:
                raise SnapshotError(
                    f"replay diverged at boundary {self._oracle_pos} "
                    f"(megastep start {record['now']}): journal recorded "
                    f"{want}, replay produced {record}")
            self._oracle_pos += 1
            self.stats["restore_replayed"] += 1
        self._append(record)

    # -- resubmission -------------------------------------------------------
    def inject_resubmits(self, engine) -> None:
        """run() loop-top hook (before the pending() check): resubmit
        journaled requests due at this megastep. Runs before a re-taken
        cut so the cut captures exactly what the original cut saw."""
        while self._resubmit and self._resubmit[0]["ms"] <= engine.megasteps:
            engine.queue.submit(_journal_request(self._resubmit.pop(0)))
            self.stats["resubmitted"] += 1

    # -- cuts ---------------------------------------------------------------
    def maybe_cut(self, engine) -> None:
        m = engine.megasteps
        if m % self.every != 0 or self._last_cut == m:
            return
        self.cut(engine)

    def cut(self, engine) -> int:
        """Take one consistent cut at the current megastep boundary:
        drain the pipeline, flush dirty HBM blocks through the billed
        paging path, persist the packed engine tree, rotate the journal
        generation, and re-persist any still-pending resubmit records so
        they survive the old generation being superseded."""
        tracer = getattr(engine, "_tracer", None)
        t0 = tracer.begin("snapshot_cut") if tracer is not None else 0.0
        while engine._inflight:
            engine._reconcile(engine._inflight[0])
        engine.pool.flush_dirty()
        m = int(engine.megasteps)
        tree = _capture(engine)
        self.ckpt.save(m, tree,
                       metadata={"megasteps": m,
                                 "step_count": int(engine.step_count),
                                 "journal": _journal_name(m)},
                       block=True)
        self._open_gen(m)
        self._restored = False
        for rec in self._resubmit:
            if rec["ms"] > m:
                self._append(rec)
        self._last_cut = m
        self.stats["snapshots_taken"] += 1
        if tracer is not None:
            tracer.span("snapshot_cut", t0, megastep=m)
        # journal retention follows snapshot retention: generations older
        # than the oldest kept snapshot can never be replayed again.
        kept = [int(fn.split("_")[1]) for fn in os.listdir(self.dir)
                if fn.startswith("step_")
                and os.path.isdir(os.path.join(self.dir, fn))]
        oldest = min(kept) if kept else m
        for gen in self._journal_gens():
            if gen < oldest and gen != self._gen:
                try:
                    os.remove(os.path.join(self.dir, _journal_name(gen)))
                except OSError:
                    pass
        return m

    # -- restore ------------------------------------------------------------
    def restore_into(self, engine, step: int | None = None, *,
                     disarm: bool = True) -> dict:
        """Load the newest valid snapshot (or ``step``) into ``engine``
        and arm deterministic replay from the journal chain.

        Journal records after the first corrupt line cannot be trusted
        to be a contiguous prefix of history: submits found there become
        *casualties* — FAILED requests with a structured ``error`` in
        ``engine.failed`` — instead of being replayed out of order.
        ``disarm`` drops scheduled crash events so the death just
        recovered from does not re-fire during replay."""
        tracer = getattr(engine, "_tracer", None)
        t0 = tracer.begin("restore") if tracer is not None else 0.0
        tree, manifest = self.ckpt.restore(step)
        m = int(manifest["step"])
        _install(engine, _unpack(tree))

        oracle, resub, casualties = [], {}, {}
        broken = False
        for gen in self._journal_gens():
            if gen < m:
                continue
            with open(os.path.join(self.dir, _journal_name(gen))) as fh:
                for line in fh:
                    rec = _unframe(line)
                    if rec is None:
                        broken = True
                        continue
                    if rec["t"] == "b":
                        if not broken:
                            oracle.append(rec)
                    elif rec["t"] == "s":
                        # cut-time rewrites duplicate pending submits
                        # across generations: first (replayable) copy wins.
                        if rec["rid"] in resub or rec["rid"] in casualties:
                            continue
                        (resub if not broken else casualties)[rec["rid"]] = rec

        for rid in sorted(casualties):
            r = _journal_request(casualties[rid])
            r.deadline_step = None
            r.state = FAILED
            r.error = {"kind": "crash", "step": m,
                       "detail": "journal truncated past this submit; "
                                 "request lost at restore"}
            r.done_step = int(engine.step_count)
            engine.failed[r.rid] = r
            self.stats["casualties"] += 1

        self._oracle, self._oracle_pos = oracle, 0
        self._resubmit = sorted(resub.values(), key=lambda r: (r["ms"], r["rid"]))
        self._last_cut = None
        self._restored = True
        self.close()
        if resub or casualties:
            _rid.seek(1 + max([*resub, *casualties]))
        if engine._fx is not None and disarm:
            engine._fx.disarm_crashes()
        if tracer is not None:
            tracer.span("restore", t0, restored_step=m,
                        casualties=len(casualties))
        return {"restored_step": m,
                "journal_entries": len(oracle) + len(resub),
                "pending_resubmits": len(self._resubmit),
                "casualties": len(casualties)}

    def _journal_gens(self) -> list[int]:
        gens = []
        for fn in os.listdir(self.dir):
            if fn.startswith("journal-") and fn.endswith(".jsonl"):
                try:
                    gens.append(int(fn[len("journal-"):-len(".jsonl")]))
                except ValueError:
                    continue
        return sorted(gens)


# --------------------------------------------------------------------------
# crash-report helpers (launch/serve.py)
# --------------------------------------------------------------------------


def newest_valid_snapshot(directory: str) -> int | None:
    """The step id of the newest snapshot whose checksums verify, or
    None if the directory holds no recoverable snapshot at all."""
    try:
        _, manifest = load_checkpoint(directory)
    except Exception:
        return None
    return int(manifest["step"])


def journal_length(directory: str, from_step: int | None = None) -> int:
    """Valid journal records on disk at/after ``from_step`` (all
    generations when None) — the crash report's replay-horizon figure."""
    total = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for fn in sorted(names):
        if not (fn.startswith("journal-") and fn.endswith(".jsonl")):
            continue
        try:
            gen = int(fn[len("journal-"):-len(".jsonl")])
        except ValueError:
            continue
        if from_step is not None and gen < from_step:
            continue
        with open(os.path.join(directory, fn)) as fh:
            total += sum(1 for line in fh if _unframe(line) is not None)
    return total
