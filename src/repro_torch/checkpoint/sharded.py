"""Sharded, integrity-checked, async checkpointing.

Port of ``repro/checkpoint/sharded.py``, with the reference's on-disk
layout (one directory per step, atomically renamed into place):

    <root>/step_000042/
        manifest.json     # leaf paths, shapes, dtypes, shard map, sha256s,
                          # user metadata
        shard_000.npz     # round-robin leaf assignment (num_shards files)
        shard_001.npz

Fault-tolerance properties:
  * a partially-written checkpoint is never visible (tmp dir + rename);
  * every shard is sha256-verified on load — corrupt shards are detected,
    and ``load_checkpoint`` falls back to the previous step if asked;
  * the async writer runs on a background thread.

A tree is a nested dict whose leaves are numpy arrays or torch tensors
(any device); leaf paths are the ``/``-joined keys, in sorted key order
as the reference's pytree flatten gives them, and empty dicts carry no
leaf. numpy's npz has no bfloat16: a bf16 tensor is stored as its
``uint16`` bits with ``"bfloat16"`` as its manifest dtype, as the
reference stores it, and loads back as a CPU bf16 tensor (the bits
viewed through ``int16``). Every other leaf loads as a numpy array.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

MANIFEST = "manifest.json"


def _host_leaf(leaf):
    """A host copy of one leaf, taken before an async write: a CPU tensor
    for a torch tensor, a numpy array otherwise."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _encode_leaf(leaf) -> tuple[np.ndarray, str]:
    """(array npz can store, manifest dtype) of one host leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    leaf = np.asarray(leaf)
    if leaf.dtype.kind not in "fiub" and not leaf.dtype.names:
        raise TypeError(f"cannot checkpoint a leaf of dtype {leaf.dtype}")
    return leaf, str(leaf.dtype)


def _decode_leaf(raw: np.ndarray, dtype_str: str):
    if str(raw.dtype) == dtype_str:
        return raw
    if dtype_str == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).copy()).view(
            torch.bfloat16)
    raise ValueError(f"checkpoint leaf dtype {dtype_str} stored as "
                     f"{raw.dtype} cannot be read back")


def encode_json(obj) -> np.ndarray:
    """Pack a JSON-serializable object into a uint8 leaf so non-array
    state (request metadata, rng state, free-list order...) rides the
    same sharded, sha256-verified npz path as tensor leaves. Keys are
    sorted so equal state encodes byte-equal."""
    data = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return np.frombuffer(data.encode("utf-8"), dtype=np.uint8).copy()


def decode_json(arr: np.ndarray):
    """Inverse of :func:`encode_json`."""
    return json.loads(np.asarray(arr, dtype=np.uint8).tobytes().decode(
        "utf-8"))


def _leaf_paths(tree) -> tuple[list[str], list]:
    """``/``-joined leaf paths and their leaves, dict keys sorted."""
    paths, leaves = [], []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif node is not None:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _rebuild(paths: list[str], leaves: list) -> dict:
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(root: str, step: int, tree, *, num_shards: int = 4,
                    metadata: dict | None = None) -> str:
    """Write checkpoint for ``step``; returns the final directory path."""
    paths, leaves = _leaf_paths(tree)
    encoded = [_encode_leaf(x) for x in leaves]
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=root)
    try:
        shard_of = {p: i % num_shards for i, p in enumerate(paths)}
        digests = {}
        for s in range(num_shards):
            fname = os.path.join(tmp, f"shard_{s:03d}.npz")
            payload = {p.replace("/", "\\"): arr
                       for p, (arr, _) in zip(paths, encoded)
                       if shard_of[p] == s}
            np.savez(fname, **payload)
            digests[f"shard_{s:03d}.npz"] = _sha256(fname)
        manifest = {
            "step": step,
            "num_shards": num_shards,
            "leaves": {p: {"shape": list(arr.shape), "dtype": dt,
                           "shard": shard_of[p]}
                       for p, (arr, dt) in zip(paths, encoded)},
            "sha256": digests,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):          # overwrite-safe
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = _steps(root)
    return steps[-1] if steps else None


def load_checkpoint(root: str, step: int | None = None, *,
                    verify: bool = True, fallback: bool = True):
    """Load (tree, manifest). Corrupt checkpoints raise or fall back."""
    steps = _steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    candidates = [step] if step is not None else list(reversed(steps))
    last_err: Exception | None = None
    for st in candidates:
        d = os.path.join(root, f"step_{st:09d}")
        try:
            with open(os.path.join(d, MANIFEST)) as f:
                manifest = json.load(f)
            if verify:
                for fname, digest in manifest["sha256"].items():
                    actual = _sha256(os.path.join(d, fname))
                    if actual != digest:
                        raise IOError(
                            f"checkpoint {d}/{fname} hash mismatch")
            shards = {}
            for s in range(manifest["num_shards"]):
                with np.load(os.path.join(d, f"shard_{s:03d}.npz")) as z:
                    shards[s] = {k: z[k] for k in z.files}
            paths = list(manifest["leaves"])
            leaves = [
                _decode_leaf(
                    shards[manifest["leaves"][p]["shard"]]
                    [p.replace("/", "\\")],
                    manifest["leaves"][p]["dtype"])
                for p in paths
            ]
            return _rebuild(paths, leaves), manifest
        except Exception as e:                      # noqa: BLE001
            last_err = e
            if not fallback or step is not None:
                raise
    raise IOError(f"all checkpoints under {root} failed to load: {last_err}")


class CheckpointManager:
    """Async checkpoint writer with retention."""

    def __init__(self, root: str, *, keep: int = 3, num_shards: int = 4):
        self.root = root
        self.keep = keep
        self.num_shards = num_shards
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, metadata: dict | None = None,
             block: bool = False):
        self.wait()                                 # one in flight at a time
        paths, leaves = _leaf_paths(tree)           # snapshot before async
        host_tree = _rebuild(paths, [_host_leaf(x) for x in leaves])

        def work():
            try:
                save_checkpoint(self.root, step, host_tree,
                                num_shards=self.num_shards,
                                metadata=metadata)
                self._gc()
            except Exception as e:                  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def restore(self, step: int | None = None):
        return load_checkpoint(self.root, step)

    def latest_step(self):
        return latest_step(self.root)

    def _gc(self):
        steps = _steps(self.root)
        for st in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{st:09d}"),
                          ignore_errors=True)
