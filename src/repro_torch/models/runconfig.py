"""Trace-time model-execution knobs (set by launchers, read by models):
the port of ``repro/models/runconfig.py``.

  remat       — run each layer of ``scan`` under
                ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``
                (activation rematerialization: the backward recomputes a
                layer's activations from its input instead of keeping
                them). It nests with the q-block checkpoint in
                ``layers.attention``.
  scan_unroll — accepted and recorded, as the reference's is. The
                reference unrolls its layer scans in the dry-run because
                XLA's cost analysis visits a while body once; the port's
                layer loop is an eager Python loop, always unrolled, so a
                FLOP or collective counter sees every layer whatever the
                knob says. ``layers.attention`` reads it as the
                reference's does: widen the q block until there are at
                most 8 of them (the same rows, fewer and larger blocks).
  shard_env   — ``(mesh, dp_axes, tp_axis)`` of the dry-run: ``constrain``
                redistributes a DTensor to the reference's layout and
                ``tp_size`` reads the tensor axis. ``mesh`` is a
                ``torch.distributed`` ``DeviceMesh`` or anything with a
                ``shape`` dict (``launch.mesh.abstract_mesh``).

Uses contextvars so nested and parallel traces stay isolated.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.utils.checkpoint

_remat = contextvars.ContextVar("repro_torch_remat", default=False)
_unroll = contextvars.ContextVar("repro_torch_scan_unroll", default=False)
# (mesh, dp_axes tuple, tp axis name) or None
_shard_env = contextvars.ContextVar("repro_torch_shard_env", default=None)


@contextlib.contextmanager
def options(remat: bool | None = None, scan_unroll: bool | None = None,
            shard_env: tuple | None = None):
    tokens = []
    if remat is not None:
        tokens.append((_remat, _remat.set(remat)))
    if scan_unroll is not None:
        tokens.append((_unroll, _unroll.set(scan_unroll)))
    if shard_env is not None:
        tokens.append((_shard_env, _shard_env.set(shard_env)))
    try:
        yield
    finally:
        for var, tok in reversed(tokens):
            var.reset(tok)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mesh-like object
    with a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (mesh.size(i) for i in range(mesh.ndim))))
    return dict(mesh.shape)


def _axes_size(shape: dict, axes) -> int:
    size = 1
    for a in axes:
        size *= shape[a]
    return size


def resolve(axes: tuple, dims: tuple[int, ...], mesh, dp, tp) -> tuple:
    """The reference's ``constrain`` spec for a tensor of shape ``dims``:
    a PartitionSpec-like tuple, one entry a dim (None, an axis name, or a
    tuple of axis names). "dp" and "dpt" take the largest prefix of the
    batch axes (and, for "dpt", the tensor axis) whose size divides the
    dim; "tp" takes the tensor axis unless there is none or the dim is
    smaller than the axis (kv heads < tp replicate; larger dims may be
    sharded unevenly, as GSPMD pads them)."""
    shape = mesh_shape(mesh)
    parts = []
    for dim, a in zip(dims, axes):
        if a in ("dp", "dpt"):
            full = tuple(dp) + ((tp,) if (a == "dpt" and tp) else ())
            chosen = None
            for k in range(len(full), 0, -1):
                if dim % _axes_size(shape, full[:k]) == 0:
                    chosen = full[:k]
                    break
            parts.append(chosen)
        elif a == "tp":
            parts.append(None if tp is None or dim < shape[tp] else tp)
        else:
            parts.append(a)
    return tuple(parts)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for a
    PartitionSpec-like ``spec``: mesh dim i is ``Shard(d)`` when dim d's
    entry names axis i, else ``Replicate()``. A dim over several axes,
    e.g. ``("pod", "data")``, must list them in mesh order: DTensor splits
    a dim sharded on several mesh dims in mesh-dim order (the first mesh
    dim outermost), and JAX in the tuple's order, so the two agree only
    then."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part} is not in mesh order "
                             f"{tuple(names)}: DTensor would split dim {d} "
                             f"in another order than JAX does")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims "
                                 f"of {spec}")
            out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a dry-run's sharded leaf)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, axes: tuple):
    """Pin an activation's sharding (the identity outside a shard env).

    ``axes`` entries: "dp" (batch axes), "tp" (tensor axis), "dpt" (batch
    over every axis), None. Inside a shard env a DTensor is redistributed
    to the placements of ``resolve``'s spec; any other tensor, and every
    tensor outside an env, is returned untouched."""
    env = _shard_env.get()
    if env is None or not is_dtensor(x):
        return x
    mesh, dp, tp = env
    want = placements(resolve(axes, tuple(x.shape), mesh, dp, tp), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def gather(tree):
    """Parameters ready for use: inside a shard env, each DTensor leaf
    gathered over every mesh axis but the tensor axis (FSDP's all-gather
    before a layer computes; autograd reduce-scatters its gradient back),
    so a matmul meets Megatron-style operands (batch-sharded activations,
    tensor-sharded weights) and not a weight sharded on its contracted
    dim; the identity everywhere else. The layer bodies call it inside
    ``scan``'s checkpoint, so under remat the gathered weights are
    gathered again in the backward, not kept."""
    env = _shard_env.get()
    if env is None:
        return tree
    from torch.distributed.tensor import Replicate

    mesh, _dp, tp = env
    names = mesh.mesh_dim_names

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if not is_dtensor(t):
            return t
        want = [p if names[i] == tp else Replicate()
                for i, p in enumerate(t.placements)]
        if tuple(want) == tuple(t.placements):
            return t
        return t.redistribute(mesh, want)

    return one(tree)


def replicate(x):
    """A DTensor gathered whole on every rank (the identity for any other
    tensor)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate()] * x.device_mesh.ndim
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


_local_scale = contextvars.ContextVar("repro_torch_local_scale",
                                     default=None)


@contextlib.contextmanager
def local_region(devices: int):
    """Mark a ``local_map`` region: its ops run on one rank's shards, and
    a counter of global work scales each by ``devices`` (every rank runs
    its own share of the region)."""
    tok = _local_scale.set(devices)
    try:
        yield
    finally:
        _local_scale.reset(tok)


def local_scale() -> int | None:
    """The active ``local_region``'s device count, or None."""
    return _local_scale.get()


def placements_axes(x) -> tuple:
    """The mesh axes a DTensor's dim 0 is sharded over."""
    names = x.device_mesh.mesh_dim_names
    return tuple(n for n, p in zip(names, x.placements)
                 if getattr(p, "dim", None) == 0)


def along(t, x, dim: int):
    """A 1-D plain tensor ``t`` laid out like ``x``'s dim ``dim`` when
    ``x`` is a DTensor (each rank keeps its slice: an index vector that
    lines up with a sharded dim); ``t`` itself otherwise."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(0) if getattr(p, "dim", None) == dim else Replicate()
          for p in x.placements]
    try:
        return distribute_tensor(t, x.device_mesh, pl, src_data_rank=None)
    except TypeError:                      # an older distribute_tensor
        return distribute_tensor(t, x.device_mesh, pl)


def unroll_enabled() -> bool:
    return _unroll.get()


def shard_env():
    """The active ``(mesh, dp_axes, tp_axis)`` or None."""
    return _shard_env.get()


def tp_size() -> int | None:
    """Size of the tensor axis in the active shard env (None outside)."""
    env = _shard_env.get()
    if env is None:
        return None
    mesh, _dp, tp = env
    return mesh_shape(mesh)[tp] if tp is not None else None


def _take(tree, i: int):
    """Element ``i`` of every leaf of ``tree`` (dicts, tuples and lists of
    tensors; a ``range`` gives its i-th int; None stays None)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(v, i) for v in tree)
    if tree is None:
        return None
    return tree[i]


def _length(tree) -> int | None:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            n = _length(v)
            if n is not None:
                return n
        return None
    if tree is None:
        return None
    return len(tree)


def _stack(ys: list):
    """``ys`` (one tree a step) stacked leaf by leaf, as ``lax.scan``
    stacks its outputs; a step that returns None gives None."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys])
                           for j in range(len(first)))
    return torch.stack(ys)


def scan(body, init, xs, length: int | None = None):
    """The port's layer loop: ``lax.scan`` semantics (``body(carry, x_i)
    -> (carry, y_i)``; returns the last carry and the stacked ys) as an
    eager Python loop, each step under ``torch.utils.checkpoint`` when
    remat is on. ``xs`` is a tree of tensors with a leading layer axis
    (``range`` leaves give the layer index)."""
    n = _length(xs) if length is None else length
    if _remat.get():
        def step(carry, x):
            return torch.utils.checkpoint.checkpoint(
                body, carry, x, use_reentrant=False)
    else:
        step = body
    carry, ys = init, []
    for i in range(n):
        carry, y = step(carry, _take(xs, i))
        ys.append(y)
    return carry, (_stack(ys) if ys else None)
