"""The ``data x model`` device mesh of sharded serving (port of
``repro/launch/mesh.py``'s ``make_debug_mesh``, ``data_axes`` and
``axis_size``).

A ``Mesh`` is a (data, model) grid of ``torch.device``s. A device may
appear more than once: each entry is one rank, and ranks on one device
are logical ranks with tensors of their own (the port's counterpart of
the reference's ``--xla_force_host_platform_device_count`` host
devices). ``serve.shard.ShardedServeEngine`` runs one megastep per rank
and meets their answers on the first device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


class Mesh:
    """A (data, model) grid of ``torch.device``s. ``shape`` is a dict
    keyed by axis name, as a jax ``Mesh``'s is."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, model) grid of "
                             f"devices, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def make_debug_mesh(model: int = 1, *, devices=None) -> Mesh:
    """A ``data x model`` mesh over ``devices`` (default: every CUDA device
    torch sees; a CPU mesh is asked for by name, e.g.
    ``devices=[torch.device("cpu")] * 4``).

    When ``model`` does not divide the device count this falls back to the
    largest model-axis size that does and says so with a
    ``RuntimeWarning``, instead of a reshape error."""
    if model < 1:
        raise ValueError(f"make_debug_mesh: model axis must be >= 1, "
                         f"got model={model}")
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_debug_mesh: no CUDA device is available; pass "
                "devices=[torch.device('cpu')] * n for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_debug_mesh: no devices given")
    if n % model:
        fallback = max(m for m in range(1, model + 1) if n % m == 0)
        warnings.warn(
            f"make_debug_mesh: {n} device(s) cannot host a model axis of "
            f"{model} (not a divisor); falling back to model={fallback}. "
            f"Pass devices= with a multiple of {model} entries (a device "
            f"may repeat: each entry is a logical rank) to debug real "
            f"sharding.", RuntimeWarning, stacklevel=2)
        model = fallback
    grid = np.empty((n // model, model), dtype=object)
    for i, d in enumerate(devs):
        grid[i // model, i % model] = d
    return Mesh(grid)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes for this mesh (pod folds into data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, axes: tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size
