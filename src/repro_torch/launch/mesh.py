"""Device meshes (port of ``repro/launch/mesh.py``): the ``data x model``
mesh of sharded serving (``make_debug_mesh``), the dry-run's production
meshes (``make_production_mesh``, ``abstract_mesh``), ``data_axes`` and
``axis_size``.

The production meshes are ``torch.distributed`` ``DeviceMesh``es on a
fake process group (``fake_world``: backend ``"fake"``, this process rank
0 of 512; collectives return at once and move nothing), the port's
counterpart of the reference's 512 placeholder host devices. A process
has one default group, so the group is made once with 512 ranks, and the
16 x 16 pod mesh is a sub-mesh over its first 256; a smaller mesh (a
test's (2, 2), the card's (1, 1)) is one over its first ranks. Only a
call creates the group, never an import.

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

# {axis name: size} of a Mesh, an AbstractMesh or a DeviceMesh (whose own
# ``shape`` is a tuple)
from repro_torch.models.runconfig import mesh_shape  # noqa: F401


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


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``Mesh``, an ``AbstractMesh`` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes for this mesh (pod folds into data)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def axis_size(mesh, axes: tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a]
    return size


class AbstractMesh:
    """A device-free mesh: axis sizes and names only, for resolving
    sharding specs with no process group at all."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """The reference's ``abstract_mesh``: a shape-only mesh."""
    return AbstractMesh(shape, axes)


#: ranks of the fake process group: the two-pod mesh's 2 x 16 x 16
FAKE_WORLD = 512


def fake_world(world: int = FAKE_WORLD) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process rank 0) unless one exists. Raises if an existing group is
    not fake or has fewer ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_backend() != "fake"
                or dist.get_world_size() < world):
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; the dry-run needs "
                f"a fake group of at least {world}")
        return
    # importing it registers the "fake" backend with c10d
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def device_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` named ``axes`` over the first prod(shape) ranks of
    the fake group (made if need be). Its tensors are fake CPU tensors:
    the device type only names the group's backend."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    fake_world(max(FAKE_WORLD, n))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 single pod (256 ranks) or 2 x 16 x 16 two-pod (512 ranks),
    a ``DeviceMesh`` on the fake group."""
    if multi_pod:
        return device_mesh((2, 16, 16), ("pod", "data", "model"))
    return device_mesh((16, 16), ("data", "model"))
