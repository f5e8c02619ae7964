"""Hopper CUDA kernel for the batched L2 distance, and its wrapper.

Port of ``repro/kernels/vector_distance.py``: squared L2 distances from a
(Q, D) f32 query batch to every vector of (N, T, D) bf16 pool blocks, the
compute half of the vector-search tenant's walk. The kernel is CUDA C++
for ``sm_90a`` in ``csrc/vector_distance.cu`` (the source says what
bounds it and how), built at first use and loaded with ``ctypes`` by
``kernels/_build.py``. Nothing is compiled or loaded when this module is
imported.

The wrapper raises when autograd would record it (no backward, in the
reference or here). It takes CUDA tensors only: it checks device,
dtype, rank,
contiguity and matching D and raises on anything else, allocates the
output with ``torch.empty``, picks the launch geometry (``geometry``: how
D and the rows are cut across blocks), launches on the current stream,
raises if the launch was refused, and adds one to
``LAUNCHES["l2_distance"]``. The plain version is
``kernels/ref.py::l2_distance``; ``kernels/ops.py`` picks between the two
by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.kernels._build import check_no_grad as _no_grad

SOURCE = _build.CSRC / "vector_distance.cu"

#: launches, counted where the kernel is launched and nowhere else
LAUNCHES = {"l2_distance": 0}

#: threads a block (``kThreads`` in the source)
THREADS = 256
#: queries a pass over the rows (``kQChunk``)
Q_CHUNK = 8
#: pool rows a block, at most (the kernel is instantiated for 1, 2 and 4)
MAX_ROWS = 4
#: slices of D, at most: one portable thread-block cluster
MAX_CLUSTER = 8
#: units of D a slice keeps at least, so a short D is not cut
MIN_SLICE_UNITS = 64
#: blocks a launch aims for: about one on each of 132 SMs
TARGET_BLOCKS = 128
#: elements of a unit on the 16-byte path
VEC_UNIT = 8

_lib = None


def geometry(Q: int, N: int, T: int, D: int, aligned: bool = True) -> dict:
    """How the kernel cuts its work: ``vec`` (8-element units, where
    ``D % 8 == 0`` and the pointers are 16-byte ``aligned``; else one
    element), ``rows_per_cta`` (1, 2 or 4: the most that still leave
    TARGET_BLOCKS blocks; each staged query byte serves them all),
    ``cluster`` (slices of D, one block each, a power of two: the fewest
    that reach TARGET_BLOCKS blocks, up to MAX_CLUSTER while each slice
    keeps MIN_SLICE_UNITS units),
    ``slice_units``, ``tile_units`` (units a block takes per step, at
    most one a thread), ``blocks`` and ``smem_bytes`` (a tile of up to
    Q_CHUNK queries and, on the 16-byte path, of the block's rows; two
    tiles where a slice takes more than one)."""
    vec = aligned and D % VEC_UNIT == 0
    unit = VEC_UNIT if vec else 1
    units = D // unit
    rows = N * T
    max_cluster = 1
    while (2 * max_cluster <= MAX_CLUSTER
           and units // (2 * max_cluster) >= MIN_SLICE_UNITS):
        max_cluster *= 2
    rows_per_cta = 1
    while (2 * rows_per_cta <= MAX_ROWS and -(-rows // (2 * rows_per_cta))
           * max_cluster >= TARGET_BLOCKS):
        rows_per_cta *= 2
    groups = -(-rows // rows_per_cta)
    cluster = 1
    while cluster < max_cluster and groups * cluster < TARGET_BLOCKS:
        cluster *= 2
    slice_units = -(-units // cluster)
    tile_units = min(slice_units, THREADS)
    return {"vec": vec, "unit": unit, "units": units, "cluster": cluster,
            "slice_units": slice_units, "tile_units": tile_units,
            "rows_per_cta": rows_per_cta,
            "blocks": groups * cluster,
            "smem_bytes": (1 if tile_units == slice_units else 2)
            * (min(Q, Q_CHUNK) * tile_units * unit * 4
               + (rows_per_cta * tile_units * 16 if vec else 0))}


def reset_launches() -> None:
    LAUNCHES["l2_distance"] = 0


def library_path():
    return _build.library_path(SOURCE)


def build() -> str:
    """Compile this module's kernel unless built; returns nvcc's log."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.l2_distance_launch.argtypes = [vp] * 3 + [i32] * 10 + [vp]
        lib.l2_distance_launch.restype = i32
        lib.vector_distance_error_string.argtypes = [i32]
        lib.vector_distance_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def l2_distance(queries: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances: queries (Q, D) f32, blocks (N, T, D) bf16 ->
    (N, Q, T) f32, as ``|q|^2 + |b|^2 - 2 q.b`` in f32."""
    _no_grad("l2_distance", queries, blocks)
    if queries.dim() != 2 or blocks.dim() != 3:
        raise ValueError(f"want queries (Q, D) and blocks (N, T, D), got "
                         f"{tuple(queries.shape)} and {tuple(blocks.shape)}")
    Q, D = queries.shape
    N, T, _ = blocks.shape
    dev = queries.device
    _check(queries, "queries", torch.float32, (Q, D))
    _check(blocks, "blocks", torch.bfloat16, (N, T, D), dev)
    if Q < 1 or D < 1 or N * T >= 2 ** 31 or Q >= 2 ** 31 \
            or D >= 2 ** 31:
        raise ValueError(f"unsupported shapes {(Q, D)} and {(N, T, D)}")
    lib = _load()
    with torch.cuda.device(dev):
        out = torch.empty((N, Q, T), dtype=torch.float32, device=dev)
        if N == 0 or T == 0:
            return out
        g = geometry(Q, N, T, D, queries.data_ptr() % 16 == 0
                     and blocks.data_ptr() % 16 == 0)
        rc = lib.l2_distance_launch(
            queries.data_ptr(), blocks.data_ptr(), out.data_ptr(), N, Q, T,
            D, int(g["vec"]), g["cluster"], g["rows_per_cta"],
            g["slice_units"], g["tile_units"], g["smem_bytes"],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(
                "l2_distance kernel launch failed: "
                f"{lib.vector_distance_error_string(rc).decode()}")
        LAUNCHES["l2_distance"] += 1
    return out
