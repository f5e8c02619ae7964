"""Hopper CUDA kernel for the batched L2 distance, and its wrapper.

Port of ``repro/kernels/vector_distance.py``: squared L2 distances from a
(Q, D) f32 query batch to every vector of (N, T, D) bf16 pool blocks, the
compute half of the vector-search tenant's walk. The kernel is CUDA C++
for ``sm_90a`` in ``csrc/vector_distance.cu`` (the source says what
bounds it and how), built at first use and loaded with ``ctypes`` by
``kernels/_build.py``. Nothing is compiled or loaded when this module is
imported.

The wrapper takes CUDA tensors only: it checks device, dtype, rank,
contiguity and matching D and raises on anything else, allocates the
output with ``torch.empty``, launches on the current stream, raises if
the launch was refused, and adds one to ``LAUNCHES["l2_distance"]``. The
plain version is ``kernels/ref.py::l2_distance``; ``kernels/ops.py``
picks between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

SOURCE = _build.CSRC / "vector_distance.cu"

#: launches, counted where the kernel is launched and nowhere else
LAUNCHES = {"l2_distance": 0}

_lib = None


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
        lib.l2_distance_launch.argtypes = [vp] * 3 + [i32] * 5 + [vp]
        lib.l2_distance_launch.restype = i32
        lib.vector_distance_error_string.argtypes = [i32]
        lib.vector_distance_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def l2_distance(queries: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances: queries (Q, D) f32, blocks (N, T, D) bf16 ->
    (N, Q, T) f32, as ``|q|^2 + |b|^2 - 2 q.b`` in f32."""
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
        vec = int(D % 8 == 0 and queries.data_ptr() % 16 == 0
                  and blocks.data_ptr() % 16 == 0)
        rc = lib.l2_distance_launch(
            queries.data_ptr(), blocks.data_ptr(), out.data_ptr(), N, Q, T,
            D, vec, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(
                "l2_distance kernel launch failed: "
                f"{lib.vector_distance_error_string(rc).decode()}")
        LAUNCHES["l2_distance"] += 1
    return out
