"""Hopper CUDA kernels for the duplex KV stream, and their wrappers.

Port of ``repro/kernels/duplex_stream.py``: the fused page-in dequantize /
page-out quantize pass (``duplex_kv_stream``) and its two
single-direction halves (``quant_stream``, ``dequant_stream``). The
kernels are CUDA C++ for ``sm_90a`` in ``csrc/duplex_stream.cu`` (the
source says what bounds them and how), built at first use into a shared
library with a plain C interface and loaded with ``ctypes`` by
``kernels/_build.py``. Nothing is compiled or loaded when this module is
imported.

Each wrapper raises when autograd would record it (the kernels have no
backward, in the reference or here). It takes CUDA tensors only: it
checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
``torch.empty``, picks the launch geometry (``geometry``: 16-byte or
element accesses, blocks a row), launches on the current stream, raises if the launch
was refused, and adds one to its entry in ``LAUNCHES``. The plain
versions live in ``kernels/ref.py``; ``kernels/ops.py`` picks between the
two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.kernels._build import check_no_grad as _no_grad

SOURCE = _build.CSRC / "duplex_stream.cu"

#: launches per wrapper, counted where the kernel is launched and nowhere
#: else (``chip_smoke.py`` reads these to show the serving path ran the
#: kernels).
LAUNCHES = {"duplex_kv_stream": 0, "quant_stream": 0, "dequant_stream": 0}

#: threads a block (``kThreads`` in the source)
THREADS = 512
#: elements of a unit on the 16-byte path (one int8 access, two bf16 ones)
VEC_UNIT = 16
#: blocks a row and direction, at most
MAX_PARTS = 4
#: blocks a launch may hold to still run in one wave: two of THREADS on
#: each of 132 SMs
WAVE_BLOCKS = 264

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path():
    return _build.library_path(SOURCE)


def build() -> str:
    """Compile this module's kernels unless built; returns nvcc's log."""
    return _build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.duplex_kv_stream_launch.argtypes = [vp] * 6 + [ll] + [i32] * 3 \
            + [vp]
        lib.quant_stream_launch.argtypes = [vp] * 3 + [ll] + [i32] * 3 + [vp]
        lib.dequant_stream_launch.argtypes = [vp] * 3 + [ll] + [i32] * 3 \
            + [vp]
        for fn in (lib.duplex_kv_stream_launch, lib.quant_stream_launch,
                   lib.dequant_stream_launch):
            fn.restype = i32
        lib.duplex_stream_error_string.argtypes = [i32]
        lib.duplex_stream_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def geometry(rows: int, d: int, directions: int, aligned: bool = True
             ) -> dict:
    """How a launch takes its rows: ``vec`` (16-element units with 16-byte
    accesses, where ``d % 16 == 0`` and the pointers are 16-byte
    ``aligned``; else one element at a time), ``parts`` (blocks a row and
    direction: on the 16-byte path 1, 2 or 4, the most that keep the
    launch within WAVE_BLOCKS, a page-out part reading its whole row for
    the amax and quantizing its share; 1 on the element path) and
    ``blocks`` (``rows * directions * parts``; ``directions`` is 2 for the
    fused pass)."""
    vec = aligned and d % VEC_UNIT == 0
    parts = 1
    while (vec and 2 * parts <= MAX_PARTS
           and rows * directions * 2 * parts <= WAVE_BLOCKS):
        parts *= 2
    return {"vec": vec, "parts": parts, "blocks": rows * directions * parts}


def _args(rows, d, directions, tensors) -> tuple[int, int]:
    """(vec, parts) of ``geometry`` for a launch on ``tensors``."""
    g = geometry(rows, d, directions,
                 all(t.data_ptr() % 16 == 0 for t in tensors))
    return int(g["vec"]), g["parts"]


def _blocks(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    if t.dim() != 3:
        raise ValueError(f"{name} must be (N, T, D), got {tuple(t.shape)}")
    N, T, D = t.shape
    if D < 1 or N * T >= 2 ** 30:
        raise ValueError(f"{name}: unsupported shape {tuple(t.shape)}")
    return N, T, D


def _launch(lib, fn, name: str, rows: int, *args) -> None:
    if rows == 0:
        return
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.duplex_stream_error_string(rc).decode()}")
    LAUNCHES[name] += 1


def duplex_kv_stream(in_q: torch.Tensor, in_scale: torch.Tensor,
                     out_x: torch.Tensor):
    """Fused page-in dequantize + page-out quantize, one launch.
    in_q (N,T,D) int8, in_scale (N,T,1) f32, out_x (N,T,D) bf16 ->
    (in_deq (N,T,D) bf16, out_q (N,T,D) int8, out_scale (N,T,1) f32)."""
    _no_grad("duplex_kv_stream", in_q, in_scale, out_x)
    N, T, D = _blocks(in_q, "in_q")
    dev = in_q.device
    _check(in_q, "in_q", torch.int8, (N, T, D))
    _check(in_scale, "in_scale", torch.float32, (N, T, 1), dev)
    _check(out_x, "out_x", torch.bfloat16, (N, T, D), dev)
    lib = _load()
    with torch.cuda.device(dev):
        in_deq = torch.empty((N, T, D), dtype=torch.bfloat16, device=dev)
        out_q = torch.empty((N, T, D), dtype=torch.int8, device=dev)
        out_scale = torch.empty((N, T, 1), dtype=torch.float32, device=dev)
        _launch(lib, lib.duplex_kv_stream_launch, "duplex_kv_stream",
                N * T, in_q.data_ptr(), in_scale.data_ptr(),
                out_x.data_ptr(), in_deq.data_ptr(), out_q.data_ptr(),
                out_scale.data_ptr(), N * T, D,
                *_args(N * T, D, 2, (in_q, out_x, in_deq, out_q)))
    return in_deq, out_q, out_scale


def quant_stream(out_x: torch.Tensor):
    """Page-out half: (N,T,D) bf16 -> (N,T,D) int8, (N,T,1) f32 scales."""
    _no_grad("quant_stream", out_x)
    N, T, D = _blocks(out_x, "out_x")
    dev = out_x.device
    _check(out_x, "out_x", torch.bfloat16, (N, T, D))
    lib = _load()
    with torch.cuda.device(dev):
        out_q = torch.empty((N, T, D), dtype=torch.int8, device=dev)
        out_scale = torch.empty((N, T, 1), dtype=torch.float32, device=dev)
        _launch(lib, lib.quant_stream_launch, "quant_stream", N * T,
                out_x.data_ptr(), out_q.data_ptr(), out_scale.data_ptr(),
                N * T, D, *_args(N * T, D, 1, (out_x, out_q)))
    return out_q, out_scale


def dequant_stream(in_q: torch.Tensor, in_scale: torch.Tensor):
    """Page-in half: (N,T,D) int8 x (N,T,1) f32 -> (N,T,D) bf16."""
    _no_grad("dequant_stream", in_q, in_scale)
    N, T, D = _blocks(in_q, "in_q")
    dev = in_q.device
    _check(in_q, "in_q", torch.int8, (N, T, D))
    _check(in_scale, "in_scale", torch.float32, (N, T, 1), dev)
    lib = _load()
    with torch.cuda.device(dev):
        in_deq = torch.empty((N, T, D), dtype=torch.bfloat16, device=dev)
        _launch(lib, lib.dequant_stream_launch, "dequant_stream", N * T,
                in_q.data_ptr(), in_scale.data_ptr(), in_deq.data_ptr(),
                N * T, D, *_args(N * T, D, 1, (in_q, in_deq)))
    return in_deq
