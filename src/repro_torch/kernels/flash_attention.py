"""Hopper CUDA kernels for blockwise (flash) attention, and their wrapper.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``, the
``pl.pallas_call`` at :123, kernel body ``_flash_kernel`` at :31): the
attention of ``layers.attn_apply(use_kernel=True)`` on the full-sequence
forward (prefill, loss evaluation). The kernels are CUDA C++ for
``sm_90a`` in ``csrc/flash_attention.cu``, built at first use and
loaded with ``ctypes`` by ``kernels/_build.py``. Nothing is compiled or
loaded when this module is imported.

What bounds it on an H100, and what the design does about it: the work
is visible (query, key) pairs times 4*hd FLOP, far more than the bytes
(q, k, v and o once), so it is compute-bound, against 989 TFLOP/s bf16
on tensor cores. For bf16 inputs (the model's path) both products run
on tensor cores (``mma.sync.m16n8k16``, bf16 in, f32 accumulate):
QK^T on the bf16 inputs, whose products are exact in f32, and P.V with
P rounded to bf16, the precision of the reference model's own plain
attention; m, l and the accumulator stay f32. One 128-thread block
(four warps of 16 q rows) per (64-row q tile, head, batch), the longest
causal tiles launched first; K and V tiles stream through a two-stage
``cp.async`` ring in swizzled shared memory, read with ``ldmatrix``;
only kv tiles holding a visible pair are visited, and only tiles on a
mask edge are masked element by element. For f32 inputs the kernel
keeps a CUDA-core body, all in f32 (P too): the reference's f32
tolerance, 2e-5, is beyond bf16 and TF32 tensor cores.

It computes the reference model's mask (``layers._mask_bias``), not the
Pallas kernel's: prefix keys are visible to every query under ``causal``
whatever q tile it sits in, and the window does not exempt them.

The wrapper raises when autograd would record it (no backward, in the
reference or here: training runs the plain attention). It takes CUDA
tensors only: it checks device, dtype, rank,
shapes, contiguity, 16-byte alignment and ``hd`` in ``HEAD_DIMS`` and
raises on anything else, allocates the output with ``torch.empty``,
launches on the current stream (one kernel per call), raises if the
launch was refused, and adds one to ``LAUNCHES["flash_attention"]``. The
plain version is ``kernels/ref.py::attention``; ``kernels/ops.py`` picks
between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.kernels._build import check_no_grad as _no_grad

SOURCE = _build.CSRC / "flash_attention.cu"

#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 80, 112, 128, 256)

#: launches, counted where the kernel is launched and nowhere else
LAUNCHES = {"flash_attention": 0}

_lib = None


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


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
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [vp])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, S, KV, hd), bf16 or f32, contiguous
    -> (B, S, H, hd) in q's dtype. ``window`` None means no window."""
    _no_grad("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q (B, S, H, hd) and k, v (B, S, KV, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dev = q.device
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    _check(q, "q", q.dtype, (B, S, H, hd))
    _check(k, "k", q.dtype, (B, S, KV, hd), dev)
    _check(v, "v", q.dtype, (B, S, KV, hd), dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if KV < 1 or H % KV or H > 65535 or B > 65535:
        raise ValueError(f"unsupported heads H={H}, KV={KV} or batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernel reads 16 bytes at a time)")
    lib = _load()
    with torch.cuda.device(dev):
        out = torch.empty_like(q)
        if q.numel() == 0:
            return out
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, KV, hd, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd),
            int(causal), 0 if window is None else window, prefix_len,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(
                "flash_attention kernel launch failed: "
                f"{lib.flash_attention_error_string(rc).decode()}")
        LAUNCHES["flash_attention"] += 1
    return out
