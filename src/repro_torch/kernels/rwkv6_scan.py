"""Hopper CUDA kernels for the WKV6 recurrence and its gradient, and
their wrappers.

Port of ``repro/kernels/rwkv6_scan.py`` (``wkv6``, the ``pl.pallas_call``
at :70, kernel body ``_wkv_kernel`` at :26): the time-mix recurrence of
every RWKV6 layer on the full-sequence forward (prefill, loss
evaluation), which ``models/rwkv6.forward`` runs through
``kernels.ops.wkv6`` once per layer. The kernel is CUDA C++ for
``sm_90a`` in ``csrc/rwkv6_scan.cu``, built at first use and loaded with
``ctypes`` by ``kernels/_build.py``. Nothing is compiled or loaded when
this module is imported.

What bounds it on an H100, and what the design does about it: the bytes
(r, k, v, w read once, out written once: 0.20 ms at the rwkv6-7b prefill
shape) and the f32 operations (5*hs^2 per (b, t, h): 0.16 ms) are both
small; the sequential loop over time sets the pace, each step costing
the instructions it issues on one SM. The TPU kernel's (B*H, S/chunk)
grid with a VMEM carry does not carry over: blocks run in parallel on
Hopper and nothing passes between them. Instead one thread block per
(b, h) keeps the whole (hs x hs) f32 state in registers and loops over
time, each thread a block of 4 rows x 4 columns (columns evolve
independently; the row groups' partial output sums meet in shared
memory). The output is taken in the factored form sum_i r_i S_ij +
v_j (sum_i r_i u_i k_i): the bonus dot is summed once per step while a
chunk is staged, so a state element costs four FP instructions a step
instead of six, and each 4-byte broadcast read of r, k and w serves four
columns. A chunk of r, k, w and v is staged in shared memory while the
next one loads, and the chunk's outputs leave 16 bytes a thread. The
state update rounds exactly as the plain version does, so the state is
bit-equal to it; only the output's sums differ in order.

The backward (``wkv6_backward``, the gradient of the recurrence; no TPU
kernel has one: the reference trains through its plain scan) is a
second kernel in the same source, one launch a call: one thread block
per (b, h) walks time forward, recomputing the state alone and keeping
it every ``BWD_SEG`` steps (the one global scratch), then walks the
segments newest first: each is walked forward once with its state kept
every ``BWD_SUB`` steps in shared memory, then sub-chunk by sub-chunk,
newest first, the sub-chunk's states are recomputed into registers and
walked back carrying dL/dS, emitting dr, dk, dv, dw and a per-(b, h)
partial of du that the wrapper sums over b (design and bound in
``csrc/rwkv6_scan.cu``; ``backward_geometry`` mirrors its shape).
``kernels/ops.py`` wraps the pair in a ``torch.autograd.Function``.

The wrappers take CUDA tensors only: they check device, dtype, rank,
shapes, contiguity, 16-byte alignment and ``hs`` in {16, 32, 64, 128}
and raise on anything else, allocate outputs and scratch with
``torch.empty``, launch on the current stream, raise if the launch was
refused, and add one to ``LAUNCHES["wkv6"]`` or
``LAUNCHES["wkv6_backward"]``. ``wkv6`` also raises when autograd would
record it (grad mode on, an input that requires grad): its gradient
comes only through the ``Function``. The plain versions are
``kernels/ref.py::wkv6`` and ``::wkv6_backward``; ``kernels/ops.py``
picks between kernel and plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_no_grad as _no_grad
from repro_torch.kernels._build import check_tensor as _check

SOURCE = _build.CSRC / "rwkv6_scan.cu"

#: head sizes the kernel is instantiated for
HEAD_SIZES = (16, 32, 64, 128)

#: launches, counted where the kernel is launched and nowhere else
LAUNCHES = {"wkv6": 0, "wkv6_backward": 0}

#: steps between the states the backward keeps in global memory (a
#: segment, its kernel's kSeg), and in shared memory (a sub-chunk, kT)
BWD_SEG = 64
BWD_SUB = 8

#: shared memory a block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448

_lib = None


def reset_launches() -> None:
    LAUNCHES["wkv6"] = 0
    LAUNCHES["wkv6_backward"] = 0


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
        lib.wkv6_launch.argtypes = [vp] * 6 + [i32] * 4 + [vp]
        lib.wkv6_launch.restype = i32
        lib.wkv6_backward_launch.argtypes = [vp] * 12 + [i32] * 4 + [vp]
        lib.wkv6_backward_launch.restype = i32
        lib.wkv6_backward_geometry.argtypes = [i32, vp]
        lib.wkv6_backward_geometry.restype = i32
        lib.rwkv6_scan_error_string.argtypes = [i32]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def backward_geometry(hs: int, batch: int = 1, seq: int = BWD_SEG,
                      heads: int = 1) -> dict:
    """The backward kernel's shape at head size ``hs`` (its ``BwdShape``):
    threads a block, rows x columns of the state a thread, the sub-chunk
    ``sub`` and segment ``seg`` in steps, the slices of ``slice_rows``
    rows a block walks in turn (hs 128: four of 32), the input ring's
    stages, the shared memory of a block in bytes (the slots, the ring,
    the column partials and the row sums), and the checkpoint scratch
    the wrapper allocates for (batch, seq, heads), in floats."""
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} is not one the kernel is built for "
                         f"{HEAD_SIZES}")
    slice_rows = 32 if hs == 128 else hs
    rows, cols = 4, 2 if hs == 16 else 4
    threads = (slice_rows // rows) * (hs // cols)
    seg, sub, stages = BWD_SEG, BWD_SUB, 3 if hs == 128 else 6
    floats = ((seg // sub) * slice_rows * hs + stages * 5 * sub * hs
              + (slice_rows // rows) * sub * hs + 3 * sub * slice_rows)
    segments = -(-seq // seg)
    return {"threads": threads, "rows": rows, "cols": cols, "sub": sub,
            "seg": seg, "slices": hs // slice_rows, "slice_rows": slice_rows,
            "stages": stages, "smem_bytes": 4 * floats,
            "scratch_floats": batch * heads * (segments - 1) * slice_rows * hs}


def _backward_scratch(B: int, S: int, H: int, hs: int, device):
    """The checkpoint scratch of one backward call (at least one float)."""
    n = backward_geometry(hs, B, S, H)["scratch_floats"]
    return torch.empty((max(n, 1),), dtype=torch.float32, device=device)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w (B, S, H, hs) f32 (w in (0, 1)), u (H, hs) f32, all
    contiguous -> out (B, S, H, hs) f32, the WKV6 recurrence from a zero
    state."""
    _no_grad("wkv6", r, k, v, w, u)
    B, S, H, hs = _check_inputs(r, k, v, w, u)
    dev = r.device
    lib = _load()
    with torch.cuda.device(dev):
        out = torch.empty_like(r)
        if r.numel() == 0:
            return out
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), B, S, H, hs,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(
                "wkv6 kernel launch failed: "
                f"{lib.rwkv6_scan_error_string(rc).decode()}")
        LAUNCHES["wkv6"] += 1
    return out


def _check_inputs(r, k, v, w, u, *more) -> tuple:
    """(B, S, H, hs) after the checks both kernels make; ``more`` are
    further (name, tensor) pairs of r's shape."""
    if r.dim() != 4 or u.dim() != 2:
        raise ValueError(f"want r, k, v, w (B, S, H, hs) and u (H, hs), got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    B, S, H, hs = r.shape
    dev = r.device
    _check(r, "r", torch.float32, (B, S, H, hs))
    pairs = (("k", k), ("v", v), ("w", w)) + more
    for name, t in pairs:
        _check(t, name, torch.float32, (B, S, H, hs), dev)
    _check(u, "u", torch.float32, (H, hs), dev)
    if hs not in HEAD_SIZES:
        raise ValueError(f"head size {hs} is not one the kernel is built for "
                         f"{HEAD_SIZES}")
    if B * H >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"unsupported shape {(B, S, H, hs)}")
    if any(t.data_ptr() % 16 for t in (r, *(t for _, t in pairs))):
        raise ValueError("r, k, v, w (and dout) must start on a 16-byte "
                         "boundary (the kernels read 16 bytes at a time)")
    return B, S, H, hs


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor):
    """The gradient of ``wkv6(r, k, v, w, u)`` against ``dout`` (B, S, H,
    hs) f32: (dr, dk, dv, dw (B, S, H, hs), du (H, hs)), f32. One launch;
    du is the kernel's per-(b, h) partial summed over b here."""
    B, S, H, hs = _check_inputs(r, k, v, w, u, ("dout", dout))
    dev = r.device
    lib = _load()
    with torch.cuda.device(dev):
        grads = [torch.empty_like(r) for _ in range(4)]
        du_part = torch.empty((B, H, hs), dtype=torch.float32, device=dev)
        if r.numel() == 0:
            return (*grads, du_part.sum(0))
        kept = _backward_scratch(B, S, H, hs, dev)
        rc = lib.wkv6_backward_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dout.data_ptr(),
            *(t.data_ptr() for t in grads), du_part.data_ptr(),
            kept.data_ptr(), B, S, H, hs,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(
                "wkv6_backward kernel launch failed: "
                f"{lib.rwkv6_scan_error_string(rc).decode()}")
        LAUNCHES["wkv6_backward"] += 1
    return (*grads, du_part.sum(0))
