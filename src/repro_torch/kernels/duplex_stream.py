"""Hopper CUDA kernels for the duplex KV stream, and their wrappers.

Port of ``repro/kernels/duplex_stream.py``: the fused page-in dequantize /
page-out quantize pass (``duplex_kv_stream``) and its two
single-direction halves (``quant_stream``, ``dequant_stream``). The
kernels are CUDA C++ for ``sm_90a`` in ``csrc/duplex_stream.cu`` (the
source says what bounds them and how). They are compiled with ``nvcc``
at first use into ``build/kernels/`` at the repository root, into a
shared library with a plain C interface, and loaded with ``ctypes``.
Nothing is compiled or loaded when this module is imported.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
``torch.empty``, launches on the current stream, raises if the launch was
refused, and adds one to its entry in ``LAUNCHES``. The plain versions
live in ``kernels/ref.py``; ``kernels/ops.py`` picks between the two by
the tensor's device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "duplex_stream.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per wrapper, counted where the kernel is launched and nowhere
#: else (``chip_smoke.py`` reads these to show the serving path ran the
#: kernels).
LAUNCHES = {"duplex_kv_stream": 0, "quant_stream": 0, "dequant_stream": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return nvcc


def library_path() -> Path:
    """Build output, keyed by the source and flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libduplex_stream_{key}.so"


def build() -> str:
    """Compile the kernels unless the library for this source exists.
    Returns nvcc's log (register and shared-memory use per kernel), or ""
    when nothing was built."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(SOURCE)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return res.stderr + res.stdout


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.duplex_kv_stream_launch.argtypes = [vp] * 6 + [ll, i32, vp]
        lib.quant_stream_launch.argtypes = [vp] * 3 + [ll, i32, vp]
        lib.dequant_stream_launch.argtypes = [vp] * 3 + [ll, i32, vp]
        for fn in (lib.duplex_kv_stream_launch, lib.quant_stream_launch,
                   lib.dequant_stream_launch):
            fn.restype = i32
        lib.duplex_stream_error_string.argtypes = [i32]
        lib.duplex_stream_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
                out_scale.data_ptr(), N * T, D)
    return in_deq, out_q, out_scale


def quant_stream(out_x: torch.Tensor):
    """Page-out half: (N,T,D) bf16 -> (N,T,D) int8, (N,T,1) f32 scales."""
    N, T, D = _blocks(out_x, "out_x")
    dev = out_x.device
    _check(out_x, "out_x", torch.bfloat16, (N, T, D))
    lib = _load()
    with torch.cuda.device(dev):
        out_q = torch.empty((N, T, D), dtype=torch.int8, device=dev)
        out_scale = torch.empty((N, T, 1), dtype=torch.float32, device=dev)
        _launch(lib, lib.quant_stream_launch, "quant_stream", N * T,
                out_x.data_ptr(), out_q.data_ptr(), out_scale.data_ptr(),
                N * T, D)
    return out_q, out_scale


def dequant_stream(in_q: torch.Tensor, in_scale: torch.Tensor):
    """Page-in half: (N,T,D) int8 x (N,T,1) f32 -> (N,T,D) bf16."""
    N, T, D = _blocks(in_q, "in_q")
    dev = in_q.device
    _check(in_q, "in_q", torch.int8, (N, T, D))
    _check(in_scale, "in_scale", torch.float32, (N, T, 1), dev)
    lib = _load()
    with torch.cuda.device(dev):
        in_deq = torch.empty((N, T, D), dtype=torch.bfloat16, device=dev)
        _launch(lib, lib.dequant_stream_launch, "dequant_stream", N * T,
                in_q.data_ptr(), in_scale.data_ptr(), in_deq.data_ptr(),
                N * T, D)
    return in_deq
