"""Build and load the port's CUDA kernel libraries.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``build/kernels/`` at the repository root, and loaded with
``ctypes``. A library's file name carries a hash of its source and the
flags, so an edited source builds anew and two sources never share a
library. Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return nvcc


def library_path(source: Path) -> Path:
    """Build output of ``source``, keyed by its bytes and the flags."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{key}.so"


def build(source: Path) -> str:
    """Compile ``source`` unless its library exists. Returns nvcc's log
    (register and shared-memory use per kernel), or "" when nothing was
    built."""
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(source)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return res.stderr + res.stdout


def load(source: Path) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))


def check_tensor(t, name: str, dtype, shape: tuple, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (on ``device`` when given): what a kernel wrapper checks
    before it hands a pointer to a launch."""
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


def check_no_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``name`` on
    ``tensors``: a ctypes kernel fills its outputs outside autograd, so
    a gradient through it would be lost without a word. ``wkv6`` is
    differentiated through its ``torch.autograd.Function``
    (``kernels/ops.py``); the other kernels have no backward, in the
    reference or here."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: called with grad mode on and an input "
            f"that requires grad (run it under torch.no_grad(), or through "
            f"its autograd Function where it has one)")
