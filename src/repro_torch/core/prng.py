"""Threefry-2x32 counter-based random numbers in numpy, drawing the same
bits as the reference's ``jax.random`` (partitionable threefry, the
default since JAX 0.5).

A key is a ``(2,)`` uint32 array. ``key(seed)`` is ``PRNGKey(seed)``:
``[0, seed]`` (the high word of a 32-bit seed is 0).
``fold_in(k, d)`` hashes the counter ``(0, d)`` under ``k``. ``bits``
hashes the counters ``(hi, lo)`` of each element's flat index under the
key and returns ``out0 ^ out1``. ``uniform`` and ``normal`` follow
``jax.random.uniform`` and ``jax.random.normal`` for float32: the 23
high bits as the mantissa of a float in [1, 2), and for ``normal`` XLA's
float32 ``erf_inv`` polynomial (M. Giles, "Approximating the erfinv
function") over ``uniform(nextafter(-1, 0), 1)``, times sqrt(2).

``bits`` and ``uniform`` are bit-equal to ``jax.random``; ``normal`` is
within a few float32 ulps of it: its last bits depend on XLA's ``log1p``
and on whether XLA contracts a multiply and an add into an FMA.
"""

from __future__ import annotations

import numpy as np

u32 = np.uint32
f32 = np.float32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << u32(r)) | (v >> u32(32 - r))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block cipher of counters ``(x0, x1)``
    under the key ``k`` (JAX's ``threefry2x32_p``)."""
    k0, k1 = u32(k[0]), u32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0 = np.asarray(x0, u32).copy()
    x1 = np.asarray(x1, u32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=u32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    o0, o1 = threefry2x32(k, np.array([0], u32),
                          np.array([int(data) & 0xFFFFFFFF], u32))
    return np.array([o0[0], o1[0]], dtype=u32)


def bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` as uint32 (partitionable counters:
    the flat index split into high and low words)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    o0, o1 = threefry2x32(k, (idx >> np.uint64(32)).astype(u32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(u32))
    return (o0 ^ o1).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    b = bits(k, shape)
    fb = (b >> u32(32 - 23)) | np.array(1.0, f32).view(u32)
    floats = fb.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: a degree-8 polynomial in
    ``w = -log1p(-x*x)`` (shifted by 2.5 below 5, else ``sqrt(w) - 3``)."""
    x = np.asarray(x, f32)
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_W_LT5[0]), f32(_W_GE5[0]))
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = np.where(lt, f32(a), f32(b)) + p * w
    out = p * x
    return np.where(np.abs(x) == f32(1.0),
                    x * np.finfo(f32).max, out).astype(f32)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(k, shape)`` in float32 (see module docstring)."""
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = uniform(k, shape, lo, f32(1.0))
    return (f32(np.sqrt(2)) * erf_inv(u)).astype(f32)
