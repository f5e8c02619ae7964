"""Public entry points for the port's kernels.

Mirror of ``repro/kernels/ops.py``. Each dispatches on the device of the
tensors it is given: a CPU tensor goes to the plain version in
``kernels/ref.py``; any other tensor goes to the CUDA kernel in
``kernels/duplex_stream.py``, ``kernels/vector_distance.py``,
``kernels/flash_attention.py`` or ``kernels/rwkv6_scan.py``, which
launches or raises. There is no
fallback from the kernel to the plain version. ``wkv6`` is the one
kernel with a gradient: under autograd on a CUDA tensor it goes through
``WKV6Function``, whose backward is the CUDA ``wkv6_backward``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import duplex_stream as _ds
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rs
from repro_torch.kernels import vector_distance as _vd


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def duplex_kv_stream(in_q, in_scale, out_x, *, fused: bool = True,
                     stage_blocks: int = 1):
    """Fused duplex page-in/page-out transform.

    ``fused=False`` runs the phase-separated baseline: the two
    single-direction kernels back to back (identical math). ``N`` must be
    a multiple of ``stage_blocks``, the pool's staging depth (callers pad
    the streams with zero pages)."""
    N = in_q.shape[0]
    if N % stage_blocks:
        raise ValueError(
            f"duplex stream length {N} is not a multiple of the staging "
            f"depth {stage_blocks}; pad the streams")
    if _on_cpu(in_q):
        return ref.duplex_kv_stream(in_q, in_scale, out_x)
    if fused:
        return _ds.duplex_kv_stream(in_q, in_scale, out_x)
    in_deq = _ds.dequant_stream(in_q, in_scale)
    out_q, out_scale = _ds.quant_stream(out_x)
    return in_deq, out_q, out_scale


def dequant_kv_stream(in_q, in_scale):
    """Single-direction page-in transform (no page-out stream to fuse)."""
    if _on_cpu(in_q):
        return ref.dequantize_int8(in_q, in_scale)
    return _ds.dequant_stream(in_q, in_scale)


def quant_kv_stream(out_x):
    """Single-direction page-out transform (no page-in stream to fuse)."""
    if _on_cpu(out_x):
        return ref.quantize_int8(out_x)
    return _ds.quant_stream(out_x)


def l2_distance(queries, blocks):
    """Batched query-to-block squared L2 distances (vector-search tenant):
    queries (Q, D), blocks (N, T, D) bf16 -> (N, Q, T) f32."""
    if _on_cpu(queries):
        return ref.l2_distance(queries, blocks)
    return _vd.l2_distance(queries, blocks)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, prefix_len: int = 0,
                    q_block: int = 128, kv_block: int = 128):
    """Blockwise attention. q: (B, S, H, hd); k, v: (B, S, KV, hd) ->
    (B, S, H, hd). ``q_block``/``kv_block`` are the reference's
    divisibility contract, checked on every device so the CPU and the
    card refuse the same shapes; the CUDA kernel picks its own tiles."""
    S = q.shape[1]
    qb, kb = min(q_block, S), min(kv_block, S)
    if S % qb or S % kb:
        raise ValueError(f"S={S} must be divisible by blocks ({qb},{kb})")
    if _on_cpu(q):
        return ref.attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)


class WKV6Function(torch.autograd.Function):
    """``wkv6`` with its gradient: on a CUDA tensor the forward is the
    CUDA kernel and the backward the CUDA backward kernel
    (``rwkv6_scan.wkv6`` / ``wkv6_backward``); on the CPU their plain
    versions (``ref.wkv6`` / ``ref.wkv6_backward``). Saves r, k, v, w, u.
    Inputs f32 (B, S, H, hs) and u (H, hs), contiguous."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        if _on_cpu(r):
            return ref.wkv6(r, k, v, w, u)[0]
        return _rs.wkv6(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dout):
        r, k, v, w, u = ctx.saved_tensors
        dout = dout.float().contiguous()
        if _on_cpu(r):
            return ref.wkv6_backward(r, k, v, w, u, dout)
        return _rs.wkv6_backward(r, k, v, w, u, dout)


def wkv6(r, k, v, w, u, *, chunk: int = 128):
    """The WKV6 recurrence from a zero state. r, k, v, w: (B, S, H, hs)
    (w in (0, 1)); u: (H, hs) -> out (B, S, H, hs) f32. ``chunk`` is the
    reference's divisibility contract (``S % min(chunk, S) == 0``),
    checked on every device; the CUDA kernel has no such limit and walks
    time in its own chunks. Inputs are taken in f32, as the reference's
    kernel upcasts them.

    On a CUDA tensor that autograd records (grad mode on, an input that
    requires grad) the call goes through ``WKV6Function``, whose backward
    is the CUDA backward kernel; otherwise straight to the kernel, and
    nothing is saved. On the CPU the plain loop, which autograd
    differentiates itself."""
    S = r.shape[1]
    ch = min(chunk, S)
    if S % ch:
        raise ValueError(f"S={S} must be divisible by chunk={ch}")
    r, k, v, w, u = (t.float().contiguous() for t in (r, k, v, w, u))
    if _on_cpu(r):
        return ref.wkv6(r, k, v, w, u)[0]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return WKV6Function.apply(r, k, v, w, u)
    return _rs.wkv6(r, k, v, w, u)
