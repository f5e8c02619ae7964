"""Plain PyTorch versions of the port's kernels.

Mirror of ``repro/kernels/ref.py``. The CPU
path of ``kernels.ops`` runs these, the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernels against them on
the card. Nothing on the serving or forward path calls them for a CUDA
tensor.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as nn
from repro_torch.models.rwkv6 import wkv_scan


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              prefix_len: int = 0):
    """Dense reference attention (one q block over all of kv).
    q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd) in v's dtype."""
    spec = nn.AttnSpec(num_heads=q.shape[2], num_kv_heads=k.shape[2],
                       head_dim=q.shape[3], causal=causal, window=window,
                       prefix_len=prefix_len, q_block=q.shape[1])
    return nn.attention(q, k, v, spec)


def wkv6(r, k, v, w, u, state=None):
    """Plain WKV6 recurrence, a loop over time in f32 (delegates to the
    model's scan, as the reference does). r, k, v, w (B, S, H, hs), u
    (H, hs); returns (out (B, S, H, hs), final state (B, H, hs, hs))."""
    return wkv_scan(r, k, v, w, u, state)


def quantize_int8(x: torch.Tensor):
    """Per-row symmetric int8 quantization. x: (..., T, D) -> (q, scale)
    with scale = max(amax, 1e-8) / 127, a true divide, round half to
    even (``torch.round``), clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not a Python scalar: PyTorch's CUDA path turns
    # ``t / 127.0`` into ``t * (1 / 127.0)``, which is not the IEEE divide.
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def duplex_kv_stream(in_q, in_scale, out_x):
    """The fused duplex page-in/page-out transform: dequantize
    ``(in_q, in_scale)`` to bf16 and quantize ``out_x`` to (int8, scale)."""
    in_deq = dequantize_int8(in_q, in_scale)
    out_q, out_scale = quantize_int8(out_x)
    return in_deq, out_q, out_scale


def l2_distance(queries: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, the direct sum of squared differences in f32.
    queries (Q, D), blocks (N, T, D) -> (N, Q, T) f32."""
    q = queries.float()
    b = blocks.float()
    diff = q[None, :, None, :] - b[:, None, :, :]
    return (diff * diff).sum(dim=-1)
