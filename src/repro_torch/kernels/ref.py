"""Plain PyTorch versions of the port's kernels.

Mirror of ``repro/kernels/ref.py``. The CPU
path of ``kernels.ops`` runs these, the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernels against them on
the card. Nothing on the serving or forward path calls them for a CUDA
tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan import BWD_SEG, BWD_SUB
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


def wkv6_backward(r, k, v, w, u, dout, seg: int = BWD_SEG,
                  sub: int = BWD_SUB):
    """The gradient of ``wkv6``'s output (from a zero state) against
    ``dout``: (dr, dk, dv, dw (B, S, H, hs), du (H, hs)), in f32, by the
    algorithm of the CUDA backward (``csrc/rwkv6_scan.cu``). With S_t the
    state after step t and G_t = dL/dS_t (G_{S-1} = 0,
    G_{t-1} = w_t * G_t + r_t dout_t^T):

      dr_t[i] = sum_j dout_t[j] (S_{t-1}[i, j] + u_i k_t[i] v_t[j])
      dk_t[i] = sum_j G_t[i, j] v_t[j] + u_i r_t[i] (v_t . dout_t)
      dv_t[j] = sum_i G_t[i, j] k_t[i] + dout_t[j] sum_i r_t[i] u_i k_t[i]
      dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
      du[i]   = sum_{b, t} r_t[i] k_t[i] (v_t . dout_t)

    A first loop forward in time keeps the state at the start of every
    segment of ``seg`` steps, and nothing else; a second walks the
    segments newest first: each is walked forward once from its kept
    state, keeping the state at the start of every sub-chunk of ``sub``
    steps, then sub-chunk by sub-chunk, newest first, the sub-chunk's
    states are recomputed from its kept one and walked back carrying G,
    emitting dr, dk, dv, dw and du (never S_{t-1} from S_t by dividing by
    w_t, which reaches 0). du is summed per (b, h), then over b. The
    defaults are the kernel's (``rwkv6_scan.BWD_SEG``, ``BWD_SUB``);
    ``seg`` must be a multiple of ``sub``. Computed in f32 (f64 inputs
    stay f64, for ``gradcheck``)."""
    if sub < 1 or seg < sub or seg % sub:
        raise ValueError(f"seg={seg} must be a positive multiple of "
                         f"sub={sub}")
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    r, k, v, w, u, dout = (t.to(dt) for t in (r, k, v, w, u, dout))
    B, S, H, hs = r.shape
    vd = (v * dout).sum(-1, keepdim=True)               # (B, S, H, 1)
    bonus = (r * u * k).sum(-1, keepdim=True)           # (B, S, H, 1)

    def step(state, t):
        return (w[:, t, :, :, None] * state
                + k[:, t, :, :, None] * v[:, t, :, None, :])

    starts = range(0, S, seg)
    state = torch.zeros((B, H, hs, hs), dtype=dt, device=r.device)
    kept = []
    for t in range(starts[-1]):
        if t % seg == 0:
            kept.append(state)
        state = step(state, t)
    kept.append(state)                                  # the last's start
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((B, H, hs), dtype=dt, device=r.device)
    g = torch.zeros_like(state)
    for s0 in reversed(starts):
        end = min(s0 + seg, S)
        subs = range(s0, end, sub)
        sub_kept = [kept[s0 // seg]]
        st = sub_kept[0]
        for t in range(s0, subs[-1]):
            st = step(st, t)
            if (t + 1 - s0) % sub == 0:
                sub_kept.append(st)
        for c0 in reversed(subs):
            states = [sub_kept[(c0 - s0) // sub]]
            for t in range(c0, min(c0 + sub, end) - 1):
                states.append(step(states[-1], t))
            for t in reversed(range(c0, min(c0 + sub, end))):
                prev = states[t - c0]
                dr[:, t] = (torch.einsum("bhij,bhj->bhi", prev, dout[:, t])
                            + u * k[:, t] * vd[:, t])
                dk[:, t] = (torch.einsum("bhij,bhj->bhi", g, v[:, t])
                            + u * r[:, t] * vd[:, t])
                dv[:, t] = (torch.einsum("bhij,bhi->bhj", g, k[:, t])
                            + dout[:, t] * bonus[:, t])
                dw[:, t] = (g * prev).sum(-1)
                du = du + r[:, t] * k[:, t] * vd[:, t]
                g = (w[:, t, :, :, None] * g
                     + r[:, t, :, :, None] * dout[:, t, :, None, :])
    return dr, dk, dv, dw, du.sum(0)


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
