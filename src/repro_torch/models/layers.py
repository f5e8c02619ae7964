"""Dense-decoder layers of the port (the decode subset of
``repro/models/layers.py``).

Conventions follow the reference: params are nested dicts of tensors,
layer stacks carry a leading L axis, activations and params default to
bf16, and normalization, RoPE and softmax run in f32. bf16 rounding
happens at the reference's casts: ``rmsnorm``'s output, ``rope``'s
output, the softmax probabilities before P.V, and ``swiglu``'s product
before the down projection.

The decode cache is updated in place (the reference donates it to the
jitted step and rebinds the result).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

DEFAULT_DTYPE = torch.bfloat16

NEG_INF = -1e30  # large-negative in f32; avoids bf16 -inf NaN pitfalls


# ---------------------------------------------------------------------------
# init helpers (own torch.Generator; draws happen on the CPU so a seed gives
# the same weights whatever the target device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, lead: tuple, in_dim: int, out_dim: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn((*lead, in_dim, out_dim), generator=gen)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen) * 0.02).to(dtype)


def rmsnorm_init(lead: tuple, dim: int, dtype=DEFAULT_DTYPE) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S).

    ``theta == 0`` is the no-RoPE sentinel (absolute-position models)."""
    if theta == 0.0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, masks: causal / prefix-LM / sliding-window)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None        # sliding-window size (None = full)
    prefix_len: int = 0              # prefix-LM: first P kv positions visible
    qkv_bias: bool = False
    rope_theta: float = 10000.0


def _mask_bias(q_pos, kv_pos, spec: AttnSpec) -> torch.Tensor:
    """Additive f32 mask bias (0 visible / NEG_INF hidden), (..., Sq, Skv)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    visible = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if spec.causal:
        visible = kp <= qp
        if spec.prefix_len > 0:
            visible = visible | (kp < spec.prefix_len)
    if spec.window is not None:
        visible = visible & (kp > qp - spec.window)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


def _sdpa_block(q, k, v, bias) -> torch.Tensor:
    """One dense attention block in f32 softmax. q:(B,Sq,H,hd) k/v:(B,Skv,KV,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attn_decode_step(params, x, cache, pos, spec: AttnSpec):
    """One-token decode. x: (B, 1, D); cache: {"k","v": (B, W, KV, hd),
    "pos": (B, W)}, updated in place.

    ``pos`` is the absolute position (B,) of the new token. The cache is a
    ring buffer of width W (=window for SWA, =max_len for full attention);
    entries older than the window are masked via stored positions.
    """
    B = x.shape[0]
    W = cache["k"].shape[1]
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if spec.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, 1, spec.num_heads, spec.head_dim)
    k = k.reshape(B, 1, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(B, 1, spec.num_kv_heads, spec.head_dim)
    q = rope(q, pos[:, None], spec.rope_theta)
    k = rope(k, pos[:, None], spec.rope_theta)

    slot = (pos % W).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0]
    cache["v"][bidx, slot] = v[:, 0]
    cache["pos"][bidx, slot] = pos.to(torch.int32)

    kv_pos = cache["pos"]  # (B, W) absolute positions; empty slots are -1
    bias_valid = torch.where(kv_pos >= 0, 0.0, NEG_INF)[:, None, :]
    bias = _mask_bias(pos[:, None], kv_pos, spec) + bias_valid
    out = _sdpa_block(q, cache["k"], cache["v"], bias)
    return out.reshape(B, 1, -1) @ params["wo"], cache


def attn_cache_init(lead: tuple, batch: int, width: int, spec: AttnSpec,
                    dtype=DEFAULT_DTYPE, device="cpu") -> dict:
    shape = (*lead, batch, width, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((*lead, batch, width), -1, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ params["w_gate"]).float())
    u = (x @ params["w_up"]).float()
    return (g * u).to(x.dtype) @ params["w_down"]
