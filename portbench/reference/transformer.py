"""Plain reference of the decoder-only transformer family, in f32.

The published block (SmolLM's Llama-style block, Mixtral's with its
top-2 MoE FFN): RMSNorm, grouped-query attention with rotary positions
(the two halves of each head rotated, as the released models do),
causal, the SwiGLU FFN or the token-choice top-k MoE (the gates a
softmax over the k picked router logits, no capacity: every token
reaches its experts), a final RMSNorm and the output head (the tied
embedding or its own). It reads the benchmark's weight tensors, which
are bf16 (the router f32), and computes everything in f32 with TF32
off, layer by layer over all the sequences it is given, so that one
layer's weights are in f32 at a time.

``mode="fp8"`` is the control: every product with a weight takes both
operands rounded to float8 e4m3 (activations scaled per row, weights per
output column, to the format's largest value 448), the precision below
the bf16 that the configuration states.

Imports torch only: nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for the block, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (f32) rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """a (N, in) @ w (in, out) in f32, or in the control's fp8."""
    if mode == "fp8":
        return fp8_round(a, -1) @ fp8_round(w, 0)
    return a @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd), pos (S,): each head's two halves rotated by
    angle pos * theta^(-i / (hd/2)), i < hd/2."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, window: int | None) -> torch.Tensor:
    """Causal grouped-query attention of one sequence, f32 softmax.
    q (S, H, hd), k/v (S, KV, hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    visible = i[None, :] <= i[:, None]
    if window:
        visible &= i[None, :] > i[:, None] - window
    scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hqk,khd->qhd", probs, v).reshape(S, H * hd)


def _ffn(h, lw: dict, cfg: dict, mode: str) -> torch.Tensor:
    if "router" not in lw:
        g = _mm(h, lw["w_gate"].float(), mode)
        u = _mm(h, lw["w_up"].float(), mode)
        return _mm(F.silu(g) * u, lw["w_down"].float(), mode)
    K = int(cfg["num_experts_per_tok"])
    logits = _mm(h, lw["router"].float(), mode)
    top, idx = torch.topk(logits, K, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for e in range(lw["router"].shape[-1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = _mm(F.silu(_mm(x, lw["w_gate"][e].float(), mode))
                * _mm(x, lw["w_up"][e].float(), mode),
                lw["w_down"][e].float(), mode)
        out.index_add_(0, rows, gates[rows, slot][:, None] * y)
    return out


def forward(weights: dict, cfg: dict, seqs, mode: str = "f32",
            want_kv: bool = False) -> list[dict]:
    """Run each sequence of ``seqs`` ((tokens (S,) int, first judged
    position) pairs) through the model. Returns, per sequence,
    ``{"logits": (S - first, V) f32}`` at positions first .. S-1 and,
    with ``want_kv``, ``"kv": (S, L, 2, KV, hd)`` f32, each layer's roped
    keys and values."""
    if mode not in ("f32", "fp8"):
        raise ValueError(f"unknown mode {mode!r}")
    w = weights
    L = int(cfg["num_hidden_layers"])
    H = int(cfg["num_attention_heads"])
    KV = int(cfg["num_key_value_heads"])
    hd = int(cfg["hidden_size"]) // H
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    window = cfg.get("sliding_window")
    out = []
    with torch.no_grad(), exact_f32():
        xs, kvs = [], []
        for tokens, _first in seqs:
            tokens = torch.as_tensor(tokens, device=w["embed"].device)
            xs.append(w["embed"][tokens.long()].float())
            kvs.append([] if want_kv else None)
        for layer in range(L):
            lw = {k.split(".", 1)[1]: t[layer] for k, t in w.items()
                  if k.startswith("layers.")}
            wq, wk, wv, wo = (lw[n].float() for n in ("wq", "wk", "wv", "wo"))
            for i, x in enumerate(xs):
                S = x.shape[0]
                pos = torch.arange(S, device=x.device)
                h = rmsnorm(x, lw["ln1"], eps)
                q = rope(_mm(h, wq, mode).reshape(S, H, hd), pos, theta)
                k = rope(_mm(h, wk, mode).reshape(S, KV, hd), pos, theta)
                v = _mm(h, wv, mode).reshape(S, KV, hd)
                if want_kv:
                    kvs[i].append(torch.stack([k, v], dim=1))
                xs[i] = x + _mm(attend(q, k, v, window), wo, mode)
            del wq, wk, wv, wo
            # the FFN acts on each token alone: all sequences at once
            x = torch.cat(xs)
            x = x + _ffn(rmsnorm(x, lw["ln2"], eps), lw, cfg, mode)
            xs = list(torch.split(x, [t.shape[0] for t in xs]))
        head = (w["lm_head"].float() if "lm_head" in w
                else w["embed"].float().T)
        for i, ((_tokens, first), x) in enumerate(zip(seqs, xs)):
            h = rmsnorm(x[first:], w["ln_f"], eps)
            res = {"logits": _mm(h, head, mode)}
            if want_kv:
                res["kv"] = torch.stack(kvs[i], dim=1)
            out.append(res)
    return out
