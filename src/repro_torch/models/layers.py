"""Layers of the port (the subset of ``repro/models/layers.py`` that the
dense and MoE decoders, RWKV6, Zamba2 and the Whisper encoder-decoder
use: norms, RoPE, attention for the full sequence and for one decode
token, SwiGLU, the GELU MLP, the token-choice MoE block, cross-entropy).

Conventions follow the reference: params are nested dicts of tensors,
layer stacks carry a leading L axis, activations and params default to
bf16, and normalization, RoPE and softmax run in f32. bf16 rounding
happens at the reference's casts: ``rmsnorm``'s output, ``rope``'s
output, the softmax probabilities before P.V, and ``swiglu``'s product
before the down projection. Under autograd (training) each attention q
block is recomputed in the backward pass instead of keeping its scores
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
around each q block does.

The decode cache is updated in place (the reference donates it to the
jitted step and rebinds the result).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

DEFAULT_DTYPE = torch.bfloat16

NEG_INF = -1e30  # large-negative in f32; avoids bf16 -inf NaN pitfalls


# ---------------------------------------------------------------------------
# init helpers (own torch.Generator; draws happen on the CPU so a seed gives
# the same weights whatever the target device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, lead: tuple, in_dim: int, out_dim: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    return (torch.randn((*lead, in_dim, out_dim), generator=gen,
                        device=gen.device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rmsnorm_init(lead: tuple, dim: int, dtype=DEFAULT_DTYPE) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype)}


def layernorm_init(lead: tuple, dim: int, dtype=DEFAULT_DTYPE,
                   device="cpu") -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict of tensors (params, caches);
    with ``rest``, over the matching leaves of trees of the same
    structure (``fn(leaf, *their leaves)``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict of tensors, keys in sorted order at
    every level (the order of the reference's ``jax.tree.leaves``), so two
    trees of one structure yield matching leaves whatever order their
    dicts were built in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(tree, leaves):
    """``leaves`` (an iterable in ``tree_leaves`` order) in ``tree``'s
    structure."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics and the population variance
    (``jnp.var``'s ddof 0; ``torch.var`` defaults to the unbiased one)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


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
    q_block: int = 512               # chunking for the online-softmax path
    rope_theta: float = 10000.0


def attn_init(gen: torch.Generator, lead: tuple, d_model: int,
              spec: AttnSpec, dtype=DEFAULT_DTYPE) -> dict:
    """Attention projections N(0, 1/fan_in), biases (``spec.qkv_bias``)
    zero, as the reference's ``attn_init``."""
    qd = spec.num_heads * spec.head_dim
    kvd = spec.num_kv_heads * spec.head_dim
    p = {"wq": dense_init(gen, lead, d_model, qd, dtype),
         "wk": dense_init(gen, lead, d_model, kvd, dtype),
         "wv": dense_init(gen, lead, d_model, kvd, dtype),
         "wo": dense_init(gen, lead, qd, d_model, dtype)}
    if spec.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((*lead, n), dtype=dtype)
    return p


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


def attention(q, k, v, spec: AttnSpec, q_positions=None,
              kv_positions=None) -> torch.Tensor:
    """Chunked attention: a loop over q blocks, dense over kv (masked).

    q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd). Returns (B, Sq, H, hd).
    Never materializes more than (B, q_block, H, Skv) scores.
    """
    Sq, Skv = q.shape[1], k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)[None, :]
    qb = min(spec.q_block, Sq)
    if Sq % qb != 0:                      # fall back to one dense block
        return _sdpa_block(q, k, v,
                           _mask_bias(q_positions, kv_positions, spec))
    # under autograd, recompute each block's scores and probabilities in
    # the backward pass instead of keeping (B, qb, H, Skv) f32 residuals
    # per block of every layer (the reference's jax.checkpoint)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    block = (functools.partial(torch.utils.checkpoint.checkpoint,
                               _sdpa_block, use_reentrant=False)
             if remat else _sdpa_block)
    return torch.cat([
        block(q[:, i:i + qb], k, v,
              _mask_bias(q_positions[:, i:i + qb], kv_positions, spec))
        for i in range(0, Sq, qb)], dim=1)


def attn_apply(params, x, spec: AttnSpec, positions=None,
               use_kernel: bool = False) -> torch.Tensor:
    """Self-attention over a full sequence (prefill / loss evaluation).
    ``use_kernel`` sends the attention itself to ``kernels.ops``'
    ``flash_attention`` (the CUDA kernel for a CUDA tensor)."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if spec.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, spec.num_heads, spec.head_dim)
    k = k.reshape(B, S, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(B, S, spec.num_kv_heads, spec.head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)
    if use_kernel:
        # imported here: kernels.ref imports this module
        from repro_torch.kernels import ops as kernel_ops
        out = kernel_ops.flash_attention(q, k, v, causal=spec.causal,
                                         window=spec.window,
                                         prefix_len=spec.prefix_len)
    else:
        out = attention(q, k, v, spec, positions, positions)
    return out.reshape(B, S, -1) @ params["wo"]


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

def swiglu_init(gen: torch.Generator, lead: tuple, d_model: int, d_ff: int,
                dtype=DEFAULT_DTYPE) -> dict:
    return {"w_gate": dense_init(gen, lead, d_model, d_ff, dtype),
            "w_up": dense_init(gen, lead, d_model, d_ff, dtype),
            "w_down": dense_init(gen, lead, d_ff, d_model, dtype)}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ params["w_gate"]).float())
    u = (x @ params["w_up"]).float()
    return (g * u).to(x.dtype) @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, lead: tuple, d_model: int,
                  d_ff: int, dtype=DEFAULT_DTYPE) -> dict:
    return {"w_in": dense_init(gen, lead, d_model, d_ff, dtype),
            "b_in": torch.zeros((*lead, d_ff), dtype=dtype),
            "w_out": dense_init(gen, lead, d_ff, d_model, dtype),
            "b_out": torch.zeros((*lead, d_model), dtype=dtype)}


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, so the port
    asks for it (``F.gelu``'s default is the exact erf form)."""
    h = F.gelu((x @ params["w_in"] + params["b_in"]).float(),
               approximate="tanh")
    return h.to(x.dtype) @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-dropped, argsort dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


def _expert_stack(gen: torch.Generator, lead: tuple, experts: int,
                  in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    """(*lead, experts, in_dim, out_dim) N(0, 1/in_dim) weights drawn one
    (in_dim, out_dim) matrix at a time into a ``dtype`` tensor: the f32
    temporary is one matrix, not the stack (mixtral-8x7b's stack of 16
    layers would be 30 GB in f32)."""
    out = torch.empty((*lead, experts, in_dim, out_dim), dtype=dtype,
                      device=gen.device)
    flat = out.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, (), in_dim, out_dim, dtype)
    return out


def moe_init(gen: torch.Generator, lead: tuple, d_model: int, d_ff: int,
             spec: MoESpec, dtype=DEFAULT_DTYPE) -> dict:
    """The reference's ``moe_init`` tree: an f32 router (*lead, D, E) and
    the experts' SwiGLU stacks (*lead, E, D, F) / (*lead, E, F, D)."""
    E = spec.num_experts
    return {"router": dense_init(gen, lead, d_model, E, torch.float32),
            "w_gate": _expert_stack(gen, lead, E, d_model, d_ff, dtype),
            "w_up": _expert_stack(gen, lead, E, d_model, d_ff, dtype),
            "w_down": _expert_stack(gen, lead, E, d_ff, d_model, dtype)}


def moe_capacity(tokens: int, spec: MoESpec) -> int:
    c = math.ceil(spec.top_k * tokens / spec.num_experts
                  * spec.capacity_factor)
    c = max(8, min(tokens, int(c)))
    if c > 256:                       # the reference's aligned capacity
        c = ((c + 255) // 256) * 256
    return c


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis of an f32 tensor: the k largest
    values in descending order, the lower index first among equal values
    and -0.0 below +0.0 (``torch.topk`` promises neither). A stable
    descending sort of the values' total-order integer keys."""
    bits = x.contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` with a gradient:
    autograd has no derivative for the ``out_dtype`` product. The
    backward takes both products in f32 from the f32 cotangent and
    rounds each to its operand's dtype, as ``jax.grad`` of the
    reference's ``preferred_element_type=f32`` einsum does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        return (torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype),
                torch.bmm(a.float().transpose(1, 2), g).to(b.dtype))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with an f32 result that is never rounded to the
    operands' dtype (the reference's ``preferred_element_type=f32``). On
    the card cuBLAS writes f32 from bf16 operands (``out_dtype``; under
    autograd through ``_BmmF32``, which gives it a backward); the CPU has
    no such kernel, so there both operands go to f32, where the bf16
    products are exact."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _BmmF32.apply(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def moe_apply(params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Token-choice top-k MoE with capacity dropping, the reference's
    steps: f32 router logits, ``top_k`` with ``lax.top_k``'s tie order,
    softmax over the K gates, a stable argsort of the flat expert ids,
    each slot's rank in its expert, slots ranked C or beyond dropped to
    the sentinel row E*C, the (E, C, D) buffer, SwiGLU per expert (gate
    and up products in f32) and the f32 combine (``moe_combine``). No
    step reads a value on the host (C is fixed by the static token count;
    each expert's first slot is a search of the sorted ids, where the
    reference's ``bincount`` would read their maximum on CUDA), so the
    decode step can be captured in a CUDA graph.

    x: (B, S, D) -> (B, S, D).
    """
    B, S, D = x.shape
    T = B * S
    E, K = spec.num_experts, spec.top_k
    C = moe_capacity(T, spec)
    dev = x.device
    xt = x.reshape(T, D)

    logits = xt.float() @ params["router"]                      # (T, E)
    gate_vals, expert_idx = top_k(logits, K)                    # (T, K)
    gates = torch.softmax(gate_vals, dim=-1)

    flat_e = expert_idx.reshape(-1)                             # (N,)
    N = T * K
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(N, device=dev) - torch.searchsorted(se, se)
    keep = rank < C
    dest = torch.where(keep, se * C + rank, E * C)              # E*C = dropped

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[dest] = xt[order // K]
    buf = buf[:E * C].reshape(E, C, D)
    g = F.silu(_bmm_f32(buf, params["w_gate"]))
    u = _bmm_f32(buf, params["w_up"])
    eout = torch.bmm((g * u).to(x.dtype), params["w_down"]).reshape(E * C, D)

    # back to the (T, K) slot layout: slot i of the flat layout sits at
    # position pos[i] of the sorted one
    pos = torch.empty_like(order)
    pos[order] = torch.arange(N, device=dev)
    pos = pos.reshape(T, K)
    out = moe_combine(eout, dest[pos], keep[pos], gates, expert_idx)
    return out.to(x.dtype).reshape(B, S, D)


def moe_combine(eout: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                gates: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """(T, D) f32: each token's K contributions, gate times its slot's row
    of ``eout`` (E*C, D) (0 for a dropped slot), added from 0 in
    ascending expert id, one column at a time, whatever order the K slots
    come in: the order of the reference's scatter-add over the sorted
    slots, the same on every device and every run (``index_add_`` on CUDA
    adds with atomics in no fixed order). dest, keep, gates, expert_idx:
    (T, K)."""
    T, K = dest.shape
    by_expert = torch.argsort(expert_idx, dim=-1)
    dest, keep, gates = (torch.gather(a, 1, by_expert)
                         for a in (dest, keep, gates))
    rows = eout[torch.clamp(dest, max=eout.shape[0] - 1)]      # (T, K, D)
    contrib = torch.where(keep[..., None], rows, 0.0).float() \
        * gates[..., None]
    out = torch.zeros((T, eout.shape[1]), dtype=torch.float32,
                      device=eout.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out


def moe_aux_loss(params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style: E * sum(f_e * p_e)),
    with f_e the share of tokens that picked expert e among their top-k
    (a count over T) and p_e the mean router probability."""
    D = x.shape[-1]
    logits = x.reshape(-1, D).float() @ params["router"]
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    idx = top_k(logits, spec.top_k)[1].reshape(-1)
    frac = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=x.device)) / T
    return E * torch.sum(frac * torch.mean(probs, dim=0))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in f32 over the labels that are not
    ``ignore_id``. logits: (B,S,V); labels: (B,S)."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
