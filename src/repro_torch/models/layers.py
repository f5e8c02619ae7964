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

Inside a dry-run's shard env (``runconfig.options(shard_env=...)``, the
tensors DTensors) a few functions take another path that DTensor can
shard: ``embed_lookup``, ``attention`` (``_sdpa_heads``), the decode
ring's write, ``moe_apply`` / ``moe_aux_loss`` (``local_map``) and
``cross_entropy``; each computes the same function. Outside an env they
are the plain code, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models import runconfig

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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; in a shard env ``F.embedding`` of the table
    gathered whole (DTensor's vocab-parallel lookup leaves a masked
    partial sum whose gradient meets the tied unembedding's plain partial
    sum, a pair DTensor cannot add), its output sharded like the
    tokens."""
    if runconfig.shard_env() is not None:
        x = F.embedding(tokens.long(), runconfig.replicate(table))
        return runconfig.constrain(x, ("dp",) + (None,) * (x.dim() - 1))
    return table[tokens.long()]


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


def _sdpa_heads(q, k, v, bias) -> torch.Tensor:
    """``_sdpa_block`` for a shard env (the dry-run's DTensors): each kv
    head repeated to its G query heads and laid out like them, heads over
    the tensor axis, so no view splits a sharded head dim into (KV, G)
    (with 8 kv heads on a 16-wide axis that split would gather every
    query head on every rank). The same products and sums, plus those of
    the zero heads that pad an uneven head count."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    tp = runconfig.tp_size() or 1
    Hp = -(-H // tp) * tp
    whole = ("dp", None, None, None)
    if H >= tp and Hp != H:
        # heads that do not divide the tensor axis (24 or 40 on 16) are
        # padded with zero heads to a multiple of it, as GSPMD pads them:
        # DTensor's views of an unevenly split head dim fail (torch 2.11).
        # The zeros are a slice of the tensor times 0 (``F.pad``'s rule
        # fails there, and a new zeros tensor would be whole on every rank)
        q, k, v = (runconfig.constrain(t, whole) for t in (q, k, v))
        q, k, v = (torch.cat([t, t.narrow(2, 0, Hp - H) * 0], dim=2)
                   for t in (q, k, v))
    heads = ("dp", None, "tp", None)
    q, k, v = (runconfig.constrain(t, heads) for t in (q, k, v))
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd)) + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)
    if Hp != H and H >= tp:
        out = runconfig.constrain(out, whole)[:, :, :H]
    return out


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
    # one query (a decode step's cross-attention) keeps the grouped form:
    # its kv, sharded over the sequence, are never gathered there
    sdpa = (_sdpa_heads if runconfig.shard_env() is not None and Sq > 1
            else _sdpa_block)
    qb = min(spec.q_block, Sq)
    if Sq % qb != 0:                      # fall back to one dense block
        return sdpa(q, k, v, _mask_bias(q_positions, kv_positions, spec))
    if runconfig.unroll_enabled():
        # the reference's dry-run cap of 8 q blocks (widened blocks, the
        # same rows: every row's softmax still spans all of kv)
        while Sq // qb > 8:
            qb *= 2
    # under autograd, recompute each block's scores and probabilities in
    # the backward pass instead of keeping (B, qb, H, Skv) f32 residuals
    # per block of every layer (the reference's jax.checkpoint)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    block = (functools.partial(torch.utils.checkpoint.checkpoint,
                               sdpa, use_reentrant=False)
             if remat else sdpa)
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
    heads = ("dp", None, "tp", None)
    q = runconfig.constrain(
        q.reshape(B, S, spec.num_heads, spec.head_dim), heads)
    k = runconfig.constrain(
        k.reshape(B, S, spec.num_kv_heads, spec.head_dim), heads)
    v = runconfig.constrain(
        v.reshape(B, S, spec.num_kv_heads, spec.head_dim), heads)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
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
    if runconfig.shard_env() is not None:
        # a sharded ring (the dry-run's DTensors) takes a whole-ring
        # select and a copy: DTensor has no in-place scatter that keeps
        # the ring's batch and sequence sharding
        hit = torch.arange(W, device=x.device)[None, :] == slot[:, None]
        for name, new in (("k", k), ("v", v), ("pos", pos[:, None])):
            ring = cache[name]
            sel = hit.reshape(*hit.shape, *([1] * (ring.dim() - 2)))
            ring.copy_(torch.where(sel, new.to(ring.dtype), ring))
    else:
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
    h = runconfig.constrain((g * u).to(x.dtype), ("dp", None, "tp"))
    return h @ params["w_down"]


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
    h = runconfig.constrain(h.to(x.dtype), ("dp", None, "tp"))
    return h @ params["w_out"] + params["b_out"]


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
    if is_fake(out):           # shapes only (the dry-run): nothing to draw
        return out
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
    C = moe_capacity(T, spec)
    if runconfig.shard_env() is not None:
        return _moe_sharded(params, x, spec, C)
    out = _moe_local(spec, C, x.dtype, x.reshape(T, D), params["router"],
                     params["w_gate"], params["w_up"], params["w_down"], 0)
    return out.to(x.dtype).reshape(B, S, D)


def _moe_local(spec: MoESpec, C: int, x_dtype, xt, router, w_gate, w_up,
               w_down, first_expert):
    """The dispatch of ``moe_apply``: tokens ``xt`` (T, D) routed over all
    E experts, the slots of experts [first_expert, first_expert + E_l)
    (the ``w_*`` stacks given) kept up to capacity ``C``, the f32 combine
    of those experts' outputs (T, D). With every expert (``first_expert``
    0, E_l = E) it is the whole block; in a shard env it is one rank's
    share (its experts or ffn columns, its share of the capacity), a
    partial sum over the ranks that hold the rest."""
    T, D = xt.shape
    K = spec.top_k
    E_l = w_gate.shape[0]
    dev = xt.device
    gate_vals, expert_idx = top_k(xt.float() @ router, K)
    gates = torch.softmax(gate_vals, dim=-1)
    flat_e = expert_idx.reshape(-1)
    N = T * K
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(N, device=dev) - torch.searchsorted(se, se)
    keep = rank < C
    if E_l < spec.num_experts:        # this rank holds some experts only
        keep = keep & (se >= first_expert) & (se < first_expert + E_l)
        se = se - first_expert
    dest = torch.where(keep, se * C + rank, E_l * C)
    buf = torch.zeros((E_l * C + 1, D), dtype=x_dtype, device=dev)
    buf[dest] = xt[order // K]
    buf = buf[:E_l * C].reshape(E_l, C, D)
    g = F.silu(_bmm_f32(buf, w_gate))
    u = _bmm_f32(buf, w_up)
    eout = torch.bmm((g * u).to(x_dtype), w_down).reshape(E_l * C, D)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(N, device=dev)
    pos = pos.reshape(T, K)
    return moe_combine(eout, dest[pos], keep[pos], gates, expert_idx)


def _moe_sharded(params, x, spec: MoESpec, C: int):
    """``moe_apply`` on DTensors (the dry-run): each rank dispatches its
    own tokens (batch-sharded over the data axes, whole over the tensor
    axis) into its share of the reference's (E, C, D) buffer, laid out as
    the reference constrains it: expert-sharded mode (E >= tp, kimi-k2)
    keeps its E/tp experts' slots, few-expert mode (mixtral) every
    expert's slots with its ffn columns; capacity sharded over the data
    axes that divide C. The combined output is a partial sum over the
    tensor axis (``local_map``; DTensor has no rule for the dispatch's
    sorts and searches). The routing is per rank, where the reference's
    is global: the costs, shapes and layouts are the reference's, the
    slot a token lands in may not be."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, dp, tp = runconfig.shard_env()
    names = list(mesh.mesh_dim_names)
    B, S, D = x.shape
    E = spec.num_experts
    tp_n = runconfig.tp_size() or 1
    expert_mode = tp is not None and E >= tp_n
    xt = runconfig.constrain(x.reshape(B * S, D), ("dp", None))
    cap_axes = runconfig.resolve(("dp",), (C,), mesh, dp, tp)[0] or ()
    C_l = C // math.prod(mesh.size(names.index(a)) for a in cap_axes)
    first = (mesh.get_local_rank(tp) * (E // tp_n)
             if expert_mode else 0)

    def on(dim_by_axis):
        return [dim_by_axis.get(n, Replicate()) for n in names]

    tok = on({a: Shard(0) for a in runconfig.placements_axes(xt)})
    w_up = on({tp: Shard(0 if expert_mode else 2)} if tp else {})
    w_down = on({tp: Shard(0 if expert_mode else 1)} if tp else {})
    out_pl = [Partial() if n == tp else tok[i] for i, n in enumerate(names)]
    fn = local_map(
        lambda *a: _moe_local(spec, C_l, x.dtype, *a, first),
        out_placements=out_pl,
        in_placements=(tok, on({}), w_up, w_up, w_down),
        device_mesh=mesh, redistribute_inputs=True)
    with runconfig.local_region(mesh.size()):
        out = fn(xt, params["router"], params["w_gate"], params["w_up"],
                 params["w_down"])
    out = runconfig.constrain(out, ("dp", None))
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
    if runconfig.shard_env() is not None:
        return _moe_aux_sharded(params, x, spec)
    logits = x.reshape(-1, D).float() @ params["router"]
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    idx = top_k(logits, spec.top_k)[1].reshape(-1)
    frac = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=x.device)) / T
    return E * torch.sum(frac * torch.mean(probs, dim=0))


def _moe_aux_local(spec: MoESpec, xt, router):
    """A rank's share of ``moe_aux_loss``: the (E,) counts of its tokens'
    top-k picks and the (E,) sums of their router probabilities."""
    logits = xt.float() @ router
    E = logits.shape[1]
    idx = top_k(logits, spec.top_k)[1].reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=xt.device)
    counts = counts.index_add_(0, idx, torch.ones(
        idx.shape, dtype=torch.float32, device=xt.device))
    return counts, torch.sum(torch.softmax(logits, dim=-1), dim=0)


def _moe_aux_sharded(params, x, spec: MoESpec):
    """``moe_aux_loss`` on DTensors: per-rank counts and probability sums
    (``local_map``), partial sums over the data axes, then the
    reference's formula over all T tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = runconfig.shard_env()[0]
    names = list(mesh.mesh_dim_names)
    D = x.shape[-1]
    xt = runconfig.constrain(x.reshape(-1, D), ("dp", None))
    T = xt.shape[0]
    axes = runconfig.placements_axes(xt)
    tok = [Shard(0) if n in axes else Replicate() for n in names]
    part = [Partial() if n in axes else Replicate() for n in names]
    fn = local_map(lambda a, r: _moe_aux_local(spec, a, r),
                   out_placements=(part, part),
                   in_placements=(tok, [Replicate()] * len(names)),
                   device_mesh=mesh, redistribute_inputs=True)
    with runconfig.local_region(mesh.size()):
        counts, probsum = fn(xt, params["router"])
    E = spec.num_experts
    return E * torch.sum((counts / T) * (probsum / T))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in f32 over the labels that are not
    ``ignore_id``. logits: (B,S,V); labels: (B,S)."""
    lf = logits.float()
    if runconfig.shard_env() is not None:
        # vocab-sharded logits (the dry-run): a logsumexp from a local max
        # and sum, each reduced once, and the reference's gather-free gold
        # logit, a masked sum that reduces locally (a gather would collect
        # the whole (B, S, V) tensor); both equal the plain forms
        m = torch.amax(lf, dim=-1, keepdim=True).detach()
        logz = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        vocab = runconfig.along(torch.arange(lf.shape[-1], device=lf.device),
                                lf, lf.dim() - 1)
        onehot = vocab == labels.long().clamp(min=0)[..., None]
        gold = torch.sum(torch.where(onehot, lf, 0.0), dim=-1)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1,
                            labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
