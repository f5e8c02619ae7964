"""Decoder-only transformer LM: ``repro/models/transformer.py`` for the
dense family, prefix-LM (paligemma) included, and the MoE family
(mixtral-8x7b with its sliding window, kimi-k2-1t-a32b).

Layers are stacked with a leading L axis, as in the reference, so the
reference's parameter tree converts leaf for leaf (``params_from_jax``);
``runconfig.scan`` (a Python loop over the layers, each under a
checkpoint when remat is on) takes the place of ``lax.scan``, and
``runconfig.constrain`` pins the activations' layout in a dry-run's
shard env, at the reference's sites. Ported: the full-sequence
``forward`` (with ``use_kernel`` for the flash-attention
kernel and ``return_kv``; ``aux`` is the mean of the layers' MoE
load-balancing losses, 0 for a dense config), ``loss_fn``, ``prefill``
and ``decode_step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers as nn
from repro_torch.models import runconfig
from repro_torch.models.layers import AttnSpec, MoESpec


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    qkv_bias: bool = False
    moe: MoESpec | None = None
    window: int | None = None           # sliding-window attention
    rope_theta: float = 10000.0
    prefix_len: int = 0                 # prefix-LM prefix (paligemma)
    embed_scale: bool = False           # gemma-style sqrt(d) embed scaling
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_spec(self, prefix_len: int | None = None) -> AttnSpec:
        return AttnSpec(
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.resolved_head_dim(),
            causal=True,
            window=self.window,
            prefix_len=self.prefix_len if prefix_len is None else prefix_len,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
        )

    def param_count(self) -> int:
        """Analytic parameter count."""
        return self._count(self.moe.num_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: the router and the top-k
        experts only)."""
        return self._count(self.moe.top_k if self.moe else 0)

    def _count(self, experts: int) -> int:
        """The reference's formula with ``experts`` expert FFNs a layer
        (0: the dense SwiGLU)."""
        hd = self.resolved_head_dim()
        attn = self.d_model * hd * (self.num_heads * 2
                                    + self.num_kv_heads * 2)
        if self.moe is not None:
            ffn = (self.d_model * self.moe.num_experts
                   + 3 * experts * self.d_model * self.d_ff)
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + self.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: LMConfig,
         device: torch.device | str = "cpu") -> dict:
    """Random weights from ``generator``, with the reference's
    distributions: N(0, 1/fan_in) projections (an MoE config's router in
    f32), N(0, 0.02) embeddings, unit norm scales. The draws run on the
    generator's device (a CUDA generator keeps a 14 B-parameter init on
    the card); the tree is moved to ``device`` at the end."""
    L, D, dt = cfg.num_layers, cfg.d_model, cfg.dtype
    hd = cfg.resolved_head_dim()
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    g = generator
    attn = {"wq": nn.dense_init(g, (L,), D, qd, dt),
            "wk": nn.dense_init(g, (L,), D, kvd, dt),
            "wv": nn.dense_init(g, (L,), D, kvd, dt),
            "wo": nn.dense_init(g, (L,), qd, D, dt)}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros((L, qd), dtype=dt),
                    bk=torch.zeros((L, kvd), dtype=dt),
                    bv=torch.zeros((L, kvd), dtype=dt))
    params = {
        "embed": nn.embed_init(g, cfg.vocab, D, dt),
        "layers": {
            "ln1": nn.rmsnorm_init((L,), D, dt),
            "attn": attn,
            "ln2": nn.rmsnorm_init((L,), D, dt),
        },
        "ln_f": nn.rmsnorm_init((), D, dt),
    }
    if cfg.moe is not None:
        params["layers"]["moe"] = nn.moe_init(g, (L,), D, cfg.d_ff, cfg.moe,
                                              dt)
    else:
        params["layers"]["mlp"] = {
            "w_gate": nn.dense_init(g, (L,), D, cfg.d_ff, dt),
            "w_up": nn.dense_init(g, (L,), D, cfg.d_ff, dt),
            "w_down": nn.dense_init(g, (L,), cfg.d_ff, D, dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(g, (), D, cfg.vocab, dt)
    return nn.tree_map(lambda t: t.to(device), params)


def params_from_jax(np_tree: dict, cfg: LMConfig,
                    device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy float32
    arrays; bf16 passes through float32 exactly) as the port's params in
    ``cfg.dtype`` on ``device``, but for the MoE router, which stays f32
    as the reference keeps it. The two trees have the same layout."""
    def convert(tree, f32=False):
        if isinstance(tree, dict):
            return {k: convert(v, f32 or k == "router")
                    for k, v in tree.items()}
        return torch.from_numpy(np.ascontiguousarray(tree, np.float32)).to(
            dtype=torch.float32 if f32 else cfg.dtype, device=device)
    return convert(np_tree)


# ---------------------------------------------------------------------------
# forward (prefill / loss evaluation)
# ---------------------------------------------------------------------------

def _embed_tokens(params, cfg: LMConfig, tokens, prefix_embeds):
    x = nn.embed_lookup(runconfig.gather(params["embed"]), tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def _unembed(params, cfg: LMConfig, x):
    if cfg.tie_embeddings:
        return x @ runconfig.gather(params["embed"]).T
    return x @ runconfig.gather(params["lm_head"])


def _ffn(layer, cfg: LMConfig, h):
    """The layer's feed-forward block: the MoE block or the SwiGLU MLP."""
    if cfg.moe is not None:
        return nn.moe_apply(layer["moe"], h, cfg.moe)
    return nn.swiglu(layer["mlp"], h)


def forward(params, cfg: LMConfig, tokens, prefix_embeds=None,
            use_kernel: bool = False, return_kv: bool = False):
    """tokens: (B, S) int -> logits (B, S, V), aux [, (k, v)].

    ``prefix_embeds`` (B, P, D) replaces the first P embedding rows and the
    attn mask makes those P kv positions bidirectionally visible (prefix-LM).
    ``return_kv`` adds the per-layer roped k and v, stacked (L, B, S, KV,
    hd), recomputed from each layer's input (the prefill cache). ``aux`` is
    the f32 mean over the layers of ``moe_aux_loss`` (0 for a dense
    config).
    """
    B, S = tokens.shape
    spec = cfg.attn_spec()
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, layer):
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        h = nn.rmsnorm(layer["ln1"], x)
        kv = None
        if return_kv:
            kproj = h @ layer["attn"]["wk"]
            vproj = h @ layer["attn"]["wv"]
            if cfg.qkv_bias:
                kproj = kproj + layer["attn"]["bk"]
                vproj = vproj + layer["attn"]["bv"]
            kv = (nn.rope(kproj.reshape(B, S, spec.num_kv_heads,
                                        spec.head_dim),
                          positions, spec.rope_theta),
                  vproj.reshape(B, S, spec.num_kv_heads, spec.head_dim))
        x = runconfig.constrain(
            x + nn.attn_apply(layer["attn"], h, spec, positions, use_kernel),
            ("dp", None, None))
        h = nn.rmsnorm(layer["ln2"], x)
        x = x + _ffn(layer, cfg, h)
        aux = (nn.moe_aux_loss(layer["moe"], h, cfg.moe)
               if cfg.moe is not None else None)
        return x, (aux, kv)

    x, (auxes, kvs) = runconfig.scan(body, x, params["layers"])
    x = nn.rmsnorm(params["ln_f"], runconfig.constrain(x, ("dp", None, None)))
    logits = runconfig.constrain(_unembed(params, cfg, x),
                                 ("dp", None, "tp"))
    aux = (torch.mean(auxes) if auxes is not None else
           torch.zeros((), dtype=torch.float32, device=x.device))
    if return_kv:
        return logits, aux, kvs
    return logits, aux


def loss_fn(params, cfg: LMConfig, batch, use_kernel: bool = False,
            aux_weight: float = 0.01):
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("prefix_embeds"), use_kernel)
    ce = nn.cross_entropy(logits, batch["labels"])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def cache_width(cfg: LMConfig, cache_len: int) -> int:
    return min(cache_len, cfg.window) if cfg.window else cache_len


def init_cache(cfg: LMConfig, batch: int, cache_len: int,
               device: torch.device | str = "cpu") -> dict:
    """Ring K/V cache, layers stacked first: k/v (L, B, W, KV, hd),
    pos (L, B, W) int32 with -1 marking empty slots."""
    return nn.attn_cache_init((cfg.num_layers,), batch,
                              cache_width(cfg, cache_len), cfg.attn_spec(),
                              cfg.dtype, device)


def decode_step(params, cfg: LMConfig, cache, tokens, pos):
    """One decode step. tokens: (B,) int; pos: (B,) absolute positions.

    Returns (logits (B, V), cache); the cache is updated in place. The
    prefix mask is irrelevant at decode (all cached positions are visible
    to the new token).
    """
    spec = cfg.attn_spec(prefix_len=0)
    x = _embed_tokens(params, cfg, tokens[:, None], None)

    def body(x, scanned):
        layer, lcache = scanned
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        h = nn.rmsnorm(layer["ln1"], x)
        y, _ = nn.attn_decode_step(layer["attn"], h, lcache, pos, spec)
        x = runconfig.constrain(x + y, ("dp", None, None))
        h = nn.rmsnorm(layer["ln2"], x)
        return x + _ffn(layer, cfg, h), None

    x, _ = runconfig.scan(body, x, (params["layers"], cache))
    x = nn.rmsnorm(params["ln_f"], runconfig.constrain(x, ("dp", None, None)))
    logits = runconfig.constrain(_unembed(params, cfg, x[:, 0, :]),
                                 ("dp", "tp"))
    return logits, cache


def prefill(params, cfg: LMConfig, tokens, prefix_embeds=None,
            cache_len: int | None = None):
    """Full-sequence forward that also builds the decode cache.

    Returns (logits (B, S, V), cache) with the cache as ``init_cache``
    lays it out on the params' device: the last min(S, W) positions
    written into ring slots ``pos % W`` in place, the other slots left
    empty (pos -1).
    """
    B, S = tokens.shape
    W = cache_width(cfg, cache_len or S)
    logits, _, (k_all, v_all) = forward(params, cfg, tokens, prefix_embeds,
                                        return_kv=True)
    dev = logits.device
    take = min(S, W)
    pos_tail = torch.arange(S - take, S, device=dev)[None, :].expand(B, take)
    slots = pos_tail % W                                  # (B, take)
    bidx = torch.arange(B, device=dev)[:, None]
    cache = init_cache(cfg, B, W, dev)
    cache["k"][:, bidx, slots] = k_all[:, :, S - take:]
    cache["v"][:, bidx, slots] = v_all[:, :, S - take:]
    cache["pos"][:, bidx, slots] = pos_tail.to(torch.int32)
    return logits, cache
