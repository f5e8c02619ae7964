"""Dense decoder-only transformer LM: the serving (decode) subset of
``repro/models/transformer.py``.

Layers are stacked with a leading L axis, as in the reference, so the
reference's parameter tree converts leaf for leaf (``params_from_jax``).
The training forward, prefill and the MoE / prefix-LM variants are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers as nn
from repro_torch.models.layers import AttnSpec


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
        hd = self.resolved_head_dim()
        attn = self.d_model * hd * (self.num_heads * 2
                                    + self.num_kv_heads * 2)
        ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + self.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, cfg: LMConfig,
         device: torch.device | str = "cpu") -> dict:
    """Random weights from ``generator`` (a CPU ``torch.Generator``), with
    the reference's distributions: N(0, 1/fan_in) projections, N(0, 0.02)
    embeddings, unit norm scales. Moved to ``device`` at the end."""
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
            "mlp": {"w_gate": nn.dense_init(g, (L,), D, cfg.d_ff, dt),
                    "w_up": nn.dense_init(g, (L,), D, cfg.d_ff, dt),
                    "w_down": nn.dense_init(g, (L,), cfg.d_ff, D, dt)},
        },
        "ln_f": nn.rmsnorm_init((), D, dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_init(g, (), D, cfg.vocab, dt)
    return _tree_map(lambda t: t.to(device), params)


def params_from_jax(np_tree: dict, cfg: LMConfig,
                    device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy float32
    arrays; bf16 passes through float32 exactly) as the port's params in
    ``cfg.dtype`` on ``device``. The two trees have the same layout."""
    return _tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            dtype=cfg.dtype, device=device), np_tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    x = params["embed"][tokens.long()][:, None, :]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    lp = params["layers"]
    for i in range(cfg.num_layers):
        layer = _tree_map(lambda t: t[i], lp)
        lcache = {k: v[i] for k, v in cache.items()}
        h = nn.rmsnorm(layer["ln1"], x)
        y, _ = nn.attn_decode_step(layer["attn"], h, lcache, pos, spec)
        x = x + y
        h = nn.rmsnorm(layer["ln2"], x)
        x = x + nn.swiglu(layer["mlp"], h)
    x = nn.rmsnorm(params["ln_f"], x)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x[:, 0, :] @ head, cache
