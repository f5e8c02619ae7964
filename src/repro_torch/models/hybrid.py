"""Zamba2 — a Mamba2 backbone with a periodically applied *shared*
attention block (arXiv:2411.15242): the port of
``repro/models/hybrid.py``, zamba2-7b and its smoke config.

Every ``attn_every``-th layer first applies the shared transformer block
(one set of weights reused at every application), then its own Mamba2
block. Layers are stacked with a leading L axis, as the reference's
``vmap`` stacks them, so its parameter tree converts leaf for leaf
(``params_from_jax``); ``runconfig.scan`` (a Python loop over the layers,
each under a checkpoint when remat is on) takes the place of
``lax.scan``, and a Python ``if`` on the static layer index the place of
its ``lax.cond``.

Decode state: the O(1) Mamba2 state of every layer (``"mamba"``: conv
window and SSM state, layers first) and one K/V ring per shared-attention
*application* (``"attn"``: 13 of them at L=81, every=6). The reference
indexes the rings with ``idx // attn_every`` on every layer and lets the
``lax.cond`` pick; past the last application that index is out of range
(JAX clamps the read and drops the write). The port touches the rings
only on the layers that apply the block.

``decode_step`` returns new Mamba leaves and writes the rings in place,
returning those same ring tensors: the serving engine keeps the non-mover
rows of the new leaves and leaves the rings alone (a non-mover's dummy
K/V lands at its row's next write position and is overwritten before any
real query reads it, the argument the dense ring rests on).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers as nn
from repro_torch.models import runconfig
from repro_torch.models import ssm
from repro_torch.models.layers import AttnSpec


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    ssm_state: int = 64
    attn_every: int = 6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_attn_apps(self) -> int:
        return len([i for i in range(self.num_layers)
                    if self.applies_attn(i)])

    def applies_attn(self, idx: int) -> bool:
        """Whether layer ``idx`` applies the shared attention block."""
        return idx % self.attn_every == self.attn_every - 1

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(num_heads=self.num_heads,
                        num_kv_heads=self.num_kv_heads,
                        head_dim=self.d_model // self.num_heads,
                        causal=True, rope_theta=self.rope_theta)

    def mamba_spec(self) -> ssm.Mamba2Spec:
        return ssm.Mamba2Spec(d_model=self.d_model, d_state=self.ssm_state,
                              dtype=self.dtype)

    def param_count(self) -> int:
        m = ssm.mamba2_param_count(self.mamba_spec())
        d, hd = self.d_model, self.d_model // self.num_heads
        shared_attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        shared = shared_attn + 3 * d * self.d_ff + 2 * d
        return (self.num_layers * (m + d) + shared
                + 2 * self.vocab * d + d)

    active_param_count = param_count


# leaves the reference keeps in f32 whatever ``dtype`` is (ssm.py:55-57)
F32_LEAVES = {("layers", "block", name) for name in ("A_log", "dt_bias",
                                                     "D")}


def init(generator: torch.Generator, cfg: HybridConfig,
         device: torch.device | str = "cpu") -> dict:
    """Random weights from ``generator``, with the reference's
    distributions. The draws run on the generator's device (a CUDA
    generator keeps the 6.8 B draws on the card); the tree is moved to
    ``device`` at the end."""
    g = generator
    L, d, dt = cfg.num_layers, cfg.d_model, cfg.dtype
    params = {
        "embed": nn.embed_init(g, cfg.vocab, d, dt),
        "layers": {"ln": nn.rmsnorm_init((L,), d, dt),
                   "block": ssm.mamba2_init(g, cfg.mamba_spec(), (L,))},
        "shared": {
            "ln1": nn.rmsnorm_init((), d, dt),
            "attn": nn.attn_init(g, (), d, cfg.attn_spec(), dt),
            "ln2": nn.rmsnorm_init((), d, dt),
            "mlp": nn.swiglu_init(g, (), d, cfg.d_ff, dt),
        },
        "ln_f": nn.rmsnorm_init((), d, dt),
        "head": nn.dense_init(g, (), d, cfg.vocab, dt),
    }
    return nn.tree_map(lambda t: t.to(device), params)


def params_from_jax(np_tree: dict, cfg: HybridConfig,
                    device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy float32
    arrays; bf16 passes through float32 exactly) as the port's params on
    ``device``: ``cfg.dtype``, except the Mamba leaves the reference keeps
    in f32 (``A_log``, ``dt_bias``, ``D``)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        dtype = torch.float32 if path in F32_LEAVES else cfg.dtype
        # a copy: the reference's arrays may be read-only
        return torch.from_numpy(np.array(tree, np.float32)).to(
            dtype=dtype, device=device)

    return walk(np_tree, ())


def _apply_shared(shared, x, spec: AttnSpec, positions):
    shared = runconfig.gather(shared)
    h = nn.rmsnorm(shared["ln1"], x)
    x = runconfig.constrain(x + nn.attn_apply(shared["attn"], h, spec,
                                              positions), ("dp", None, None))
    h = nn.rmsnorm(shared["ln2"], x)
    return x + nn.swiglu(shared["mlp"], h)


def forward(params, cfg: HybridConfig, tokens):
    """tokens: (B, S) int -> logits (B, S, V), aux (the f32 scalar 0)."""
    B, S = tokens.shape
    x = nn.embed_lookup(runconfig.gather(params["embed"]), tokens)
    spec, mspec = cfg.attn_spec(), cfg.mamba_spec()
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, scanned):
        i, layer = scanned
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        if cfg.applies_attn(i):
            x = runconfig.constrain(
                _apply_shared(params["shared"], x, spec, positions),
                ("dp", None, None))
        h = nn.rmsnorm(layer["ln"], x)
        y, _ = ssm.mamba2_apply(layer["block"], h, mspec)
        return x + y, None

    x, _ = runconfig.scan(body, x, (range(cfg.num_layers), params["layers"]))
    x = nn.rmsnorm(params["ln_f"], runconfig.constrain(x, ("dp", None, None)))
    logits = runconfig.constrain(x @ runconfig.gather(params["head"]),
                                 ("dp", None, "tp"))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: HybridConfig, batch, **_):
    logits, aux = forward(params, cfg, batch["tokens"])
    return nn.cross_entropy(logits, batch["labels"]), {"aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: HybridConfig, batch: int, cache_len: int,
               device: torch.device | str = "cpu") -> dict:
    """{"mamba": conv (L, B, K-1, C) in ``cfg.dtype`` and ssm (L, B, H, P,
    N) f32; "attn": k/v (A, B, W, KV, hd) and pos (A, B, W) int32, -1
    marking empty slots}, A = ``num_attn_apps``."""
    return {
        "mamba": ssm.mamba2_cache_init(cfg.mamba_spec(), batch,
                                       (cfg.num_layers,), device),
        "attn": nn.attn_cache_init((cfg.num_attn_apps,), batch, cache_len,
                                   cfg.attn_spec(), cfg.dtype, device),
    }


def decode_step(params, cfg: HybridConfig, cache, tokens, pos):
    """One decode step. tokens, pos: (B,). Returns (logits (B, V), cache):
    new ``"mamba"`` leaves (the input's are not written) and the input's
    ``"attn"`` rings, written in place."""
    spec, mspec = cfg.attn_spec(), cfg.mamba_spec()
    shared = params["shared"]
    x = nn.embed_lookup(runconfig.gather(params["embed"]),
                        tokens)[:, None, :]

    def body(x, scanned):
        i, layer, mcache = scanned
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        if cfg.applies_attn(i):
            app = i // cfg.attn_every
            ring = {k: v[app] for k, v in cache["attn"].items()}
            sh = runconfig.gather(shared)
            h = nn.rmsnorm(sh["ln1"], x)
            y, _ = nn.attn_decode_step(sh["attn"], h, ring, pos, spec)
            x = runconfig.constrain(x + y, ("dp", None, None))
            h = nn.rmsnorm(sh["ln2"], x)
            x = runconfig.constrain(x + nn.swiglu(sh["mlp"], h),
                                    ("dp", None, None))
        h = nn.rmsnorm(layer["ln"], x)
        y, new = ssm.mamba2_apply(layer["block"], h, mspec, mcache)
        return x + y, new

    x, mamba = runconfig.scan(
        body, x, (range(cfg.num_layers), params["layers"], cache["mamba"]))
    x = nn.rmsnorm(params["ln_f"], runconfig.constrain(x, ("dp", None, None)))
    logits = x[:, 0, :] @ runconfig.gather(params["head"])
    return logits, {"mamba": mamba, "attn": cache["attn"]}
