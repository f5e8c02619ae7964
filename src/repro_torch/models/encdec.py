"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): the port
of ``repro/models/encdec.py``, whisper-base and its smoke config.

6 encoder + 6 decoder layers at d_model 512, 8 heads, d_ff 2048, vocab
51865. The conv audio frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S, D). Sinusoidal
positions on both sides (the reference's deviation from Whisper's learned
decoder positions), no RoPE, LayerNorm with biases, QKV biases and a GELU
MLP.

Layers are stacked with a leading L axis per side, so the reference's
parameter tree converts leaf for leaf (``params_from_jax``);
``runconfig.scan`` (a Python loop over the layers, each under a
checkpoint when remat is on) takes the place of ``lax.scan``.

Serving: ``decode_step`` attends one token against the per-layer self
K/V rings, written in place (``cache_kind="ring"``), and the static cross
K/V the cache holds; ``build_cache`` fills those from an encoding. The
serving engine's cache comes from ``init_cache``, whose cross K/V are
zeros, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers as nn
from repro_torch.models import runconfig
from repro_torch.models.layers import AttnSpec


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    num_layers: int            # per side
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    dtype: torch.dtype = torch.bfloat16

    def attn_spec(self, causal: bool) -> AttnSpec:
        return AttnSpec(num_heads=self.num_heads,
                        num_kv_heads=self.num_kv_heads,
                        head_dim=self.d_model // self.num_heads,
                        causal=causal, qkv_bias=True)

    def param_count(self) -> int:
        d, hd = self.d_model, self.d_model // self.num_heads
        attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2) + 3 * d
        mlp = 2 * d * self.d_ff + self.d_ff + d
        enc = self.num_layers * (attn + mlp + 4 * d)
        dec = self.num_layers * (2 * attn + mlp + 6 * d)
        return enc + dec + self.vocab * d + 4 * d

    active_param_count = param_count


# jnp.log(10000.0): the f32 log, held as a Python float (no tensor is
# copied to the device, so a CUDA graph can capture the positions)
_LOG_BASE = float(np.log(np.float32(10000.0)))


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., ) f32 positions -> (..., dim): sin of the angles, then cos,
    all in f32 as the reference computes them."""
    # the f32 quotient, as the reference divides
    step = float(np.float32(_LOG_BASE) / np.float32(dim))
    div = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=pos.device) * step)
    ang = pos[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_positions(length: int, dim: int, offset: int = 0,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(length, dim) f32 sinusoids of positions offset .. offset+length-1."""
    return _sinusoid((torch.arange(length, device=device) + offset).float(),
                     dim)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_block_init(g, lead, cfg: EncDecConfig, causal: bool):
    return {"ln": nn.layernorm_init(lead, cfg.d_model, cfg.dtype),
            "attn": nn.attn_init(g, lead, cfg.d_model, cfg.attn_spec(causal),
                                 cfg.dtype)}


def init(generator: torch.Generator, cfg: EncDecConfig,
         device: torch.device | str = "cpu") -> dict:
    """Random weights from ``generator`` (drawn on its device, moved to
    ``device`` at the end) with the reference's distributions:
    projections N(0, 1/fan_in), embedding N(0, 0.02), biases 0, norm
    scales 1."""
    g = generator
    L, d, dt = (cfg.num_layers,), cfg.d_model, cfg.dtype

    def mlp():
        return nn.gelu_mlp_init(g, L, d, cfg.d_ff, dt)

    params = {
        "embed": nn.embed_init(g, cfg.vocab, d, dt),
        "enc_layers": {"self": _attn_block_init(g, L, cfg, False),
                       "ln_mlp": nn.layernorm_init(L, d, dt),
                       "mlp": mlp()},
        "ln_enc": nn.layernorm_init((), d, dt),
        "dec_layers": {"self": _attn_block_init(g, L, cfg, True),
                       "cross": _attn_block_init(g, L, cfg, False),
                       "ln_mlp": nn.layernorm_init(L, d, dt),
                       "mlp": mlp()},
        "ln_dec": nn.layernorm_init((), d, dt),
    }
    return nn.tree_map(lambda t: t.to(device), params)


def params_from_jax(np_tree: dict, cfg: EncDecConfig,
                    device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy float32
    arrays; bf16 passes through float32 exactly) as the port's params in
    ``cfg.dtype`` on ``device``. The two trees have the same layout."""
    return nn.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            dtype=cfg.dtype, device=device), np_tree)


# ---------------------------------------------------------------------------
# encoder, teacher-forced decoder
# ---------------------------------------------------------------------------

def _qkv(attn, h, spec: AttnSpec):
    B, S, _ = h.shape
    q = (h @ attn["wq"] + attn["bq"]).reshape(B, S, spec.num_heads,
                                              spec.head_dim)
    k = (h @ attn["wk"] + attn["bk"]).reshape(B, S, spec.num_kv_heads,
                                              spec.head_dim)
    v = (h @ attn["wv"] + attn["bv"]).reshape(B, S, spec.num_kv_heads,
                                              spec.head_dim)
    return q, k, v


def _self_attend(block, x, spec: AttnSpec):
    """x + the block's self-attention over the whole sequence, no RoPE
    (whisper uses absolute positions)."""
    B, S, _ = x.shape
    q, k, v = _qkv(block["attn"], nn.layernorm(block["ln"], x), spec)
    att = nn.attention(q, k, v, spec)
    return runconfig.constrain(x + att.reshape(B, S, -1)
                               @ block["attn"]["wo"], ("dp", None, None))


def _cross_attend(block, x, enc_k, enc_v, spec: AttnSpec):
    """x: (B, Sq, D); enc_k/enc_v: (B, Senc, KV, hd) prebuilt cross K/V."""
    B, Sq, _ = x.shape
    h = nn.layernorm(block["ln"], x)
    q = h @ block["attn"]["wq"] + block["attn"]["bq"]
    q = q.reshape(B, Sq, spec.num_heads, spec.head_dim)
    out = nn.attention(q, enc_k, enc_v,
                       dataclasses.replace(spec, causal=False))
    return runconfig.constrain(x + out.reshape(B, Sq, -1)
                               @ block["attn"]["wo"], ("dp", None, None))


def _cross_kv(block, enc_out, spec: AttnSpec):
    B, S, _ = enc_out.shape
    attn = block["attn"]
    k = (enc_out @ attn["wk"] + attn["bk"]).reshape(B, S, spec.num_kv_heads,
                                                    spec.head_dim)
    v = (enc_out @ attn["wv"] + attn["bv"]).reshape(B, S, spec.num_kv_heads,
                                                    spec.head_dim)
    return k, v


def encode(params, cfg: EncDecConfig, frames):
    """frames: (B, S_enc, D) stubbed frame embeddings -> (B, S_enc, D)."""
    _, S, D = frames.shape
    spec = cfg.attn_spec(causal=False)
    x = (frames.to(cfg.dtype)
         + sinusoid_positions(S, D, device=frames.device).to(cfg.dtype))

    def body(x, layer):
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        x = _self_attend(layer["self"], x, spec)
        h = nn.layernorm(layer["ln_mlp"], x)
        return x + nn.gelu_mlp(layer["mlp"], h), None

    x, _ = runconfig.scan(body, x, params["enc_layers"])
    return nn.layernorm(params["ln_enc"], x)


def decode_train(params, cfg: EncDecConfig, tokens, enc_out):
    """Teacher-forced decoder. tokens: (B, S_dec) -> logits."""
    S = tokens.shape[1]
    spec = cfg.attn_spec(causal=True)
    x = (nn.embed_lookup(runconfig.gather(params["embed"]), tokens)
         + sinusoid_positions(S, cfg.d_model,
                              device=tokens.device).to(cfg.dtype))

    def body(x, layer):
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        x = _self_attend(layer["self"], x, spec)
        ck, cv = _cross_kv(layer["cross"], enc_out, spec)
        x = _cross_attend(layer["cross"], x, ck, cv, spec)
        h = nn.layernorm(layer["ln_mlp"], x)
        return x + nn.gelu_mlp(layer["mlp"], h), None

    x, _ = runconfig.scan(body, x, params["dec_layers"])
    x = nn.layernorm(params["ln_dec"], x)
    return runconfig.constrain(x @ runconfig.gather(params["embed"]).T,
                               ("dp", None, "tp"))


def forward(params, cfg: EncDecConfig, tokens, frames):
    """-> logits (B, S_dec, V), aux (the f32 scalar 0)."""
    enc_out = encode(params, cfg, frames)
    logits = decode_train(params, cfg, tokens, enc_out)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def loss_fn(params, cfg: EncDecConfig, batch, **_):
    logits, aux = forward(params, cfg, batch["tokens"], batch["frames"])
    return nn.cross_entropy(logits, batch["labels"]), {"aux": aux}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: EncDecConfig, batch: int, cache_len: int, enc_len: int,
               device: torch.device | str = "cpu") -> dict:
    """{"self": k/v (L, B, W, KV, hd), pos (L, B, W) int32 with -1 marking
    empty slots; "cross_k", "cross_v": (L, B, enc_len, KV, hd) zeros}."""
    spec = cfg.attn_spec(causal=True)
    L = cfg.num_layers
    cross = (L, batch, enc_len, spec.num_kv_heads, spec.head_dim)
    return {
        "self": nn.attn_cache_init((L,), batch, cache_len, spec, cfg.dtype,
                                   device),
        "cross_k": torch.zeros(cross, dtype=cfg.dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=cfg.dtype, device=device),
    }


def build_cache(params, cfg: EncDecConfig, frames, batch: int,
                cache_len: int):
    """Encode + precompute the per-layer cross K/V (the serving
    'prefill'). Returns (cache, enc_out)."""
    enc_out = encode(params, cfg, frames)
    spec = cfg.attn_spec(causal=True)
    cache = init_cache(cfg, batch, cache_len, frames.shape[1],
                       frames.device)
    ks, vs = zip(*(_cross_kv(
        nn.tree_map(lambda t: t[i], params["dec_layers"]["cross"]),
        enc_out, spec) for i in range(cfg.num_layers)))
    return dict(cache, cross_k=torch.stack(ks),
                cross_v=torch.stack(vs)), enc_out


def decode_step(params, cfg: EncDecConfig, cache, tokens, pos):
    """One decoder token against the self rings (written in place) and
    the static cross K/V. tokens, pos: (B,). Returns (logits (B, V),
    cache)."""
    spec = cfg.attn_spec(causal=True)
    x = nn.embed_lookup(runconfig.gather(params["embed"]),
                        tokens)[:, None, :]
    x = x + _sinusoid(pos.float(), cfg.d_model)[:, None, :].to(cfg.dtype)
    # no RoPE (theta 0 sentinel); the real positions still drive the ring
    # slot and the causal mask
    nospec = dataclasses.replace(spec, rope_theta=0.0)

    def body(x, scanned):
        layer, ring, ck, cv = scanned
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        h = nn.layernorm(layer["self"]["ln"], x)
        y, _ = nn.attn_decode_step(layer["self"]["attn"], h, ring, pos,
                                   nospec)
        x = x + y
        x = _cross_attend(layer["cross"], x, ck, cv, spec)
        h = nn.layernorm(layer["ln_mlp"], x)
        return x + nn.gelu_mlp(layer["mlp"], h), None

    x, _ = runconfig.scan(body, x, (params["dec_layers"], cache["self"],
                                    cache["cross_k"], cache["cross_v"]))
    x = nn.layernorm(params["ln_dec"], x)
    return x[:, 0, :] @ runconfig.gather(params["embed"]).T, cache
