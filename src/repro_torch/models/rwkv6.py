"""RWKV6 "Finch": the attention-free LM of ``repro/models/rwkv6.py``
(arXiv:2404.05892), rwkv6-7b and its smoke config.

Per layer: a time-mix block (token-shift lerps for r/k/v/w/g, a LoRA'd
data-dependent decay w_t, a per-head WKV state S (hs x hs) updated as
S <- diag(w_t) S + k_t^T v_t, with bonus u on the current token) and a
channel-mix block (token-shifted squared-ReLU MLP).

Layers are stacked with a leading L axis, as the reference's ``vmap``
stacks them, so its parameter tree converts leaf for leaf
(``params_from_jax``); projections are (in, out) and the model computes
``x @ W``; ``runconfig.scan`` (a Python loop over the layers, each
under a checkpoint when remat is on) takes the place of ``lax.scan``.

Where the WKV recurrence runs:
  * ``forward`` / ``loss_fn`` (prefill, loss evaluation): through
    ``kernels.ops.wkv6`` — the CUDA kernel on the card, launched once per
    layer, and ``kernels/ref.py::wkv6`` on the CPU. ``use_kernel=False``
    runs the model's plain ``wkv_scan`` instead (the tests and the card's
    comparison use it).
  * ``decode_step``: the one-step recurrence with the state in and out,
    through ``wkv_scan``, as in the reference. The kernel starts from a
    zero state and returns no final state (as does the Pallas kernel), so
    the reference never runs it in decode either.

``decode_step`` returns new cache leaves and leaves its input untouched:
the serving engine keeps the rows that did not move (any token advances a
recurrent state irreversibly).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as nn
from repro_torch.models import runconfig


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    name: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_size: int = 64
    decay_lora: int = 64
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_size

    def param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        time_mix = 5 * d * d + 5 * d + d + 2 * self.decay_lora * d + d
        chan_mix = d * f + f * d + d * d + 2 * d
        per_layer = time_mix + chan_mix + 4 * d
        return self.num_layers * per_layer + 2 * self.vocab * d + 2 * d

    active_param_count = param_count


# leaves the reference keeps in f32 whatever ``dtype`` is
F32_LEAVES = (("layers", "tm", "w0"), ("layers", "tm", "u"))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked(L: int, shape: tuple, dtype, device, draw) -> torch.Tensor:
    """An (L, *shape) tensor on ``device``, filled one layer at a time
    from ``draw()`` (f32 on the generator's device), so no full-depth f32
    temporary ever exists."""
    out = torch.empty((L, *shape), dtype=dtype, device=device)
    for i in range(L):
        out[i].copy_(draw())
    return out


def init(generator: torch.Generator, cfg: RWKVConfig,
         device: torch.device | str = "cpu") -> dict:
    """Random weights from ``generator``, drawn on the generator's device
    (a CUDA generator keeps the 7.5 B draws on the card) layer by layer,
    with the reference's distributions: token-shift ``mu`` U(0, 1), decay
    bias ``w0`` -6 (f32), projections N(0, 1/fan_in), bonus ``u``
    0.5 N(0, 1) (f32), channel-mix lerps 0.5, embedding N(0, 0.02),
    layernorm scale 1 and bias 0."""
    g = generator
    gdev = g.device
    L, d, f, dt = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.dtype
    H, hs, rank = cfg.num_heads, cfg.head_size, cfg.decay_lora

    def normal(*shape, scale):
        return torch.randn(shape, generator=g, device=gdev) * scale

    def dense(i, o):
        return _stacked(L, (i, o), dt, device,
                        lambda: normal(i, o, scale=1.0 / math.sqrt(i)))

    def full(shape, value, dtype):
        return torch.full((L, *shape), value, dtype=dtype, device=device)

    tm = {"mu": _stacked(L, (5, d), dt, device,
                         lambda: torch.rand((5, d), generator=g,
                                            device=gdev)),
          "w0": full((d,), -6.0, torch.float32),
          "w_a": dense(d, rank), "w_b": dense(rank, d),
          "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
          "wg": dense(d, d), "wo": dense(d, d),
          "u": _stacked(L, (H, hs), torch.float32, device,
                        lambda: normal(H, hs, scale=0.5))}
    cm = {"mu_k": full((d,), 0.5, dt), "mu_r": full((d,), 0.5, dt),
          "wk": dense(d, f), "wv": dense(f, d), "wr": dense(d, d)}
    layers = {"ln1": nn.layernorm_init((L,), d, dt, device), "tm": tm,
              "ln2": nn.layernorm_init((L,), d, dt, device), "cm": cm}
    return {
        "embed": normal(cfg.vocab, d, scale=0.02).to(dtype=dt,
                                                      device=device),
        "ln_in": nn.layernorm_init((), d, dt, device),
        "layers": layers,
        "ln_f": nn.layernorm_init((), d, dt, device),
        "head": normal(d, cfg.vocab, scale=1.0 / math.sqrt(d)).to(
            dtype=dt, device=device),
    }


def params_from_jax(np_tree: dict, cfg: RWKVConfig,
                    device: torch.device | str = "cpu") -> dict:
    """The reference's parameter tree (nested dicts of numpy float32
    arrays; bf16 passes through float32 exactly) as the port's params on
    ``device``: ``cfg.dtype``, except the leaves the reference keeps in
    f32 (``tm.w0``, ``tm.u``)."""
    def conv(path, a):
        dtype = torch.float32 if path in F32_LEAVES else cfg.dtype
        # a copy: the reference's arrays may be read-only
        return torch.from_numpy(np.array(a, np.float32)).to(
            dtype=dtype, device=device)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return conv(path, tree)

    return walk(np_tree, ())


# ---------------------------------------------------------------------------
# WKV scan (the plain version of kernels/rwkv6_scan.py)
# ---------------------------------------------------------------------------

def wkv_scan(r, k, v, w, u, state=None):
    """r, k, v, w: (B, S, H, hs) f32 (w in (0, 1)); u: (H, hs).

    Returns (out (B, S, H, hs), final state (B, H, hs, hs)). State S[i, j]
    accumulates k[i] v[j]; out_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i]
    v_t[j]). A Python loop over time, in f32."""
    B, S, H, hs = r.shape
    if state is None:
        state = torch.zeros((B, H, hs, hs), dtype=torch.float32,
                            device=r.device)
    uu = u[..., :, None]
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B, H, hs, hs)
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + uu * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def _token_shift(x, last=None):
    """x_{t-1} with x_{-1} = last (or 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _time_mix(tm, x, cfg: RWKVConfig, shifted, state,
              use_kernel: bool = True):
    """Returns (y, new wkv state). With no ``state`` and ``use_kernel``
    the recurrence goes through ``kernels.ops.wkv6`` (zero state, no
    final state: the new state is None)."""
    B, S, d = x.shape
    H, hs = cfg.num_heads, cfg.head_size
    delta = shifted - x
    mu = tm["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + delta * mu[i] for i in range(5))
    r = (xr @ tm["wr"]).reshape(B, S, H, hs).float()
    k = (xk @ tm["wk"]).reshape(B, S, H, hs).float()
    v = (xv @ tm["wv"]).reshape(B, S, H, hs).float()
    g = F.silu((xg @ tm["wg"]).float())
    # data-dependent decay (LoRA): w in (0, 1), near 1 for w0 very negative
    dd = (xw @ tm["w_a"]) @ tm["w_b"]
    w = torch.exp(-torch.exp(tm["w0"].float() + dd.float()))
    w = w.reshape(B, S, H, hs)
    if state is None and use_kernel:
        # imported here: kernels.ref imports this module
        from repro_torch.kernels import ops as kernel_ops
        out, new_state = kernel_ops.wkv6(r, k, v, w, tm["u"], chunk=S), None
    else:
        out, new_state = wkv_scan(r, k, v, w, tm["u"], state)
    out = (out.reshape(B, S, d) * g).to(x.dtype)
    return out @ tm["wo"], new_state


def _channel_mix(cm, x, shifted):
    delta = shifted - x
    xk = x + delta * cm["mu_k"]
    xr = x + delta * cm["mu_r"]
    k = torch.square(torch.relu((xk @ cm["wk"]).float()))
    r = torch.sigmoid((xr @ cm["wr"]).float())
    return (r * (k.to(x.dtype) @ cm["wv"]).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# forward (prefill / loss evaluation)
# ---------------------------------------------------------------------------

def forward(params, cfg: RWKVConfig, tokens, use_kernel: bool = True):
    """tokens: (B, S) int -> logits (B, S, V), aux (the f32 scalar 0).

    Any S: the recurrence takes the whole sequence as one chunk."""
    x = nn.layernorm(params["ln_in"], nn.embed_lookup(
        runconfig.gather(params["embed"]), tokens))

    def body(x, layer):
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        h = nn.layernorm(layer["ln1"], x)
        y, _ = _time_mix(layer["tm"], h, cfg, _token_shift(h), None,
                         use_kernel)
        x = runconfig.constrain(x + y, ("dp", None, None))
        h = nn.layernorm(layer["ln2"], x)
        return x + _channel_mix(layer["cm"], h, _token_shift(h)), None

    x, _ = runconfig.scan(body, x, params["layers"])
    x = nn.layernorm(params["ln_f"], runconfig.constrain(x, ("dp", None,
                                                             None)))
    logits = runconfig.constrain(x @ runconfig.gather(params["head"]),
                                 ("dp", None, "tp"))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: RWKVConfig, batch, **_):
    logits, aux = forward(params, cfg, batch["tokens"])
    return nn.cross_entropy(logits, batch["labels"]), {"aux": aux}


# ---------------------------------------------------------------------------
# decode: O(1) state per layer
# ---------------------------------------------------------------------------

def init_cache(cfg: RWKVConfig, batch: int, cache_len: int = 0,
               device: torch.device | str = "cpu") -> dict:
    """State, layers stacked first: wkv (L, B, H, hs, hs) f32 and the
    time-mix and channel-mix shift tokens (L, B, d). ``cache_len`` is
    unused: the state does not grow with the sequence."""
    H, hs, d, L = cfg.num_heads, cfg.head_size, cfg.d_model, cfg.num_layers
    return {
        "wkv": torch.zeros((L, batch, H, hs, hs), dtype=torch.float32,
                           device=device),
        "tm_last": torch.zeros((L, batch, d), dtype=cfg.dtype, device=device),
        "cm_last": torch.zeros((L, batch, d), dtype=cfg.dtype, device=device),
    }


def decode_step(params, cfg: RWKVConfig, cache, tokens, pos=None):
    """One decode step. tokens: (B,) int; ``pos`` is unused. Returns
    (logits (B, V), new cache); ``cache`` itself is not written."""
    x = nn.layernorm(params["ln_in"], nn.embed_lookup(
        runconfig.gather(params["embed"]), tokens))[:, None, :]

    def body(x, scanned):
        layer, wkv_s, tm_last, cm_last = scanned
        x = runconfig.constrain(x, ("dp", None, None))
        layer = runconfig.gather(layer)
        h = nn.layernorm(layer["ln1"], x)
        y, new_wkv = _time_mix(layer["tm"], h, cfg,
                               tm_last[:, None, :].to(h.dtype), wkv_s)
        x = runconfig.constrain(x + y, ("dp", None, None))
        h2 = nn.layernorm(layer["ln2"], x)
        x = x + _channel_mix(layer["cm"], h2,
                             cm_last[:, None, :].to(h2.dtype))
        return x, (new_wkv, h[:, 0], h2[:, 0])

    x, (wkv, tm_last, cm_last) = runconfig.scan(
        body, x, (params["layers"], cache["wkv"], cache["tm_last"],
                  cache["cm_last"]))
    x = nn.layernorm(params["ln_f"], runconfig.constrain(x, ("dp", None,
                                                             None)))
    logits = x[:, 0, :] @ runconfig.gather(params["head"])
    return logits, {"wkv": wkv, "tm_last": tm_last, "cm_last": cm_last}
