"""The decoder-only transformer family (dense SwiGLU or top-k MoE FFN):
its weights, the program's model built over them, and its FLOP count.

A configuration file names its sizes with the published config's keys
(``hidden_size``, ``num_attention_heads``, ...). The benchmark draws the
weights itself, from the seed, on the device, one tensor (an expert
stack: one layer of it) a call, in bf16 (the MoE router in f32, as the
port keeps it), and hands the same tensors to the program and to the
reference. ``program_params`` lays them out as ``repro_torch``'s
parameter tree, as views: nothing is copied.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def dims(cfg: dict) -> dict:
    D = int(cfg["hidden_size"])
    H = int(cfg["num_attention_heads"])
    return {"L": int(cfg["num_hidden_layers"]), "D": D, "H": H,
            "KV": int(cfg["num_key_value_heads"]), "hd": D // H,
            "F": int(cfg["intermediate_size"]), "V": int(cfg["vocab_size"]),
            "E": int(cfg.get("num_local_experts") or 0),
            "K": int(cfg.get("num_experts_per_tok") or 0)}


def vocab(cfg: dict) -> int:
    return int(cfg["vocab_size"])


def kv_dims(cfg: dict) -> int:
    """Width of one token's row of a paged KV block: layers x (K, V) x kv
    heads x head size."""
    d = dims(cfg)
    return d["L"] * 2 * d["KV"] * d["hd"]


def weight_shapes(cfg: dict) -> dict:
    """name -> (shape, dtype, fan_in or None for ones / "embed")."""
    d = dims(cfg)
    L, D, H, KV, hd, F, V, E = (d[k] for k in
                                ("L", "D", "H", "KV", "hd", "F", "V", "E"))
    bf = torch.bfloat16
    out = {"embed": ((V, D), bf, "embed"),
           "ln_f": ((D,), bf, None),
           "layers.ln1": ((L, D), bf, None),
           "layers.ln2": ((L, D), bf, None),
           "layers.wq": ((L, D, H * hd), bf, D),
           "layers.wk": ((L, D, KV * hd), bf, D),
           "layers.wv": ((L, D, KV * hd), bf, D),
           "layers.wo": ((L, H * hd, D), bf, H * hd)}
    if E:
        out.update({"layers.router": ((L, D, E), torch.float32, D),
                    "layers.w_gate": ((L, E, D, F), bf, D),
                    "layers.w_up": ((L, E, D, F), bf, D),
                    "layers.w_down": ((L, E, F, D), bf, F)})
    else:
        out.update({"layers.w_gate": ((L, D, F), bf, D),
                    "layers.w_up": ((L, D, F), bf, D),
                    "layers.w_down": ((L, F, D), bf, F)})
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = ((D, V), bf, D)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weights from ``seed``, on ``device``: projections N(0,
    1/fan_in), the embedding N(0, 0.02), norm scales 1. Drawn by a
    generator on ``device`` in the leaf's own dtype, a layer of a stack
    at a time (a (16, 8, 4096, 14336) expert stack is 48 such calls in
    all), scaled in place."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = {}
    for name, (shape, dtype, fan) in weight_shapes(cfg).items():
        if fan is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        t = torch.empty(shape, dtype=dtype, device=device)
        scale = 0.02 if fan == "embed" else 1.0 / math.sqrt(fan)
        for part in (t if t.dim() == 4 else (t,)):
            part.normal_(0.0, 1.0, generator=g).mul_(scale)
        out[name] = t
    return out


def program_api(cfg: dict, device, cache_len: int, smoke: bool = False):
    """``repro_torch``'s ``ModelAPI`` for ``cfg`` on ``device``: the
    registry's config of ``cfg['arch']`` (its SMOKE config with
    ``smoke``), cut to ``num_hidden_layers``; raises unless every width
    is the configuration's, and unless a window the program carries lies
    beyond every position a request of ``cache_len`` reaches."""
    from repro_torch.models import registry

    api = registry.build(cfg["arch"], smoke=smoke, device=device)
    pc = api.cfg
    d = dims(cfg)
    if pc.num_layers != d["L"]:
        pc = dataclasses.replace(pc, num_layers=d["L"])
        api = registry._lm_api(cfg["arch"], pc, device)
    got = {"D": pc.d_model, "H": pc.num_heads, "KV": pc.num_kv_heads,
           "hd": pc.resolved_head_dim(), "F": pc.d_ff, "V": pc.vocab,
           "E": pc.moe.num_experts if pc.moe else 0,
           "K": pc.moe.top_k if pc.moe else 0}
    want = {k: d[k] for k in got}
    if got != want:
        raise ValueError(f"{cfg['name']}: the program's {cfg['arch']} has "
                         f"{got}, the configuration {want}")
    if pc.tie_embeddings != bool(cfg["tie_word_embeddings"]) \
            or pc.rope_theta != float(cfg["rope_theta"]) \
            or pc.qkv_bias or pc.embed_scale or pc.prefix_len:
        raise ValueError(f"{cfg['name']}: the program's {cfg['arch']} is "
                         f"another model: {pc}")
    window = cfg.get("sliding_window")
    if pc.window != window and not (window is None and pc.window
                                    and pc.window >= cache_len):
        raise ValueError(f"{cfg['name']}: the program's window {pc.window} "
                         f"is not the configuration's {window} at "
                         f"cache_len {cache_len}")
    if pc.dtype != torch.bfloat16:
        raise ValueError(f"{cfg['name']}: the program runs {pc.dtype}")
    return api


def program_params(weights: dict, cfg: dict) -> dict:
    """``weights`` as the program's parameter tree (views)."""
    w = weights
    layers = {"ln1": {"scale": w["layers.ln1"]},
              "attn": {k: w[f"layers.{k}"] for k in ("wq", "wk", "wv", "wo")},
              "ln2": {"scale": w["layers.ln2"]}}
    ffn = {k: w[f"layers.{k}"] for k in ("w_gate", "w_up", "w_down")}
    if "layers.router" in w:
        layers["moe"] = dict(ffn, router=w["layers.router"])
    else:
        layers["mlp"] = ffn
    tree = {"embed": w["embed"], "layers": layers,
            "ln_f": {"scale": w["ln_f"]}}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def matmul_params(cfg: dict) -> int:
    """Weights one token's forward pass multiplies by: the attention
    projections, the FFN it runs (a MoE layer: the router and its top-k
    experts), and the output head. The embedding lookup and the norm
    scales do no product."""
    d = dims(cfg)
    D, H, KV, hd, F = d["D"], d["H"], d["KV"], d["hd"], d["F"]
    attn = D * H * hd * 2 + D * KV * hd * 2
    ffn = (D * d["E"] + d["K"] * 3 * D * F) if d["E"] else 3 * D * F
    return d["L"] * (attn + ffn) + D * d["V"]


def range_flops(cfg: dict, a: int, b: int) -> float:
    """Model FLOPs of one sequence's forward passes at positions a ..
    b-1: 2 x ``matmul_params`` a pass, plus the attention of each head
    over the positions it sees (min(p + 1, window) at position p), 2 x
    hd for the scores and 2 x hd for the weighted sum a position."""
    if b <= a:
        return 0.0
    d = dims(cfg)
    window = cfg.get("sliding_window")

    def ctx_sum(n):                   # sum of min(p + 1, w) for p < n
        if not window or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window

    return (2.0 * matmul_params(cfg) * (b - a)
            + 4.0 * d["L"] * d["H"] * d["hd"] * (ctx_sum(b) - ctx_sum(a)))
