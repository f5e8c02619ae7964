"""AdamW + cosine schedule + global-norm clipping over the port's nested
dict parameter trees (port of ``repro/optim/adamw.py``).

Moments are f32 whatever the parameters' dtype. The scalars of a step
(the step count, the schedule, ``b1 ** t``, the bias corrections, the
clip scale) are 0-d f32 tensors on the parameters' device, computed in
f32 as the reference computes them, never in Python doubles: a step
size that differs in its last bits compounds over a run. Python floats
enter as the reference's weakly typed scalars do (rounded to f32 where
they meet a tensor), and every divide is by a tensor: PyTorch's CUDA path
turns a divide by a Python scalar, and a scalar by a tensor, into a
reciprocal multiply, which is not the IEEE divide (ROADMAP Queue 3).

``adamw_update`` is out of place, as the reference's (which donates its
inputs and returns new arrays): the caller's trees are not changed. It
runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import runconfig
from repro_torch.models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_dtype: torch.dtype = torch.bfloat16   # all-reduce compression


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``peak_lr``, then a cosine to ``end_lr`` at
    ``total_steps``; ``step`` an int or a 0-d tensor (its device is the
    result's). A 0-d f32 tensor."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step)
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / _f32(max(cfg.warmup_steps, 1), step)
    frac = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
        1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves summed
    in the reference's leaf order (sorted keys)."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, in each
    leaf's dtype; the norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(
        _f32(max_norm, norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    """(lr, bc1, bc2) of optimizer step ``step`` (0-d int32, 1-based):
    the schedule and 1 - b ** t, in f32 on the step's device."""
    lr = cosine_schedule(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, t), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, t), t)
    return lr, bc1, bc2


#: elements of a leaf updated at a time (64 MB of f32 moments, the host
#: optimizer's default streaming granularity). The update is elementwise,
#: so the chunks change no value; they bound its temporaries to a few
#: chunks, where a whole leaf takes about ten f32 copies of itself
#: (paligemma-3b's stacked MLP leaf is 2.4 GB in f32)
CHUNK = 1 << 24


def chunks(n: int) -> list[slice]:
    """The slices of at most ``CHUNK`` elements that cover ``n``."""
    return [slice(s, s + CHUNK) for s in range(0, n, CHUNK)]


def update_chunk(p, g, m, v, lr, bc1, bc2, b1, b2, eps, wd,
                 out=(None, None, None)):
    """AdamW on one leaf or on equal flat slices of one: returns (p2, m2,
    v2), each written in place into its slice of ``out`` (p, m, v) where
    one is given (``m``'s may be ``m``, ``v``'s ``v``). The scalars ``b1,
    b2, eps, wd`` are Python floats (``1 - b1`` taken in a double) or 0-d
    f32 tensors (taken in f32), as the caller's reference has them; the
    operations and their order are the reference's."""
    p_out, m_out, v_out = out
    gf = g.to(torch.float32)
    m2 = torch.add(torch.mul(m, b1), torch.mul(gf, 1.0 - b1), out=m_out)
    v2 = torch.add(torch.mul(v, b2), torch.mul(torch.square(gf), 1.0 - b2),
                   out=v_out)
    update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    pf = p.to(torch.float32)
    p2 = torch.sub(pf, lr * (update + wd * pf), out=p_out)
    return (p2 if p_out is not None else p2.to(p.dtype)), m2, v2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One optimizer step, each leaf in chunks of ``CHUNK`` elements.
    Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr, bc1, bc2 = bias_corrections(cfg, step)

    def leaf(p, g, m, v):
        scalars = (lr, bc1, bc2, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
        if runconfig.is_dtensor(p):
            # a dry-run's sharded leaf: each device's shard updated whole
            # and out of place, as the reference's (a flat view would
            # gather the leaf onto every device)
            return update_chunk(p, g, m, v, *scalars)
        outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
                for t in (p, m, v)]
        flat = [t.reshape(-1) for t in (p, g, m, v, *outs)]
        for c in chunks(flat[0].numel()):
            update_chunk(*(t[c] for t in flat[:4]), *scalars,
                         out=[t[c] for t in flat[4:]])
        return tuple(outs)

    out = tree_map(leaf, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)   # tuples are leaves
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"lr": lr, "grad_norm": gnorm})
