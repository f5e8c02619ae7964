"""Step functions of the port over a ``ModelAPI`` (mirror of
``repro/launch/steps.py``):

  train_step   — fwd + bwd + grad cast to ``grad_dtype`` (bf16 by
                 default: the reference's collective compression) + AdamW
  grads_step   — fwd + bwd only (host-offloaded-optimizer archs: the
                 update streams moments through the duplex engine outside
                 the step)
  prefill_step — full-sequence forward returning the last position's
                 argmax and f32 logits (serving prefill; a server never
                 keeps the full (B, S, V) logits)
  serve_step   — one-token decode against the KV cache, greedy

Gradients come from ``torch.autograd.grad`` over the parameter leaves;
a leaf the loss does not reach gets zeros, as ``jax.grad`` gives it.
"""

from __future__ import annotations

import torch

from repro_torch.models import runconfig
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import AdamWConfig, adamw_update

# archs that train with the optimizer in the host pool (capacity story)
HOST_OPTIMIZER = frozenset({"kimi-k2-1t-a32b"})


def value_and_grad(loss_fn, params, batch, grad_dtype: torch.dtype):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: loss and
    metrics detached, grads a tree like ``params`` cast to
    ``grad_dtype``."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = list(tree_leaves(leaves))
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    metrics = tree_map(lambda m: m.detach(), metrics)
    return loss.detach(), metrics, tree_unflatten(
        leaves, (g.to(grad_dtype) for g in grads))


def make_train_step(api: ModelAPI, optim: AdamWConfig | None = None):
    optim = optim or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, _metrics, grads = value_and_grad(api.loss_fn, params, batch,
                                               optim.grad_dtype)
        params, opt_state, om = adamw_update(optim, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_grads_step(api: ModelAPI, optim: AdamWConfig | None = None):
    optim = optim or AdamWConfig()

    def grads_step(params, batch):
        loss, _metrics, grads = value_and_grad(api.loss_fn, params, batch,
                                               optim.grad_dtype)
        return grads, {"loss": loss}

    return grads_step


def make_prefill_step(api: ModelAPI):
    def prefill_step(params, batch):
        logits = api.forward(params, batch)
        # whole rows for the argmax (a no-op outside a dry-run's shard env)
        next_logits = runconfig.constrain(logits[:, -1, :].float(),
                                          ("dp", None))
        return torch.argmax(next_logits, dim=-1), next_logits

    return prefill_step


def make_serve_step(api: ModelAPI):
    def serve_step(params, cache, tokens, pos):
        logits, cache = api.decode_step(params, cache, tokens, pos)
        logits = runconfig.constrain(logits.float(), ("dp", None))
        return torch.argmax(logits, dim=-1), cache

    return serve_step
