"""Step functions of the port over a ``ModelAPI`` (mirror of
``repro/launch/steps.py``, the serving half):

  prefill_step — full-sequence forward returning the last position's
                 argmax and f32 logits (serving prefill; a server never
                 keeps the full (B, S, V) logits)
  serve_step   — one-token decode against the KV cache, greedy

``train_step`` and ``grads_step`` come with the training slice (they
need the optimizer).
"""

from __future__ import annotations

import torch

from repro_torch.models.registry import ModelAPI


def make_prefill_step(api: ModelAPI):
    def prefill_step(params, batch):
        logits = api.forward(params, batch)
        next_logits = logits[:, -1, :].float()
        return torch.argmax(next_logits, dim=-1), next_logits

    return prefill_step


def make_serve_step(api: ModelAPI):
    def serve_step(params, cache, tokens, pos):
        logits, cache = api.decode_step(params, cache, tokens, pos)
        return torch.argmax(logits.float(), dim=-1), cache

    return serve_step
