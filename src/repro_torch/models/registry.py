"""Model registry — uniform API over the port's architectures.

Mirror of ``repro/models/registry.py`` for the decoder-only
transformer (``_lm_api``: smollm-135m, stablelm-3b, qwen2.5-14b,
llama3.2-3b, paligemma-3b with its prefix-LM prefix, and the MoE
configs mixtral-8x7b and kimi-k2-1t-a32b), RWKV6 (``_rwkv_api``:
rwkv6-7b), the Mamba2 hybrid (``_hybrid_api``: zamba2-7b) and the
encoder-decoder (``_encdec_api``: whisper-base):
``build(arch_id, smoke=, device=)`` returns a ``ModelAPI`` whose members
close over the arch config and the device. The dense, hybrid and
encoder-decoder ``forward`` and ``loss_fn`` run the chunked plain
attention, as the reference's do; RWKV6's run the WKV recurrence through
``kernels.ops.wkv6`` (the CUDA kernel for a CUDA tensor).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, rwkv6, transformer
from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.hybrid import HybridConfig
from repro_torch.models.rwkv6 import RWKVConfig
from repro_torch.models.transformer import LMConfig

FAMILY = {"smollm-135m": "dense", "stablelm-3b": "dense",
          "qwen2.5-14b": "dense", "llama3.2-3b": "dense", "rwkv6-7b": "ssm",
          "mixtral-8x7b": "moe", "kimi-k2-1t-a32b": "moe",
          "whisper-base": "audio", "zamba2-7b": "hybrid",
          "paligemma-3b": "vlm"}


class ModelAPI(NamedTuple):
    arch_id: str
    family: str
    cfg: Any
    device: torch.device
    init: Callable                # (torch.Generator) -> params on device
    loss_fn: Callable             # (params, batch) -> (loss, metrics)
    forward: Callable             # (params, batch) -> logits
    init_cache: Callable          # (batch, cache_len) -> cache on device
    decode_step: Callable         # (params, cache, tokens, pos) -> (logits, cache)
    param_count: int
    active_param_count: int
    # "ring": every cache leaf is token-indexed (a K/V ring overwrites a
    # stale entry before it is read), and ``decode_step`` writes the cache
    # in place; "recurrent": the cache carries state that any decode_step
    # advances irreversibly (RWKV wkv state and shift tokens, Mamba conv
    # window and SSM state), and ``decode_step`` returns those as new
    # leaves without writing its input, so the engine can keep the rows
    # that did not move; a ring it writes in place (zamba2's shared
    # attention) it returns as the same tensor, which the engine leaves
    # alone.
    cache_kind: str = "ring"


def _lm_api(arch_id: str, cfg: LMConfig,
            device: torch.device | str = "cuda") -> ModelAPI:
    dev = resolve_device(device)

    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)

    def fwd(params, batch):
        logits, _ = transformer.forward(params, cfg, batch["tokens"],
                                        batch.get("prefix_embeds"))
        return logits

    return ModelAPI(
        arch_id=arch_id, family=FAMILY.get(arch_id, "dense"), cfg=cfg,
        device=dev,
        init=functools.partial(transformer.init, cfg=cfg, device=dev),
        loss_fn=loss, forward=fwd,
        init_cache=lambda batch, cache_len: transformer.init_cache(
            cfg, batch, cache_len, dev),
        decode_step=lambda params, cache, tokens, pos: transformer.
        decode_step(params, cfg, cache, tokens, pos),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
    )


def _rwkv_api(arch_id: str, cfg: RWKVConfig,
              device: torch.device | str = "cuda") -> ModelAPI:
    dev = resolve_device(device)
    return ModelAPI(
        arch_id=arch_id, family="ssm", cfg=cfg, device=dev,
        init=functools.partial(rwkv6.init, cfg=cfg, device=dev),
        loss_fn=lambda params, batch: rwkv6.loss_fn(params, cfg, batch),
        forward=lambda params, batch: rwkv6.forward(
            params, cfg, batch["tokens"])[0],
        init_cache=lambda batch, cache_len: rwkv6.init_cache(
            cfg, batch, cache_len, dev),
        decode_step=lambda params, cache, tokens, pos: rwkv6.decode_step(
            params, cfg, cache, tokens, pos),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        cache_kind="recurrent",
    )


def _hybrid_api(arch_id: str, cfg: HybridConfig,
                device: torch.device | str = "cuda") -> ModelAPI:
    dev = resolve_device(device)
    return ModelAPI(
        arch_id=arch_id, family="hybrid", cfg=cfg, device=dev,
        init=functools.partial(hybrid.init, cfg=cfg, device=dev),
        loss_fn=lambda params, batch: hybrid.loss_fn(params, cfg, batch),
        forward=lambda params, batch: hybrid.forward(
            params, cfg, batch["tokens"])[0],
        init_cache=lambda batch, cache_len: hybrid.init_cache(
            cfg, batch, cache_len, dev),
        decode_step=lambda params, cache, tokens, pos: hybrid.decode_step(
            params, cfg, cache, tokens, pos),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        cache_kind="recurrent",
    )


def _encdec_api(arch_id: str, cfg: EncDecConfig,
                device: torch.device | str = "cuda") -> ModelAPI:
    dev = resolve_device(device)

    def cache_init(batch, cache_len):
        # the cross K/V sized to cache_len, as the reference sizes it
        return encdec.init_cache(cfg, batch, cache_len, enc_len=cache_len,
                                 device=dev)

    return ModelAPI(
        arch_id=arch_id, family="audio", cfg=cfg, device=dev,
        init=functools.partial(encdec.init, cfg=cfg, device=dev),
        loss_fn=lambda params, batch: encdec.loss_fn(params, cfg, batch),
        forward=lambda params, batch: encdec.forward(
            params, cfg, batch["tokens"], batch["frames"])[0],
        init_cache=cache_init,
        decode_step=lambda params, cache, tokens, pos: encdec.decode_step(
            params, cfg, cache, tokens, pos),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
    )


def build(arch_id: str, smoke: bool = False,
          device: torch.device | str = "cuda") -> ModelAPI:
    """The arch's ``ModelAPI`` on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``; raises on a machine with no GPU)."""
    cfg = configs_lib.get_config(arch_id, smoke=smoke)
    if isinstance(cfg, LMConfig):
        return _lm_api(arch_id, cfg, device)
    if isinstance(cfg, RWKVConfig):
        return _rwkv_api(arch_id, cfg, device)
    if isinstance(cfg, HybridConfig):
        return _hybrid_api(arch_id, cfg, device)
    if isinstance(cfg, EncDecConfig):
        return _encdec_api(arch_id, cfg, device)
    raise TypeError(f"unknown config type {type(cfg)} for {arch_id}")
