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

The dry-run's shape cells (``SHAPES``; ``runnable``, ``skip_reason``,
``cells``) and its stand-ins: ``param_shapes`` (the parameter tree's
shapes and dtypes, from ``init`` under ``FakeTensorMode``, once per
config) and ``input_specs`` (fake tensors for a cell's step inputs):

  train_4k     seq 4,096   gbatch 256   -> train_step
  prefill_32k  seq 32,768  gbatch 32    -> serve prefill (full forward)
  decode_32k   seq 32,768  gbatch 128   -> serve_step (1 token, 32k cache)
  long_500k    seq 524,288 gbatch 1     -> serve_step; SSM/SWA/hybrid only
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, layers, rwkv6, transformer
from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.hybrid import HybridConfig
from repro_torch.models.rwkv6 import RWKVConfig
from repro_torch.models.transformer import LMConfig

class ShapeCell(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs whose decode state stays bounded at 500k tokens
LONG_CONTEXT_OK = frozenset({"rwkv6-7b", "mixtral-8x7b", "zamba2-7b"})

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


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------

def runnable(arch_id: str, shape: str) -> bool:
    """Whether this (arch x shape) cell is assigned to run."""
    if shape == "long_500k":
        return arch_id in LONG_CONTEXT_OK
    return True


def skip_reason(arch_id: str, shape: str) -> str | None:
    if runnable(arch_id, shape):
        return None
    return ("full-attention arch: O(S^2) prefill / unbounded KV at 500k; "
            "run only for SSM/SWA/hybrid archs per assignment")


def cells(shapes: tuple[str, ...] = tuple(SHAPES)) -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells, in table order."""
    return [(a, s) for a in configs_lib.ARCH_IDS for s in shapes
            if runnable(a, s)]


# ---------------------------------------------------------------------------
# stand-ins (fake tensors; nothing allocated)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A leaf's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple
    dtype: torch.dtype


@functools.lru_cache(maxsize=None)
def _param_shapes(arch_id: str, cfg) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    init = {LMConfig: transformer.init, RWKVConfig: rwkv6.init,
            HybridConfig: hybrid.init, EncDecConfig: encdec.init}[type(cfg)]
    with FakeTensorMode():
        params = init(torch.Generator(), cfg=cfg, device="cpu")
    return layers.tree_map(
        lambda t: TensorSpec(tuple(t.shape), t.dtype), params)


def param_shapes(api: ModelAPI) -> dict:
    """The parameter tree of ``api.init`` as ``TensorSpec`` leaves: init
    run once per config under ``FakeTensorMode`` (the draws give fake
    tensors; kimi-k2's expert stacks skip their per-matrix draws) and
    kept for the process."""
    return _param_shapes(api.arch_id, api.cfg)


def fake_like(tree, mode=None):
    """Fake tensors of ``tree``'s ``TensorSpec`` shapes and dtypes in
    ``mode`` (a ``FakeTensorMode``; a new one if None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = mode or FakeTensorMode()
    with mode:
        return layers.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype), tree)


def input_specs(api: ModelAPI, shape_name: str,
                batch_override: int | None = None, mode=None) -> dict:
    """Inputs for the cell's step function, as fake tensors (in ``mode``,
    a ``FakeTensorMode``; a new one if None) on the api's device.

    train/prefill: {"tokens", "labels"[, "frames"|"prefix_embeds"]}
    decode: {"cache", "tokens", "pos"}, the cache from ``init_cache``
    under fake mode (no allocation)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cell = SHAPES[shape_name]
    B = batch_override or cell.global_batch
    S = cell.seq_len
    cfg = api.cfg
    tok = torch.int32
    mode = mode or FakeTensorMode()
    with mode:
        def sds(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=api.device)

        if cell.kind in ("train", "prefill"):
            specs: dict[str, Any] = {"tokens": sds((B, S), tok)}
            if cell.kind == "train":
                specs["labels"] = sds((B, S), tok)
            if api.family == "audio":
                specs["frames"] = sds((B, S, cfg.d_model), torch.bfloat16)
            if api.family == "vlm":
                specs["prefix_embeds"] = sds((B, cfg.prefix_len,
                                              cfg.d_model), torch.bfloat16)
            return specs
        # decode: one new token against a seq_len-deep cache
        return {"cache": api.init_cache(B, S), "tokens": sds((B,), tok),
                "pos": sds((B,), tok)}
