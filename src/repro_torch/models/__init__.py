"""Model zoo of the port: the ten architectures of ``repro_torch.configs``
(dense and MoE decoders, RWKV6, the Zamba2 hybrid, the Whisper
encoder-decoder) behind a uniform ModelAPI."""

from repro_torch.models.registry import (
    ModelAPI, SHAPES, LONG_CONTEXT_OK, FAMILY, build, input_specs,
    runnable, skip_reason, cells,
)
