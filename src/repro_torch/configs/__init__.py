"""Architecture configs of the port (one module per arch) + lookup helpers.

Mirror of ``repro/configs/__init__.py``, in its order, all ten archs:
the dense decoders smollm-135m (serving, prefill, loss), stablelm-3b,
qwen2.5-14b, llama3.2-3b and paligemma-3b (prefill, loss; the SMOKE
configs serve too), the MoE decoders mixtral-8x7b and kimi-k2-1t-a32b
(paged serving, prefill, loss), rwkv6-7b and zamba2-7b (serving,
prefill, loss) and whisper-base (serving, encode, teacher-forced decode,
loss).
"""

import importlib

# arch-id -> module name
_MODULES = {
    "smollm-135m": "smollm_135m",
    "stablelm-3b": "stablelm_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "llama3.2-3b": "llama3_2_3b",
    "rwkv6-7b": "rwkv6_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "whisper-base": "whisper_base",
    "zamba2-7b": "zamba2_7b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_MODULES)


def config_module(arch_id: str):
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}"
                       ) from None
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, smoke: bool = False):
    mod = config_module(arch_id)
    return mod.SMOKE if smoke else mod.FULL
