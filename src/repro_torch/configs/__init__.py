"""Architecture configs of the port (one module per arch) + lookup helpers.

Mirror of ``repro/configs/__init__.py``; only the dense decoder the serving
slice runs (smollm-135m) is ported so far.
"""

import importlib

# arch-id -> module name
_MODULES = {
    "smollm-135m": "smollm_135m",
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
