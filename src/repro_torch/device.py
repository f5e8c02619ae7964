"""Device selection for the port's entry points.

Every entry point (``models.registry.build``, ``serve.PagedKVPool``,
``serve.ServeEngine``, ``launch.serve``) runs on ``cuda`` unless the caller
asks for the CPU by name. With no GPU present and no ``device="cpu"``,
they raise: nothing silently falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """Normalize ``device`` (default ``cuda``); raise if it names a CUDA
    device on a machine without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_device(array, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device``. A CUDA copy goes through
    pinned memory with ``non_blocking=True``, so it never waits for the
    work already queued on the stream (a pageable copy would)."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
