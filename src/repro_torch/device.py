"""Device selection for the port's entry points.

Every entry point (``models.registry.build``, ``serve.PagedKVPool``,
``serve.ServeEngine``, ``launch.serve``) runs on ``cuda`` unless the caller
asks for the CPU by name. With no GPU present and no ``device="cpu"``,
they raise: nothing silently falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import traceback
import warnings
from collections import Counter
from pathlib import Path

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


@contextlib.contextmanager
def _sync_sites():
    sites: Counter = Counter()

    def on_warning(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if "repro_torch" in f.filename]
        frames = own[-1:] if own else stack[-3:]
        sites[" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                         for f in reversed(frames))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def sync_watch():
    """Count the device-to-host syncs raised while the block runs
    (``torch.cuda.set_sync_debug_mode("warn")``), each charged to the
    innermost frame of the port's own code on the stack when it was
    raised. Yields a ``Counter`` of those sites; when the block ends,
    what switching the watch on raises by itself is taken off it."""
    with _sync_sites() as alone:
        pass
    with _sync_sites() as sites:
        yield sites
    sites.subtract(alone)
    for site in [s for s, n in sites.items() if n <= 0]:
        del sites[site]
