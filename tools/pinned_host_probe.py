"""When does pinned host memory that PyTorch has freed come back to the
host's MemAvailable? On one CUDA card.

Pins 24 GiB of f32 host tensors (``torch.zeros(..., pin_memory=True)``,
as ``HostOffloadAdamW.init`` allocates the optimizer's moments), streams
them to the card and back in 64 MB chunks as the host optimizer does,
frees them, then prints MemAvailable (GB, ``/proc/meminfo``) and the
caching host allocator's byte counts after each of: the ``del``, emptying
the host cache (``torch._C._host_emptyCache``), emptying the card's cache
too, a small pinned allocation, a pinned non-blocking copy, and five
seconds of waiting. ``chip_smoke.free_memory`` and ``settled_host_ram``
follow what it shows.

    python tools/pinned_host_probe.py        # ~30 s on an H100 host
"""

import gc
import json
import time

import torch

CHUNK = 1 << 24          # f32 elements: 64 MB, the host optimizer's chunk


def mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return round(int(line.split()[1]) / 1e6, 2)
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def show(what: str) -> None:
    stats = torch.cuda.host_memory_stats()
    print(json.dumps({what: mem_available_gb(), "host_allocator": {
        k: v for k, v in stats.items()
        if k in ("active_bytes.current", "allocated_bytes.current")}}),
        flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("pinned_host_probe: no CUDA device is available")
    torch.cuda.init()
    show("start")
    pinned = [torch.zeros(1 << 28, dtype=torch.float32, pin_memory=True)
              for _ in range(24)]
    show("24 GiB pinned")
    for t in pinned:
        for c in range(0, t.numel(), CHUNK):
            dev = t[c:c + CHUNK].to("cuda")
            t[c:c + CHUNK].copy_(dev * 2)
    torch.cuda.synchronize()
    show("streamed to the card and back")
    del pinned, dev
    gc.collect()
    show("deleted")
    torch._C._host_emptyCache()
    show("host cache emptied")
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    show("card's cache and host cache emptied")
    small = torch.zeros(16, pin_memory=True)
    del small
    torch._C._host_emptyCache()
    show("after a small pinned allocation")
    torch.zeros(4096, dtype=torch.int32).pin_memory().to(
        "cuda", non_blocking=True)
    torch.cuda.synchronize()
    torch._C._host_emptyCache()
    show("after a pinned non-blocking copy")
    time.sleep(5)
    show("5 s later")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
