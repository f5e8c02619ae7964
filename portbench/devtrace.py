"""The yardstick's device reading: the peaks of the card, the byte count
of the stream kernels, and the profiler's raw trace over a few megasteps.

The method is ``chip_smoke.py``'s (``_profile``): ``torch.profiler`` with
CUPTI, the raw events of ``kineto_results`` rather than
``key_averages()`` (which takes minutes over a serving run's million
operations), and a window opened by spin kernels, because the profiler
has been seen to lose the first device operations of a window late in a
process. The spins are left out of every count.
"""

from __future__ import annotations

import re

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3
#: bytes/s, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

#: the device functions of the three stream kernels
#: (``repro_torch/kernels/csrc/duplex_stream.cu``)
STREAM_KERNEL = re.compile(r"\b(duplex_kernel|quant_kernel|dequant_kernel)\b")

#: spin kernels that open the window, and their length in clock cycles
LEAD = 32
LEAD_CYCLES = 10_000

#: the harness's own host ranges carry this prefix
RANGE_PREFIX = "pb:"


def stream_bytes(page_ins: int, page_outs: int, block_tokens: int,
                 kv_dims: int) -> int:
    """Bytes the stream kernels must move, each read and each write once,
    for ``page_ins`` blocks in and ``page_outs`` out: a page-in reads the
    int8 block and its f32 row scales and writes the bf16 block; a
    page-out reads the bf16 block and writes int8 and scales. Padding
    rows of a fused call are not counted."""
    per_block = 3 * block_tokens * kv_dims + 4 * block_tokens
    return (int(page_ins) + int(page_outs)) * per_block


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class DeviceTrace:
    """A profile of the work inside its ``with`` block. After the block:
    ``device`` (name, start ns, end ns) per device operation but the
    spins; ``ranges`` (name, start ns, end ns) per host range whose name
    starts with ``RANGE_PREFIX``, on the same clock."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(LEAD):
            torch.cuda._sleep(LEAD_CYCLES)
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        self.device, self.ranges = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if name.startswith(RANGE_PREFIX):
                # a range shows on the host and, as an annotation, on
                # the device: only the host's is a range, neither is work
                if e.device_type() != DeviceType.CUDA:
                    self.ranges.append((name, start, end))
            elif e.device_type() == DeviceType.CUDA:
                if e.duration_ns() > 0 and "spin_kernel" not in name:
                    self.device.append((name, start, end))
        self._prof = None
        return False
