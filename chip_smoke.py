"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version on the card (``flash_attention`` also at head dims
80 and 112, which no model of the port runs yet, timed at a stablelm-3b
and a kimi-k2 prefill shape), records beside the short kernels the
device time of an empty kernel launched at the same geometry (the launch
floor), and drives two serving paths at full
width (smollm-135m: 30 layers, d_model 576, vocab 49152; random seeded
weights), the full-sequence forward of three models and the serving of
rwkv6-7b, each with the launch counters set to 0 just before it and
read just after:

  * the main path: LLM decode through the duplex-paged KV pool, the
    engine replaying CUDA graphs of its steps, every request token for
    token against the port's static-batch ``reference_decode``; it must
    launch the three duplex-stream kernels. The same requests are then
    served with the eager megastep and with the graphs in turns (eager,
    graphs, graphs, eager; ``megastep_turns``), each run with the main
    run's tokens, launches and stats, and one more run of each is
    profiled (``profile_serving``: busy share, device operations and
    wall ms per decode step, by mode);
  * the tenant path: the same decode co-served with a KV-store tenant and
    a vector-search tenant that share the pool, the paging transaction and
    the admission queue; LLM tokens exact, tenant data checked against
    its seeds and a brute-force scan, the withdrawn scope
    (``/serve/redis/read_heavy``) never fused, and all four kernels
    (``l2_distance`` too) launched; then the eager megastep on the same
    requests, which must serve and page the same;
  * the forward path: ``forward`` / ``loss_fn`` / ``prefill`` /
    ``make_prefill_step`` of smollm-135m FULL (B=4, S=2048) and
    paligemma-3b FULL (18 layers, hd 256; B=2, 256 stub patch embeddings
    as the prefix-LM prefix and 256 text tokens) under
    ``inference_mode``; ``use_kernel=True`` must launch the
    ``flash_attention`` kernel once per layer and agree with the plain
    forward, and prefill then decode must continue the full forward;
  * the RWKV forward path: ``forward`` / ``loss_fn`` /
    ``make_prefill_step`` of rwkv6-7b FULL (32 layers, d_model 4096,
    d_ff 14336, vocab 65536, 64 heads of 64; B=2, S=4096), which must
    launch the ``wkv6`` kernel once per layer and agree with the plain
    forward (logits gated in f32, against a control fault);
  * the tiered path: the main path's requests beside a KV-store tenant on
    a host tier of two DDR5 and two CXL channels (``TIER_SPEC``), graphed
    then eager: the same host-deterministic readings, every request the
    main path's tokens, boundary migrations (``check_invariants`` after
    each), page-ins and page-outs on all four channels, ``tier_speedup``
    above 1, the three stream kernels launched, no host sync in the
    graphed run, every store block holding its value; every
    stream shape the tiered and fault runs hand a kernel is held against
    the plain version after them;
  * the fault path: the same run under ``FAULT_PLAN`` (a degraded and a
    flaky CXL channel, a poisoned block, the other CXL channel offline)
    and under one ``random_plan`` schedule, each graphed then eager: the
    same survivors, failed records and fault stats, survivors token-exact,
    every evacuated row byte-equal to its value before the move, each
    store block its value or lost to a fault;
  * the traced path: the tiered run and the fault-plan run again with
    the tracing plane on (``EngineConfig(trace=True)``), in turns with
    untraced runs: the same tokens, stats, paging, tier and fault stats
    and kernel launches, no host sync, every channel track's
    modelled-clock intervals monotonic and disjoint, its totals and
    ``duplex_util`` equal to the CPU rehearsal's (``TRACE_EXPECT``), and
    the Perfetto export under ``build/`` read back;
  * the simulator path: ``core.scheduler`` at the JAX package's simulator
    benchmarks' sizes (the LLM prefill and decode A/Bs, the microbenchmark
    sweep, the characterization cross-check on every preset, all six
    policies on the decode mix), each replayed from CUDA graphs of its
    steps with no host sync, held against the same simulation on the CPU
    (a subprocess started first, ``--cpu-sims``) and, for the six
    policies, against its eager steps on the card bit for bit;
  * the RWKV serving path: rwkv6-7b FULL through ``ServeEngine`` with
    paging gated off by its recurrent cache, on the step graphs, every
    request token for token against ``reference_decode``, then with the
    eager megastep, which must serve the same.

Each serving path prints its engine's graph count (``graphs <path>:``)
and capture seconds (``graph_capture_s <path>:``) on lines of their own.

The last line of its output is a JSON
object ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the line before that the per-kernel
measurements as JSON (one row per kernel of the paths, at the shape the
path hands it; ``flash_attention_widths`` and
``flash_attention_paligemma`` are lines of their own). Any failed check
raises and exits non-zero. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published rates (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

# the serving run: smollm-135m FULL, an oversubscribed pool so blocks page
# both ways (about 18 MB of HBM blocks, 24 MB of int8 host tier).
SERVE = dict(max_batch=8, cache_len=256, block_tokens=16, hbm_blocks=48,
             megastep=8, pipeline_depth=2, prefill_chunk=4)
N_REQUESTS, PROMPT_LEN, GEN, ARRIVAL_EVERY = 16, 64, 64, 2

# the tenant path: a smaller LLM batch co-served with both tenants in an
# oversubscribed pool (40 HBM blocks of (16, 11520) bf16, about 15 MB; the
# tenants reserve 10), so LLM KV, the store and the dataset page both ways
TENANT_SERVE = dict(max_batch=4, cache_len=256, block_tokens=16,
                    hbm_blocks=40, megastep=8, pipeline_depth=2,
                    prefill_chunk=4)
TENANT_LLM_REQUESTS, TENANT_GEN, TENANT_STEPS = 8, 32, 48

# the tiered path: the main path's requests at the main path's SERVE
# config, on a host tier of two half-duplex DDR5 and two full-duplex CXL
# channels (256 host slots of (16, 11520) int8, about 47 MB), beside a
# KV-store tenant whose sequential streams prefer DDR5 and whose gaussian
# stream, like the LLM's /serve/kv_cache, prefers CXL: blocks change
# tiers and migrate at the boundaries. LLM decode alone would send every
# block to CXL (no migration, both DDR5 channels idle), as in the
# reference.
TIER_SPEC = "ddr5:2,cxl:2"
TIER_KV = dict(n_slots=2, ops_per_step=2, store_blocks=32)
TIER_STREAMS = (("sequential", "read"), ("sequential", "write"),
                ("gaussian", None))
TIER_STEPS = 48
# the fault path: the same run under a plan in which every recoverable
# kind fires on the run's transaction clock (~172 transactions): a CXL
# channel at half bandwidth, transient errors on the other, a poisoned
# block that has a host copy by transaction 60, and the second CXL
# channel offline at 80 with live rows; then one seeded chaos schedule
# (``random_plan``) over the same run
FAULT_PLAN = ("degrade:2@10+40=0.5,transient:3@20+60=0.3,poison:40@60,"
              "offline:3@80")
FAULT_SEED = 0
CHAOS_SEED, CHAOS_HORIZON, CHAOS_EVENTS = 3, 160, 4
# the traced tiered and fault-plan runs' modelled clock: horizon and per
# channel busy / read / write shares, predicted by a CPU rehearsal at the
# full width's byte counts (host arithmetic, so the card must agree)
TRACE_KEYS = ("util", "rd_util", "wr_util", "busy_us", "read_bytes",
              "write_bytes", "txns")
TRACE_EXPECT = {
    "tiered": {"model_us": 1444.234, "duplex_util": {
        "cxl:2": dict(zip(TRACE_KEYS, (0.5817, 0.3948, 0.3191, 840.096,
                                     36495360.0, 29491200.0, 82))),
        "cxl:3": dict(zip(TRACE_KEYS, (0.5725, 0.3869, 0.3111, 826.848,
                                     35758080.0, 28753920.0, 82))),
        "ddr5:0": dict(zip(TRACE_KEYS, (0.252, 0.0957, 0.1449, 363.942,
                                     8847360.0, 13271040.0, 51))),
        "ddr5:1": dict(zip(TRACE_KEYS, (0.2553, 0.0917, 0.149, 368.677,
                                     8478720.0, 13639680.0, 49))),
    }},
    "faults": {"model_us": 2841.801, "duplex_util": {
        "cxl:2": dict(zip(TRACE_KEYS, (0.5208, 0.3162, 0.2959, 1480.032,
                                     56401920.0, 50135040.0, 94))),
        "cxl:3": dict(zip(TRACE_KEYS, (0.4399, 0.0993, 0.075, 1249.968,
                                     18063360.0, 13639680.0, 41))),
        "ddr5:0": dict(zip(TRACE_KEYS, (0.1492, 0.0608, 0.0818, 424.1,
                                     11059200.0, 14745600.0, 58))),
        "ddr5:1": dict(zip(TRACE_KEYS, (0.1538, 0.0608, 0.0839, 436.935,
                                     11059200.0, 15114240.0, 55))),
    }},
}

# the simulator path: the JAX package's simulator benchmarks rebuilt here
# (benchmarks/llm_inference.py, microbench.py, characterization.py) at
# their full sizes
SIM_RATIOS = (0.1, 0.3, 0.5, 0.7, 0.9)
SIM_POLICIES = ("cfs", "ddr_batching", "round_robin", "threshold",
                "timeseries", "hinted")
# the CPU tests' tolerances (tests/test_torch_scheduler.py says why): the
# summaries of a run, and of a lockstep run (identical phased streams
# under timeseries, where last-bit differences hand a run slot to another
# identical stream)
SIM_SUMMARY_RTOL, SIM_LOCKSTEP_RTOL = 1e-5, 5e-4
SIM_TIMED = "llm/decode/hinted"      # the case timed graphed and eager
SIM_EAGER = (SIM_TIMED, "llm/decode/cfs")   # also stepped eagerly
SIM_BLOCKS = (8, 16, 64)           # graph block sizes timed on it

STREAMS = ("duplex_kv_stream", "quant_stream", "dequant_stream")
# the shape each serving kernel is handed most often on its path (the
# paging schedule is host-deterministic; l2_distance as Q,N,T,D). The
# kernel rows are measured at these before any CUDA graph is captured:
# after the serving paths' graphs, the profiler recorded one profile of
# a ctypes kernel and then nothing (PERF.md). main() fails if
# a path's most common shape is another.
PATH_SHAPES = {"duplex_kv_stream": (4, 16, 11520),
               "quant_stream": (1, 16, 11520),
               "dequant_stream": (4, 16, 11520),
               "l2_distance": (4, 2, 16, 11520)}

# what each kernel replaces in the JAX package (the pallas_call line)
REPLACES = {
    "duplex_kv_stream": "src/repro/kernels/duplex_stream.py:157",
    "quant_stream": "src/repro/kernels/duplex_stream.py:111",
    "dequant_stream": "src/repro/kernels/duplex_stream.py:93",
    "l2_distance": "src/repro/kernels/vector_distance.py:50",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:70",
}

# flash_attention against ref.attention on the card, at the reference's
# tolerances (tests/test_kernels.py:36-48): atol = rtol = 3e-2 in bf16
# (both round P to bf16 before P.V: the kernel's tensor-core body, 64-row
# q and kv tiles), 2e-5 in f32 (the kernel's CUDA-core body, a different
# body). (B, S, H, KV, hd, dtype, mask keywords)
FLASH_CHECKS = [
    (4, 2048, 9, 3, 64, torch.bfloat16, {}),                 # smollm path
    (2, 512, 8, 1, 256, torch.bfloat16, {"prefix_len": 256}),  # paligemma
    (1, 256, 2, 1, 64, torch.bfloat16, {"prefix_len": 160}),
    (1, 256, 2, 1, 64, torch.bfloat16, {"window": 64, "prefix_len": 32}),
    (2, 256, 4, 2, 64, torch.float32, {}),
    (1, 256, 2, 2, 64, torch.bfloat16, {"window": 96}),
    (1, 128, 2, 2, 64, torch.bfloat16, {"causal": False}),
    (1, 256, 4, 4, 128, torch.bfloat16, {}),
    # both path shapes in f32, where 2e-5 holds; this runs the CUDA-core
    # body, not the one the models run in bf16 (see FLASH_PATH)
    (4, 2048, 9, 3, 64, torch.float32, {}),
    (2, 512, 8, 1, 256, torch.float32, {"prefix_len": 256}),
    # edges of the tensor-core design: a ragged last q and kv tile (200 is
    # 3 x 64 + 8), GQA with 8 q heads on one kv head at hd 128, and a
    # prefix that ends inside the second 64-row q tile at hd 256
    (2, 200, 4, 2, 64, torch.bfloat16, {}),
    (1, 256, 8, 1, 128, torch.bfloat16, {}),
    (1, 256, 2, 1, 256, torch.bfloat16, {"prefix_len": 96}),
    # head dims 80 (stablelm-3b) and 112 (kimi-k2, zamba2-7b) in both
    # bodies: their path shapes, a ragged S, and a prefix that ends inside
    # the second q tile
    (1, 2048, 32, 32, 80, torch.bfloat16, {}),
    (1, 2048, 64, 8, 112, torch.bfloat16, {}),
    (1, 2048, 32, 32, 80, torch.float32, {}),
    (1, 2048, 64, 8, 112, torch.float32, {}),
    (2, 200, 4, 2, 80, torch.bfloat16, {}),
    (2, 200, 4, 2, 80, torch.float32, {}),
    (1, 200, 4, 1, 112, torch.bfloat16, {"window": 40}),
    (1, 200, 4, 1, 112, torch.float32, {"window": 40}),
    (1, 256, 2, 1, 80, torch.bfloat16, {"prefix_len": 96}),
    (1, 256, 2, 1, 80, torch.float32, {"prefix_len": 96}),
    (1, 256, 2, 1, 112, torch.bfloat16, {"prefix_len": 96}),
    (1, 256, 2, 1, 112, torch.float32, {"prefix_len": 96}),
]

# the tensor-core body at the path shapes, held tighter than 3e-2, which
# is about the size of |o| itself in the last rows at S = 2048 (~0.03):
# in every 64-query block of each (batch, head), the kernel's max abs
# error against ref.attention may exceed that of one
# scaled_dot_product_attention call on the same inputs (which rounds P to
# bf16 too) by at most FLASH_TC_ULPS bf16 ulps of the block's largest
# |o|. A control, ref.attention with the last 64 queries losing their
# first 64 keys (a window of S - 64: one kv tile), must break it.
FLASH_PATH = {(4, 2048, 9, 3, 64), (2, 512, 8, 1, 256), (1, 2048, 32, 32, 80),
              (1, 2048, 64, 8, 112)}
# the head dims no model of the port runs, timed at a path shape of a
# config of the repo that has them (causal prefill, S = 2048):
# stablelm-3b (d_model 2560, 32 heads of 80) and kimi-k2 (64 heads of 112
# on 8 kv heads)
FLASH_WIDTHS = [("stablelm-3b", (1, 2048, 32, 32, 80)),
                ("kimi-k2-1t", (1, 2048, 64, 8, 112))]
FLASH_TC_ULPS = 1

# the forward path: (arch, batch, sequence); paligemma's first 256
# positions are the stub patch embeddings, then 256 text tokens
FORWARD_RUNS = [("smollm-135m", 4, 2048), ("paligemma-3b", 2, 512)]
DECODE_STEPS = 4
# stated in PERF.md before the first full run: the loss with the
# kernel against the plain forward, relative; and the logits of prefill
# then decode against the full plain forward, absolute
LOSS_RTOL = 1e-3
DECODE_ATOL = 0.1
# the whole-model logits with the kernel against the plain forward,
# absolute. On an H100 (PERF.md) the kernel was 0.0586 (smollm) and
# 0.0957 (paligemma) off, and the plain forward with a mask fault
# 0.39-7.4 off; the loss cannot tell them apart. Each run checks again
# that its control fault exceeds the limit.
LOGITS_ATOL = 0.25
# the rwkv6-7b logits with the kernel against the plain forward, absolute,
# with the weights in f32 (rwkv_f32_logits). On an H100 (PERF.md) the
# kernel was 3.7e-4 off and the control 8.27; in bf16 the kernel was 1.04
# off, and so was the plain forward against itself with its output sum
# reordered (1.06): bf16 rounding noise, grown through 32 layers, is as
# large as a fault there.
RWKV_LOGITS_ATOL = 5e-3
# profiler device time against CUDA-event stream time (measure_flash)
FLASH_EVENT_SHARE = 0.10
# rounds of the paired timings (paired_profile) that measure_flash and
# measure_wkv6 take, of which the median is kept: one profile of SDPA came
# back at half its time (PERF.md)
TIMING_ROUNDS = 3
# clock cycles of the spin kernel that holds the stream while timed calls
# queue behind it (paired_profile): ~25 ms, longer than the host takes to
# queue any timed run
HOLD_CYCLES = 50_000_000
# wkv6 against ref.wkv6 on the card, at the reference's atol = rtol = 1e-4
# (tests/test_kernels.py:107): (B, S, H, hs, draw w and u as the model
# does). The reference's four shapes, ragged S (1000 and 77 are no
# multiple of the kernel's 32- and 16-step chunks), hs 128, and the
# rwkv6-7b prefill shape.
WKV_CHECKS = [
    (2, 256, 2, 32, False), (1, 128, 4, 64, False), (2, 64, 1, 16, False),
    (1, 192, 3, 32, False), (2, 1000, 3, 64, False), (1, 77, 2, 128, True),
    (2, 4096, 64, 64, True),
]
WKV_TOL = 1e-4
# the RWKV forward path: rwkv6-7b FULL at (batch, sequence); 4096 is the
# published context length of the RWKV-6 World models
RWKV_FORWARD = (2, 4096)
# the control fault: the plain forward with its WKV state reset every
# RWKV_RESET tokens, which is what a kernel that dropped its carry across
# chunks would compute
RWKV_RESET = 128
# the RWKV serving path: rwkv6-7b FULL through ServeEngine (paging gated
# off by cache kind); staggered arrivals put decoding rows beside
# chunk-prefilling ones
RWKV_SERVE = dict(max_batch=4, cache_len=64, megastep=8, pipeline_depth=2,
                  prefill_chunk=4)
RWKV_REQUESTS, RWKV_PROMPT, RWKV_GEN = 8, 32, 16
# kernel instances whose -Xptxas -v report must show no spills: the
# tensor-core flash body at every head dim, wkv6 at the path's hs, and the
# stream kernels' 16-byte path (<1>), held to 64 registers by their launch
# bounds so that two blocks fit an SM (duplex_stream.WAVE_BLOCKS)
NO_SPILL = {"flash_kernel_tc<64>", "flash_kernel_tc<80>",
            "flash_kernel_tc<112>", "flash_kernel_tc<128>",
            "flash_kernel_tc<256>", "wkv6_kernel<64>", "duplex_kernel<1>",
            "quant_kernel<1>", "dequant_kernel<1>"}
# an empty kernel, launched at a kernel's grid, block, cluster and dynamic
# shared memory: its device time is the floor under any one launch of
# that geometry (launch_floor_ms). Built from this string into build/.
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(int blocks, int threads, int cluster, int smem,
                            void* stream) {
  cudaFuncAttributes fattr;
  cudaError_t err = cudaFuncGetAttributes(&fattr, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
"""
# spin kernels that open each profiler window, and how many profiles
# device_events takes before it gives up
PROFILE_LEAD = 32
PROFILE_TRIES = 5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` by CUDA events over back-to-back calls
    from the host, launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, iters: int,
             held: bool = False) -> tuple[Counter, Counter, float | None]:
    """One profile of ``iters`` calls of ``fn``: per kind of device
    operation (kernel, copy or memset; host-side runtime calls are left
    out), its count and device ns. Reads the raw trace events:
    ``key_averages()`` takes minutes over the million operations of a
    serving run. ``held``: the calls are also timed by CUDA events in
    the same window, queued behind a spin kernel that holds the stream,
    so the events time the card running them back to back and not the
    host's launch rate, and both clocks time the same runs of the calls;
    the third value is that stream ms per call (else None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # late in a process the profiler has been seen to lose the first
        # few device operations of a window (PERF.md): open it with spin
        # kernels, which the counts leave out
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if held:
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
        for _ in range(iters):
            fn()
        if held:
            end.record()
        torch.cuda.synchronize()
    count, ns = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and "spin_kernel" not in e.name():
            count[e.name()] += 1
            ns[e.name()] += e.duration_ns()
    return count, ns, start.elapsed_time(end) / iters if held else None


def _whole_profile(fn, iters: int, warmup: int, per_call: dict | None,
                   held: bool) -> tuple[Counter, Counter, float | None]:
    """A profile of ``iters`` calls of ``fn`` taken as measured (``_profile``).

    The profiler has been seen to drop device events (PERF.md), so
    a profile is taken as measured only when every kind of operation in
    it ran a whole number of times per call, each name-substring of
    ``per_call`` matched that many operations per call, and an earlier
    such profile saw the same operations; otherwise the profile is taken
    again. Fails after PROFILE_TRIES profiles without such a pair."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kept, seen = [], []
    for _ in range(PROFILE_TRIES):
        count, ns, stream_ms = _profile(fn, iters, held)
        seen.append(sum(count.values()))
        whole = bool(count) and all(n % iters == 0 for n in count.values())
        named = all(sum(n for k, n in count.items() if sub in k)
                    == want * iters for sub, want in (per_call or {}).items())
        if whole and named and count in kept:
            return count, ns, stream_ms
        if whole and named:
            kept.append(count)
    fail(f"the profiler did not see the same whole calls twice in "
         f"{PROFILE_TRIES} "
         f"profiles of {iters} calls (operations seen: {seen}; last: "
         f"{dict(count)}, per call wanted {per_call})")


def device_events(fn, iters: int = 20, warmup: int = 1,
                  per_call: dict | None = None) -> list:
    """The work the profiler saw run on the card over ``iters`` calls of
    ``fn``, as (name, count, device µs) per kind of device operation
    (``_whole_profile``)."""
    count, ns, _ = _whole_profile(fn, iters, warmup, per_call, held=False)
    return [(k, count[k], ns[k] / 1e3) for k in count]


def median(timer, *args, **kwargs):
    """The median of TIMING_ROUNDS calls of ``timer(*args, **kwargs)``:
    a time, or a tuple that leads with one."""
    return sorted(timer(*args, **kwargs)
                  for _ in range(TIMING_ROUNDS))[TIMING_ROUNDS // 2]


def device_profile(fn, iters: int = 20, warmup: int = 1,
                   per_call: dict | None = None) -> tuple[float, float]:
    """Per call of ``fn``: device ms and the count of device operations."""
    rows = device_events(fn, iters, warmup, per_call)
    return (sum(us for _, _, us in rows) / 1e3 / iters,
            sum(n for _, n, _ in rows) / iters)


def paired_profile(fn, iters: int, warmup: int = 1,
                   per_call: dict | None = None) -> tuple[float, float, float]:
    """Per call of ``fn``: device ms by the profiler, the count of device
    operations, and stream ms by CUDA events over the same calls in the
    same window, queued behind a held stream (``_profile(held=True)``).
    The two times come from one run of the calls, so a change of the
    card's speed between two timings cannot part them: one run read wkv6
    at 0.470 ms by the profiler against 0.600 ms by events taken after
    it (PERF.md)."""
    count, ns, stream_ms = _whole_profile(fn, iters, warmup, per_call,
                                          held=True)
    return (sum(ns.values()) / 1e6 / iters, sum(count.values()) / iters,
            stream_ms)


def floor_source() -> Path:
    """FLOOR_SOURCE written under build/, where the kernel libraries are
    built (``_build.build`` keys its library by the source's bytes)."""
    from repro_torch.kernels import _build
    path = _build.BUILD_DIR.parent / "launch_floor.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists() or path.read_text() != FLOOR_SOURCE:
        path.write_text(FLOOR_SOURCE)
    return path


@functools.cache
def _floor_lib():
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load(floor_source())
    lib.empty_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def launch_floor_ms(blocks: int, threads: int, cluster: int = 1,
                    smem: int = 0) -> float:
    """Device ms, by the profiler, of an empty kernel launched at this
    grid, block, cluster and dynamic shared memory: no launch of that
    geometry takes less."""
    import ctypes
    lib = _floor_lib()

    def fn():
        rc = lib.empty_launch(blocks, threads, cluster, smem, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            fail(f"the empty kernel did not launch at {blocks} x {threads}, "
                 f"cluster {cluster}, {smem} bytes: error {rc}")
    return device_profile(fn, per_call={"empty_kernel": 1})[0]


def stream_inputs(n: int, t: int, d: int, seed: int):
    """(in_q, in_scale, out_x) on the card, from a seeded CPU generator."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(seed)
    in_q, in_scale = ref.quantize_int8(torch.randn((n, t, d), generator=g))
    out_x = torch.randn((n, t, d), generator=g).to(torch.bfloat16)
    return tuple(x.cuda() for x in (in_q, in_scale, out_x))


def compare(name, got, want) -> float:
    """Hold one kernel's outputs against the plain version's: bf16
    dequantized rows exactly equal, f32 scales within rtol 1e-6, int8
    within 1 LSB. Returns the largest absolute difference."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16 and not torch.equal(g, w):
            fail(f"{name}: dequantized rows differ from the plain version")
        if g.dtype == torch.float32 and not torch.allclose(
                g, w, rtol=1e-6, atol=0.0):
            fail(f"{name}: scales differ beyond rtol 1e-6")
        diff = (g.float() - w.float()).abs().max().item() if g.numel() else 0
        if g.dtype == torch.int8 and diff > 1:
            fail(f"{name}: int8 codes differ by {diff} LSB (limit 1)")
        worst = max(worst, diff)
    return worst


def check_kernels(shapes) -> None:
    """Every kernel (and fused=False) against its plain version, and the
    page-out codes of rows that divide by their scale to exact
    half-integers (on the 16-byte path and on the element path), where
    rounding half to even decides every code."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import ops, ref
    halves = torch.arange(-126, 127, dtype=torch.float32) + 0.5
    row = torch.cat([halves, torch.tensor([127.0, -127.0])]).repeat(2, 16, 4)
    for x in (row, torch.nn.functional.pad(row, (0, 4))):
        x = x.to(torch.bfloat16).cuda().contiguous()
        want = ref.quantize_int8(x)
        got = ds.quant_stream(x)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"quant_stream rounds an exact tie unlike the plain version "
                 f"at D = {x.shape[-1]}")
    for i, (n, t, d) in enumerate(shapes):
        in_q, in_scale, out_x = stream_inputs(n, t, d, seed=i)
        want = ref.duplex_kv_stream(in_q, in_scale, out_x)
        compare("duplex_kv_stream", ds.duplex_kv_stream(in_q, in_scale,
                                                        out_x), want)
        compare("fused=False", ops.duplex_kv_stream(
            in_q, in_scale, out_x, fused=False), want)
        compare("quant_stream", ds.quant_stream(out_x), want[1:])
        compare("dequant_stream", (ds.dequant_stream(in_q, in_scale),),
                want[:1])
        torch.cuda.synchronize()
        print(f"kernels match the plain versions at N,T,D = {n},{t},{d}",
              flush=True)


def measure(name: str, shape) -> dict:
    """Time one kernel and its plain version at ``shape``, with the bound
    for this work. ``ms``/``plain_ms`` are device time from the profiler;
    ``call_ms``/``plain_call_ms`` are CUDA-event times of back-to-back
    calls, host launch cost included. Inputs are warm in L2, as the
    serving path leaves them after its gather. No single PyTorch call
    computes this quantizer, so there is no library time.
    ``launch_floor_ms`` is an empty kernel's device time at the same
    launch geometry (``ds.geometry``)."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import ref
    n, t, d = shape
    in_q, in_scale, out_x = stream_inputs(n, t, d, seed=99)
    rows = n * t
    if name == "duplex_kv_stream":
        fn = lambda: ds.duplex_kv_stream(in_q, in_scale, out_x)
        plain = lambda: ref.duplex_kv_stream(in_q, in_scale, out_x)
        nbytes = rows * (6 * d + 8)
        ops = rows * d * 8          # 1 (dequant) + ~7 (abs, max, div, rint,
                                    # 2 clamps, convert) per element pair
    elif name == "quant_stream":
        fn = lambda: ds.quant_stream(out_x)
        plain = lambda: ref.quantize_int8(out_x)
        nbytes = rows * (3 * d + 4)
        ops = rows * d * 7
    else:
        fn = lambda: (ds.dequant_stream(in_q, in_scale),)
        plain = lambda: (ref.dequantize_int8(in_q, in_scale),)
        nbytes = rows * (3 * d + 4)
        ops = rows * d
    err = compare(name, fn(), plain())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    call_ms, plain_call_ms = cuda_ms(fn), cuda_ms(plain)
    geo = ds.geometry(rows, d, 2 if name == "duplex_kv_stream" else 1)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/duplex_stream.cu",
            "replaces": REPLACES[name], "shape": [n, t, d],
            "max_abs_err": err,
            "ms": device_profile(fn)[0], "plain_ms": device_profile(plain)[0],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "launch_floor_ms": launch_floor_ms(geo["blocks"], ds.THREADS),
            "geometry": geo}


def l2_inputs(q: int, n: int, t: int, d: int, seed: int):
    """(queries f32, blocks bf16) on the card, from a seeded CPU
    generator."""
    g = torch.Generator().manual_seed(seed)
    queries = torch.randn((q, d), generator=g)
    blocks = torch.randn((n, t, d), generator=g).to(torch.bfloat16)
    return queries.cuda(), blocks.cuda()


def compare_l2(got, want, where: str) -> float:
    """The reference's tolerance (tests/test_kernels.py:174-175): rtol
    1e-4, atol 1e-3 against the direct sum of squares. Returns the
    largest absolute difference."""
    if got.shape != want.shape or not torch.allclose(got, want, rtol=1e-4,
                                                     atol=1e-3):
        fail(f"l2_distance differs from the plain version at {where}")
    return (got - want).abs().max().item()


def check_l2(shapes) -> None:
    """The l2_distance kernel against its plain version at (Q, N, T, D),
    and the zero distance of a query to the stored vector it equals."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vector_distance as vd
    for i, (q, n, t, d) in enumerate(shapes):
        queries, blocks = l2_inputs(q, n, t, d, seed=100 + i)
        err = compare_l2(vd.l2_distance(queries, blocks),
                         ref.l2_distance(queries, blocks), (q, n, t, d))
        torch.cuda.synchronize()
        print(f"l2_distance matches the plain version at Q,N,T,D = "
              f"{q},{n},{t},{d} (max abs err {err:.3g})", flush=True)
    for d in (64, 11520):
        _, blocks = l2_inputs(1, 2, 8, d, seed=d)
        dist = ops.l2_distance(blocks[1, 3][None].float(), blocks)
        if not (dist[1, 0, 3] == dist.min() and dist[1, 0, 3] <= 1e-2):
            fail(f"l2_distance: a query equal to a stored vector (D={d}) "
                 f"is at {dist[1, 0, 3].item()}, the minimum is "
                 f"{dist.min().item()}")
    print("l2_distance: zero distance to self at D = 64 and 11520",
          flush=True)


def measure_l2(shape) -> dict:
    """Time the l2_distance kernel and its plain version at (Q, N, T, D),
    with the bound for this work: bytes N*T*D*2 + Q*D*4 + N*Q*T*4 (each
    input read once, the output written once) against the f32 FMA work
    2*N*T*D*(Q+1). No single PyTorch call computes squared L2 from bf16
    blocks, so there is no library time. ``launch_floor_ms`` is an empty
    kernel's device time at the same launch geometry (``vd.geometry``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import vector_distance as vd
    q, n, t, d = shape
    queries, blocks = l2_inputs(q, n, t, d, seed=99)
    fn = lambda: vd.l2_distance(queries, blocks)
    plain = lambda: ref.l2_distance(queries, blocks)
    err = compare_l2(fn(), plain(), shape)
    t_bytes = (n * t * d * 2 + q * d * 4 + n * q * t * 4) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * t * d * (q + 1) / FP32_OPS_PER_S * 1e3
    call_ms, plain_call_ms = cuda_ms(fn), cuda_ms(plain)
    geo = vd.geometry(q, n, t, d)
    return {"name": "l2_distance", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/vector_distance.cu",
            "replaces": REPLACES["l2_distance"], "shape": [q, n, t, d],
            "max_abs_err": err,
            "ms": device_profile(fn)[0], "plain_ms": device_profile(plain)[0],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "launch_floor_ms": launch_floor_ms(
                geo["blocks"], vd.THREADS, geo["cluster"], geo["smem_bytes"]),
            "geometry": geo}


def flash_inputs(B, S, H, KV, hd, dtype, seed: int):
    """(q, k, v) on the card in the reference's layout, N(0, 1) from a
    seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((B, S, KV, hd), generator=g)
    v = torch.randn((B, S, KV, hd), generator=g)
    return tuple(x.to(dtype).cuda() for x in (q, k, v))


def compare_flash(got, want, where) -> float:
    """The reference's tolerance: atol = rtol = 3e-2 in bf16, 2e-5 in f32.
    Returns the largest absolute difference."""
    tol = 3e-2 if want.dtype == torch.bfloat16 else 2e-5
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
        fail(f"flash_attention differs from the plain version at {where}")
    return (got.float() - want.float()).abs().max().item()


def check_flash() -> None:
    """The flash_attention kernel against ref.attention at every shape of
    FLASH_CHECKS (f32 products in the plain version: TF32 off), and the
    reference's divisibility contract on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (B, S, H, KV, hd, dtype, mask) in enumerate(FLASH_CHECKS):
        q, k, v = flash_inputs(B, S, H, KV, hd, dtype, seed=200 + i)
        where = f"B,S,H,KV,hd = {B},{S},{H},{KV},{hd} {dtype} {mask}"
        got = fa.flash_attention(q, k, v, **mask)
        want = ref.attention(q, k, v, **mask)
        err = compare_flash(got, want, where)
        torch.cuda.synchronize()
        print(f"flash_attention matches the plain version at {where} "
              f"(max abs err {err:.3g})", flush=True)
        if dtype == torch.bfloat16 and (B, S, H, KV, hd) in FLASH_PATH:
            check_flash_blocks(q, k, v, mask, got, want, where)
    q, k, v = flash_inputs(1, 200, 2, 2, 64, torch.bfloat16, seed=0)
    try:
        ops.flash_attention(q, k, v)
    except ValueError as e:
        print(f"flash_attention refuses S=200 on the card: {e}", flush=True)
    else:
        fail("flash_attention accepted S=200 with 128-blocks")


def check_flash_blocks(q, k, v, mask, got, want, where) -> None:
    """The kernel's output ``got`` at a path shape against FLASH_TC_ULPS:
    per 64-query block of each (batch, head), its max abs error against
    ``want`` (ref.attention) less SDPA's, in bf16 ulps of the block's
    largest |want|, and the same for the control (a window of S - 64),
    which must exceed the limit."""
    from repro_torch.kernels import ref
    B, S, H, hd = q.shape
    blocks = lambda x: x.float().view(B, S // 64, 64, H, hd).amax((2, 4))
    top = blocks(want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126)))
                     - 7)
    lib_err = blocks((sdpa_call(q, k, v, mask)().transpose(1, 2).float()
                      - want.float()).abs())
    control = ref.attention(q, k, v, **{**mask, "window": S - 64})
    over, control_over = (
        ((blocks((x.float() - want.float()).abs()) - lib_err) / ulp)
        .max().item() for x in (got, control))
    print(f"flash_attention at {where}, per 64-query block: max abs error "
          f"beyond SDPA's {over:.3g} bf16 ulps of the block's largest |o| "
          f"(limit {FLASH_TC_ULPS}; control {control_over:.3g})",
          flush=True)
    if not over <= FLASH_TC_ULPS:
        fail(f"flash_attention at {where}: a 64-query block's error is "
             f"{over} bf16 ulps beyond SDPA's (limit {FLASH_TC_ULPS})")
    if not control_over > FLASH_TC_ULPS:
        fail(f"flash_attention at {where}: the control (a window of "
             f"S - 64) is {control_over} ulps beyond SDPA's, within the "
             f"limit {FLASH_TC_ULPS}: the check cannot see one lost tile")


def sdpa_call(q, k, v, mask: dict):
    """One call of PyTorch's ``scaled_dot_product_attention`` (the
    yardstick, which the port never calls) on q, k, v in the reference's
    layout: ``is_causal=True`` for a causal mask, else ``attn_mask`` =
    ``visible_mask``; ``enable_gqa``. Returns the call, whose output is
    (B, H, S, hd)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if mask:
        attn_mask = torch.from_numpy(visible_mask(q.shape[1],
                                                  **mask)).cuda()
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)


def visible_mask(S: int, causal=True, window=None, prefix_len=0):
    """The (query, key) pairs the model's mask keeps for one (batch, head),
    as an (S, S) bool array: ``layers._mask_bias``'s rule."""
    qi = np.arange(S)[:, None]
    kj = np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis = (kj <= qi) | ((prefix_len > 0) & (kj < prefix_len))
    if window is not None:
        vis &= kj > qi - window
    return vis


def measure_flash(shape, mask: dict) -> dict:
    """Time the flash_attention kernel, its plain version and one call of
    PyTorch's ``scaled_dot_product_attention`` (``sdpa_call``) on the
    same tensors at (B, S, H, KV, hd) in bf16, by the profiler's device time, with the
    bound of this work: visible pairs x 4 hd FLOP against 989 TFLOP/s
    bf16 on tensor cores, where the kernel runs both products, and q, k,
    v and o once against 3.35 TB/s (``bound_ms``; ``bound_ms_f32`` is the
    same work against 67 TFLOP/s f32 on CUDA cores, the floor of the
    kernel's f32 body).

    The times are checked, not taken on trust (each the median
    of TIMING_ROUNDS ``paired_profile``s): the kernel must be the one
    device operation of its call, and its device time must agree with
    CUDA events over the same calls queued behind a held stream within
    FLASH_EVENT_SHARE (``call_ms`` records back-to-back calls from the
    host, launch cost included, for comparison); the plain version
    and SDPA must agree with ``ref.attention`` within the reference's
    tolerance; all three must reach no less than ``bound_ms`` and take no
    more device time than stream time (within FLASH_EVENT_SHARE)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, S, H, KV, hd = shape
    q, k, v = flash_inputs(B, S, H, KV, hd, torch.bfloat16, seed=99)
    vis = visible_mask(S, **mask)
    lib = sdpa_call(q, k, v, mask)
    fn = lambda: fa.flash_attention(q, k, v, **mask)
    plain = lambda: ref.attention(q, k, v, **mask)
    want = plain()
    err = compare_flash(fn(), want, shape)
    lib_err = compare_flash(lib().transpose(1, 2), want, f"{shape}, SDPA")
    pairs = B * H * int(vis.sum())
    flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    bound_f32 = max(t_bytes, flops / FP32_OPS_PER_S * 1e3)
    ms, per_call, ev_kernel = median(paired_profile, fn, iters=10,
                                     per_call={"flash_kernel": 1})
    plain_ms, _, ev_plain = median(paired_profile, plain, iters=5)
    lib_ms, _, ev_lib = median(paired_profile, lib, iters=10)
    if per_call != 1:
        fail(f"flash_attention at {shape}: {per_call} device operations "
             f"per call, want 1")
    ev = {"kernel": ev_kernel, "plain": ev_plain, "SDPA": ev_lib}
    call_ms = cuda_ms(fn, iters=10)
    print(f"flash_attention at {shape} {mask}: device ms (profiler) / "
          f"stream ms (CUDA events, stream held): kernel {ms:.4f} / "
          f"{ev['kernel']:.4f}, plain {plain_ms:.4f} / {ev['plain']:.4f}, "
          f"SDPA {lib_ms:.4f} / {ev['SDPA']:.4f}; back-to-back calls from "
          f"the host {call_ms:.4f}", flush=True)
    if abs(ms - ev["kernel"]) > FLASH_EVENT_SHARE * ev["kernel"]:
        fail(f"flash_attention at {shape}: the profiler's {ms} ms and the "
             f"CUDA events' {ev['kernel']} ms differ by more than "
             f"{FLASH_EVENT_SHARE:.0%}")
    for name, t in (("kernel", ms), ("plain", plain_ms), ("SDPA", lib_ms)):
        if t < bound or t > (1 + FLASH_EVENT_SHARE) * ev[name]:
            fail(f"flash_attention at {shape}: {name} {t} ms by the "
                 f"profiler is below its bound {bound} ms or above its "
                 f"stream time {ev[name]} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": REPLACES["flash_attention"], "shape": list(shape),
            "mask": mask, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "event_ms": ev["kernel"], "call_ms": call_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32": bound_f32, "sdpa_ratio": ms / lib_ms,
            "visible_pairs": pairs, "flop": flops, "bytes": nbytes,
            "library_ms": lib_ms, "library_max_abs_err": lib_err}


def forward_phase(arch: str, B: int, S: int) -> dict:
    """The forward path of ``arch`` FULL (random weights from a seed) on
    the card under ``inference_mode``: ``forward`` with the kernel must
    launch it once per layer and without it never; layer 0's attention,
    kernel against plain, within 3e-2; the logits within LOGITS_ATOL,
    which a control (the plain forward with a mask fault) must exceed;
    the loss with and without the kernel within LOSS_RTOL; one forward
    profiled (device time, the kernel's share, one kernel launch per
    layer seen by the profiler); ``prefill`` then DECODE_STEPS
    ``decode_step``s against the full plain forward within DECODE_ATOL;
    ``make_prefill_step``'s argmax equal to the forward's. Returns the
    kernel's launches in one forward and the forward's wall time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.models import transformer as T

    api = registry.build(arch, smoke=False, device="cuda")
    cfg = api.cfg
    t0 = time.perf_counter()
    params = api.init(torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S + DECODE_STEPS))).cuda()
    tokens = toks[:, :S]
    labels = toks[:, 1:S + 1].clone()
    pe = None
    if cfg.prefix_len:
        pe = torch.from_numpy((0.1 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)).to(
            torch.bfloat16).cuda()
        labels[:, :cfg.prefix_len] = -1      # no loss on the image prefix
    batch = {"tokens": tokens, "labels": labels, "prefix_embeds": pe}
    with torch.inference_mode():
        T.forward(params, cfg, tokens, pe, use_kernel=True)   # warm-up
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        lk, _ = T.forward(params, cfg, tokens, pe, use_kernel=True)
        torch.cuda.synchronize()
        wall_kernel = time.perf_counter() - t0
        launches = fa.LAUNCHES["flash_attention"]
        fa.reset_launches()
        t0 = time.perf_counter()
        lp, _ = T.forward(params, cfg, tokens, pe)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        if launches != cfg.num_layers or fa.LAUNCHES["flash_attention"]:
            fail(f"{arch}: forward launched the kernel {launches} times "
                 f"with use_kernel (want {cfg.num_layers}) and "
                 f"{fa.LAUNCHES['flash_attention']} without (want 0)")
        if lk.shape != (B, S, cfg.vocab) or not torch.isfinite(lk).all():
            fail(f"{arch}: forward logits {tuple(lk.shape)} not finite")
        # where one forward's device time goes: the kernel against the rest
        rows = device_events(lambda: T.forward(params, cfg, tokens, pe,
                                               use_kernel=True),
                             iters=1, warmup=0,
                             per_call={"flash_kernel": cfg.num_layers})
        device_ms = sum(us for _, _, us in rows) / 1e3
        flash_ms = sum(us for n, _, us in rows if "flash_kernel" in n) / 1e3

        layer = {k: {kk: vv[0] for kk, vv in v.items()}
                 for k, v in params["layers"].items()}
        h = nn.rmsnorm(layer["ln1"], T._embed_tokens(params, cfg, tokens, pe))
        spec = cfg.attn_spec()
        a_k = nn.attn_apply(layer["attn"], h, spec, use_kernel=True)
        a_p = nn.attn_apply(layer["attn"], h, spec)
        if not torch.allclose(a_k.float(), a_p.float(), atol=3e-2,
                              rtol=3e-2):
            fail(f"{arch}: layer 0 attention, kernel against plain, beyond "
                 f"3e-2: {(a_k.float() - a_p.float()).abs().max().item()}")
        layer0_err = (a_k.float() - a_p.float()).abs().max().item()

        d = (lk.float() - lp.float()).abs()
        agree = (lk.float().argmax(-1) == lp.float().argmax(-1)).float()
        if not d.max().item() <= LOGITS_ATOL:
            fail(f"{arch}: logits with the kernel differ from the plain "
                 f"forward's by {d.max().item()} (limit {LOGITS_ATOL})")
        # the control: a mask fault in the plain forward must break the
        # limit. Without a prefix the last 64 queries lose one 64-key tile
        # (a window of S - 64); with one, the prefix stops halfway, which
        # is what the Pallas kernel's block skip does to paligemma's 256
        # prefix keys at 128-blocks (ROADMAP Queue 3)
        fault = ({"prefix_len": cfg.prefix_len // 2} if cfg.prefix_len
                 else {"window": S - 64})
        lc, _ = T.forward(params, dataclasses.replace(cfg, **fault),
                          tokens, pe)
        control = (lc.float() - lp.float()).abs().max().item()
        del lc
        if not control > LOGITS_ATOL:
            fail(f"{arch}: the control fault {fault} moved the "
                 f"logits by {control}, within the limit {LOGITS_ATOL}: the "
                 f"logit check cannot see a fault of that size")
        loss_k, _ = T.loss_fn(params, cfg, batch, use_kernel=True)
        loss_p, _ = api.loss_fn(params, batch)
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        if not rel <= LOSS_RTOL:
            fail(f"{arch}: loss {loss_k.item()} with the kernel, "
                 f"{loss_p.item()} without: relative {rel} > {LOSS_RTOL}")
        del lk

        full, _ = T.forward(params, cfg, toks, pe)
        lg, cache = T.prefill(params, cfg, tokens, pe,
                              cache_len=S + DECODE_STEPS)
        gaps = [(lg[:, -1].float() - full[:, S - 1].float()).abs().max()
                .item()]
        for i in range(DECODE_STEPS):
            pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            ld, cache = api.decode_step(params, cache, toks[:, S + i], pos)
            gaps.append((ld.float() - full[:, S + i].float()).abs().max()
                        .item())
        if not max(gaps) <= DECODE_ATOL:
            fail(f"{arch}: prefill then decode differs from the full "
                 f"forward by {gaps} (limit {DECODE_ATOL})")
        nxt, _ = make_prefill_step(api)(params, batch)
        if not torch.equal(nxt, lp[:, -1].float().argmax(-1)):
            fail(f"{arch}: make_prefill_step's argmax differs from the "
                 f"forward's last position")
    out = {"arch": arch, "batch": B, "seq": S, "layers": cfg.num_layers,
           "init_s": init_s, "launches": launches,
           "forward_kernel_ms": wall_kernel * 1e3,
           "forward_plain_ms": wall_plain * 1e3,
           "forward_device_ms": device_ms, "flash_kernel_ms": flash_ms,
           "device_ops": sum(n for _, n, _ in rows),
           "tokens_per_s_kernel": B * S / wall_kernel,
           "tokens_per_s_plain": B * S / wall_plain,
           "layer0_attn_max_abs_err": layer0_err,
           "logits_max_abs_diff": d.max().item(),
           "control_fault": fault, "control_logits_max_abs_diff": control,
           "logits_mean_abs_diff": d.mean().item(),
           "argmax_agree": agree.mean().item(),
           "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_diff": rel, "prefill_decode_max_abs_diff": gaps}
    print(json.dumps({"forward_phase": out}), flush=True)
    return out


def wkv_inputs(B, S, H, hs, seed: int, model_like: bool):
    """(r, k, v, w, u) f32 on the card from a seeded CPU generator: r, k,
    v N(0, 1); w = sigmoid(N) * 0.5 + 0.45 and u 0.3 N(0, 1) as
    tests/test_kernels.py draws them, or w = exp(-exp(-6 + N(0, 1))) and
    u 0.5 N(0, 1) as the model's decay bias and init give them."""
    g = torch.Generator().manual_seed(seed)
    r, k, v, n = (torch.randn((B, S, H, hs), generator=g) for _ in range(4))
    if model_like:
        w = torch.exp(-torch.exp(-6.0 + n))
        u = 0.5 * torch.randn((H, hs), generator=g)
    else:
        w = torch.sigmoid(n) * 0.5 + 0.45
        u = 0.3 * torch.randn((H, hs), generator=g)
    return tuple(x.cuda() for x in (r, k, v, w, u))


def compare_wkv(got, want, where) -> float:
    """The reference's tolerance, atol = rtol = 1e-4. Returns the largest
    absolute difference."""
    if got.shape != want.shape or got.dtype != torch.float32 \
            or not torch.allclose(got, want, atol=WKV_TOL, rtol=WKV_TOL):
        fail(f"wkv6 differs from the plain version at {where}: max abs "
             f"{(got - want).abs().max().item()}")
    return (got - want).abs().max().item()


def check_wkv6() -> None:
    """The wkv6 kernel against ref.wkv6 at every shape of WKV_CHECKS (f32
    products in the plain version: TF32 off), and the reference's
    divisibility contract on the card."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as rs
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (B, S, H, hs, model_like) in enumerate(WKV_CHECKS):
        x = wkv_inputs(B, S, H, hs, seed=300 + i, model_like=model_like)
        where = f"B,S,H,hs = {B},{S},{H},{hs}" + (
            " (the model's w and u)" if model_like else "")
        err = compare_wkv(rs.wkv6(*x), ref.wkv6(*x)[0], where)
        torch.cuda.synchronize()
        print(f"wkv6 matches the plain version at {where} (max abs err "
              f"{err:.3g})", flush=True)
    x = wkv_inputs(1, 100, 2, 64, seed=0, model_like=False)
    try:
        ops.wkv6(*x, chunk=64)
    except ValueError as e:
        print(f"wkv6 refuses S=100 with chunk 64 on the card: {e}",
              flush=True)
    else:
        fail("wkv6 accepted S=100 with chunk 64")


def measure_wkv6(shape) -> dict:
    """Time the wkv6 kernel and its plain version at (B, S, H, hs) with
    the model's w and u, by the profiler's device time, with the bound of
    this work: r, k, v, w and out once (and u) against 3.35 TB/s, and the
    fewest f32 operations the function needs, 5 hs^2 + 5 hs per (b, t, h)
    (r*S and its sum, k*v, w*S, +kv per state element; the bonus dot
    sum_i r_i u_i k_i and v_j times it), against 67 TFLOP/s on CUDA
    cores. The kernel must be the one device operation of its call,
    reach no less than its bound, and agree (the median of TIMING_ROUNDS
    ``paired_profile``s) with CUDA events over the same calls queued
    behind a held stream within FLASH_EVENT_SHARE. No single
    PyTorch call computes the WKV6 recurrence, so there is no library
    time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    B, S, H, hs = shape
    x = wkv_inputs(B, S, H, hs, seed=99, model_like=True)
    fn = lambda: rs.wkv6(*x)
    plain = lambda: ref.wkv6(*x)[0]
    err = compare_wkv(fn(), plain(), shape)
    n = B * S * H
    flops = (5 * hs * hs + 5 * hs) * n
    nbytes = 4 * (5 * n * hs + H * hs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    ms, per_call, ev = median(paired_profile, fn, iters=10,
                              per_call={"wkv6_kernel": 1})
    # the plain version's 4096-step Python loop takes ~1.5 s of host time a
    # call; the comparison above was its warm-up
    plain_ms = device_profile(plain, iters=1, warmup=0)[0]
    print(f"wkv6 at {shape}: device ms (profiler) {ms:.4f}, stream ms "
          f"(CUDA events, stream held) {ev:.4f}, plain {plain_ms:.4f}, "
          f"bound {bound:.4f}", flush=True)
    if per_call != 1:
        fail(f"wkv6 at {shape}: {per_call} device operations per call, "
             f"want 1")
    if ms < bound or abs(ms - ev) > FLASH_EVENT_SHARE * ev:
        fail(f"wkv6 at {shape}: {ms} ms by the profiler is below its bound "
             f"{bound} ms or more than {FLASH_EVENT_SHARE:.0%} off its "
             f"stream time {ev} ms")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            "replaces": REPLACES["wkv6"], "shape": list(shape),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "event_ms": ev, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flop": flops, "bytes": nbytes, "library_ms": None}


def rwkv_forward_phase(B: int, S: int):
    """The RWKV forward path: rwkv6-7b FULL (random weights drawn on the
    card from a seed) under ``inference_mode``. The registry's ``forward``
    must launch wkv6 once per layer, and the profiler must see those
    launches; layer 0's recurrence, on the inputs the forward handed the
    kernel, within WKV_TOL of the plain version; ``loss_fn`` within
    LOSS_RTOL of the plain forward's (``use_kernel=False``, which
    launches nothing) loss; ``make_prefill_step``'s argmax equal to the
    forward's; the bf16 logit gap to the plain forward recorded; and the
    whole-model logit check in f32 (``rwkv_f32_logits``). Returns (api,
    params, the phase's numbers)."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.models import rwkv6 as W

    api = registry.build("rwkv6-7b", smoke=False, device="cuda")
    cfg = api.cfg
    if (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.head_size) != (32, 4096, 14336, 65536, 64):
        fail(f"not the full-width config: {cfg}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    nn.tree_map(lambda t: sizes.append(t.numel() * t.element_size()), params)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S + 1))).cuda()
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:].clone()}
    L = cfg.num_layers
    with torch.inference_mode():
        # warm-up, keeping the inputs the forward hands the first layer's
        # recurrence
        seen = []
        real_wkv6 = kernel_ops.wkv6

        def rec(*a, **kw):
            if not seen:
                seen.append(a)
            return real_wkv6(*a, **kw)

        kernel_ops.wkv6 = rec
        try:
            api.forward(params, batch)
        finally:
            kernel_ops.wkv6 = real_wkv6
        torch.cuda.synchronize()
        rs.reset_launches()
        t0 = time.perf_counter()
        lk = api.forward(params, batch)
        torch.cuda.synchronize()
        wall_kernel = time.perf_counter() - t0
        launches = rs.LAUNCHES["wkv6"]
        rs.reset_launches()
        t0 = time.perf_counter()
        lp, _ = W.forward(params, cfg, batch["tokens"], use_kernel=False)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        if launches != L or rs.LAUNCHES["wkv6"]:
            fail(f"rwkv6-7b: forward launched wkv6 {launches} times (want "
                 f"{L}) and {rs.LAUNCHES['wkv6']} without the kernel "
                 f"(want 0)")
        if lk.shape != (B, S, cfg.vocab) or not torch.isfinite(lk).all():
            fail(f"rwkv6-7b: forward logits {tuple(lk.shape)} not finite")
        # where one forward's device time goes: the kernel against the rest
        rows = device_events(lambda: api.forward(params, batch), iters=1,
                             warmup=0, per_call={"wkv6_kernel": L})
        device_ms = sum(us for _, _, us in rows) / 1e3
        wkv_ms = sum(us for n, _, us in rows if "wkv6_kernel" in n) / 1e3

        r, k, v, w, u = (t.float().contiguous() for t in seen[0])
        layer0_err = compare_wkv(rs.wkv6(r, k, v, w, u),
                                 ref.wkv6(r, k, v, w, u)[0],
                                 "layer 0 of the rwkv6-7b forward")
        del seen, r, k, v, w, u

        # bf16: recorded, not gated (one-ulp differences grow through the
        # 32 layers; the gate below is in f32)
        d = (lk.float() - lp.float()).abs()
        d_max, d_mean = d.max().item(), d.mean().item()
        del d
        agree = (lk.float().argmax(-1) == lp.float().argmax(-1)).float() \
            .mean().item()
        loss_k, _ = api.loss_fn(params, batch)
        loss_p = nn.cross_entropy(lp, batch["labels"])
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        if not rel <= LOSS_RTOL:
            fail(f"rwkv6-7b: loss {loss_k.item()} with the kernel, "
                 f"{loss_p.item()} without: relative {rel} > {LOSS_RTOL}")
        nxt, _ = make_prefill_step(api)(params, batch)
        if not torch.equal(nxt, lk[:, -1].float().argmax(-1)):
            fail("rwkv6-7b: make_prefill_step's argmax differs from the "
                 "forward's last position")
        del lk, lp
        torch.cuda.empty_cache()
        f32 = rwkv_f32_logits(params, cfg, batch["tokens"])
    out = {"arch": "rwkv6-7b", "batch": B, "seq": S, "layers": L,
           "param_bytes": sum(sizes), "init_s": init_s, "launches": launches,
           "forward_kernel_ms": wall_kernel * 1e3,
           "forward_plain_ms": wall_plain * 1e3,
           "forward_device_ms": device_ms, "wkv6_kernel_ms": wkv_ms,
           "wkv6_share_of_device_ms": wkv_ms / device_ms,
           "device_ops": sum(n for _, n, _ in rows),
           "tokens_per_s_kernel": B * S / wall_kernel,
           "tokens_per_s_plain": B * S / wall_plain,
           "layer0_wkv_max_abs_err": layer0_err,
           "bf16_logits_max_abs_diff": d_max,
           "bf16_logits_mean_abs_diff": d_mean, "bf16_argmax_agree": agree,
           **f32,
           "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_diff": rel}
    print(json.dumps({"rwkv_forward_phase": out}), flush=True)
    return api, params, out


def rwkv_f32_logits(params, cfg, tokens) -> dict:
    """The whole-model logit check of the RWKV forward path, in f32: the
    same weights cast to f32 (the kernel takes f32 r, k, v, w in either
    dtype, at the same shape), the forward with the kernel against the
    plain forward within RWKV_LOGITS_ATOL, and the control (the plain
    forward with its state reset every RWKV_RESET tokens) beyond it. In
    bf16, one-ulp differences grow through the 32 random-weight layers to
    logit gaps as large as a real fault's (PERF.md); f32 rounding starts
    ~1e-7. TF32 is off, so the f32 matmuls are f32."""
    from repro_torch.models import layers as nn
    from repro_torch.models import rwkv6 as W
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = nn.tree_map(lambda t: t.float(), params)
    lk, _ = W.forward(p32, cfg32, tokens)
    lp, _ = W.forward(p32, cfg32, tokens, use_kernel=False)
    d = (lk - lp).abs()
    d_max, d_mean = d.max().item(), d.mean().item()
    del d, lk
    real_scan = W.wkv_scan

    def reset_scan(r, k, v, w, u, state=None):
        n = RWKV_RESET
        return torch.cat([real_scan(r[:, i:i + n], k[:, i:i + n],
                                    v[:, i:i + n], w[:, i:i + n], u)[0]
                          for i in range(0, r.shape[1], n)], dim=1), None

    W.wkv_scan = reset_scan
    try:
        lc, _ = W.forward(p32, cfg32, tokens, use_kernel=False)
    finally:
        W.wkv_scan = real_scan
    control = (lc - lp).abs().max().item()
    del lc, lp, p32
    torch.cuda.empty_cache()
    if not d_max <= RWKV_LOGITS_ATOL:
        fail(f"rwkv6-7b: f32 logits with the kernel differ from the plain "
             f"forward's by {d_max} (limit {RWKV_LOGITS_ATOL})")
    if not control > RWKV_LOGITS_ATOL:
        fail(f"rwkv6-7b: the control (state reset every {RWKV_RESET} "
             f"tokens) moved the f32 logits by {control}, within the limit "
             f"{RWKV_LOGITS_ATOL}: the logit check cannot see it")
    return {"f32_logits_max_abs_diff": d_max,
            "f32_logits_mean_abs_diff": d_mean,
            "control_fault": f"state reset every {RWKV_RESET} tokens",
            "f32_control_logits_max_abs_diff": control}


def rwkv_serve_phase(api, params) -> dict:
    """The RWKV serving path: rwkv6-7b FULL through ``ServeEngine`` with
    paging gated off by the recurrent cache kind, replaying the engine's
    step graphs, every request token for token against
    ``reference_decode`` in batches of the engine's max_batch; then once
    more with the eager megastep, which must serve the same. Decode runs
    the one-step recurrence, not the kernel: its wkv6 launches must be 0.
    Also profiles one ``decode_step`` at the engine's batch (device ms
    and operations)."""
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.serve import EngineConfig, ServeEngine

    prompts = np.random.default_rng(6).integers(
        0, api.cfg.vocab, (RWKV_REQUESTS, RWKV_PROMPT)).astype(np.int32)
    engine_cfg = EngineConfig(**RWKV_SERVE, max_queue=RWKV_REQUESTS + 8,
                              device="cuda")
    warm = ServeEngine(api, params, engine_cfg)
    for i in range(RWKV_SERVE["max_batch"]):
        warm.submit(prompts[i, :8], 4)
    warm.run()
    eng = ServeEngine(api, params, engine_cfg)
    if eng.paged or eng.pool is not None:
        fail("rwkv6-7b: the engine paged a recurrent cache")
    rids = [eng.submit(prompts[i], RWKV_GEN,
                       arrival_step=i * ARRIVAL_EVERY).rid
            for i in range(RWKV_REQUESTS)]
    torch.cuda.synchronize()
    rs.reset_launches()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rs.LAUNCHES["wkv6"]
    check_decode(api, params, prompts, outs, rids, RWKV_GEN,
                 RWKV_SERVE["max_batch"], RWKV_SERVE["cache_len"])
    ps = eng.paging_stats()
    if ps["paged"] is not False:
        fail(f"rwkv6-7b: paging_stats says paged={ps['paged']}")
    if launches:
        fail(f"rwkv6-7b: decode launched wkv6 {launches} times (want 0)")
    tokens = sum(len(outs[r]) for r in rids)
    graphs = graph_lines("rwkv", eng)
    eager = ServeEngine(api, params, engine_cfg, _graphs=False)
    erids = [eager.submit(prompts[i], RWKV_GEN,
                          arrival_step=i * ARRIVAL_EVERY).rid
             for i in range(RWKV_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eouts = eager.run()
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    if any(not np.array_equal(eouts[a], outs[b])
           for a, b in zip(erids, rids)) or eager.stats() != eng.stats():
        fail("rwkv6-7b: the eager megastep served otherwise")
    # one decode_step at the engine's batch: device ms and operations
    B = RWKV_SERVE["max_batch"]
    cache = api.init_cache(B, RWKV_SERVE["cache_len"])
    toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
    dec_ms, dec_ops = device_profile(
        lambda: api.decode_step(params, cache, toks, None), iters=5)
    out = {"arch": "rwkv6-7b", "requests": RWKV_REQUESTS,
           "prompt": RWKV_PROMPT, "gen": RWKV_GEN, "tokens": tokens,
           "paged": ps["paged"], "wall_ms": wall * 1e3,
           "tokens_per_s": tokens / wall, "wkv6_launches": launches,
           "steps": ps["steps"], "host_dispatches": ps["host_dispatches"],
           "megasteps": ps["megasteps"], "host_blocked": ps["host_blocked"],
           "decoder_ops_per_step": dec_ops, "decoder_ms_per_step": dec_ms,
           "decode_steps": eng.decode_steps,
           "wall_ms_per_decode_step": wall * 1e3 / eng.decode_steps,
           **graphs, "eager": {
               "wall_ms": ewall * 1e3, "tokens_per_s": tokens / ewall,
               "wall_ms_per_decode_step": ewall * 1e3 / eager.decode_steps}}
    print(f"served {RWKV_REQUESTS} requests of rwkv6-7b (full width) on "
          f"the card: {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tok/s), all token-exact vs "
          f"reference_decode, paged={ps['paged']}", flush=True)
    print(json.dumps({"rwkv_serve_phase": out}), flush=True)
    return out


def full_model():
    """smollm-135m FULL on the card with the port's seeded init."""
    from repro_torch.models import registry
    api = registry.build("smollm-135m", smoke=False, device="cuda")
    cfg = api.cfg
    if (cfg.num_layers, cfg.d_model, cfg.vocab) != (30, 576, 49152):
        fail(f"not the full-width config: {cfg}")
    return api, api.init(torch.Generator().manual_seed(0))


def check_decode(api, params, prompts, outs, rids, gen, batch,
                 cache_len) -> None:
    """Token for token against the static-batch oracle, run in batches of
    the engine's max_batch rows so both see the same matmul shapes."""
    from repro_torch.serve import reference_decode
    for lo in range(0, len(rids), batch):
        ref = reference_decode(api, params, prompts[lo:lo + batch], gen,
                               cache_len=cache_len).cpu().numpy()
        for j in range(ref.shape[0]):
            got = outs[rids[lo + j]]
            if not np.array_equal(got, ref[j]):
                bad = int(np.flatnonzero(got != ref[j])[0])
                fail(f"request {lo + j}: token {bad} is {got[bad]}, the "
                     f"reference decode has {ref[j][bad]}")


def graph_lines(path: str, eng) -> dict:
    """Check that a served engine replayed captured CUDA graphs of its
    steps, and print their count and capture seconds, each on a line of
    its own."""
    g = eng.graphs
    if g is None or not g.captured or eng.n_graphs != len(g.keys) or \
            eng.n_graphs > eng.cfg.prefill_chunk + 1:
        fail(f"{path}: the engine did not serve from its step graphs")
    print(f"graphs {path}: {eng.n_graphs}", flush=True)
    print(f"graph_capture_s {path}: {g.capture_s:.3f}", flush=True)
    return {"graphs": eng.n_graphs, "capture_s": g.capture_s}


def serve_full(api, params, shapes_seen: dict) -> tuple[dict, dict]:
    """The main path: smollm-135m FULL served through the paged pool on
    the card, replaying the engine's step graphs. Returns the launch
    counts of this run alone, and the run (a function that builds its
    engine, its tokens, launches and stats) for ``megastep_turns`` and
    ``profile_serving``."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = api.cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    engine_cfg = EngineConfig(**SERVE, max_queue=N_REQUESTS + 8,
                              device="cuda")

    def main_run_engine(model=api, graphs: bool = True) -> tuple:
        """A fresh engine holding the main path's requests: replaying
        its step graphs, or running the eager megastep."""
        eng = ServeEngine(model, params, engine_cfg,
                          _graphs=None if graphs else False)
        rids = [eng.submit(prompts[i], GEN,
                           arrival_step=i * ARRIVAL_EVERY).rid
                for i in range(N_REQUESTS)]
        return eng, rids

    # warm the libraries and the allocator on a full batch of short requests
    warm = ServeEngine(api, params, engine_cfg)
    for i in range(SERVE["max_batch"]):
        warm.submit(prompts[i, :8], 8)
    warm.run()

    engine, rids = main_run_engine()
    torch.cuda.synchronize()
    ds.reset_launches()
    with stream_shapes(shapes_seen):
        t0 = time.perf_counter()
        outs = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ds.LAUNCHES)

    check_decode(api, params, prompts, outs, rids, GEN, SERVE["max_batch"],
                 SERVE["cache_len"])
    ps = engine.paging_stats()
    if ps["page_ins"] <= 0 or ps["page_outs"] <= 0:
        fail(f"the pool did not page both ways: {ps['page_ins']} ins, "
             f"{ps['page_outs']} outs")
    engine.pool.check_invariants()
    for name, n in launches.items():
        if n <= 0:
            fail(f"the serving path never launched {name}")
    tokens = sum(len(v) for v in outs.values())
    print(f"served {N_REQUESTS} requests of smollm-135m (full width) on "
          f"the card: {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tok/s), all token-exact vs "
          f"reference_decode; page_ins={ps['page_ins']} "
          f"page_outs={ps['page_outs']} kernel_calls={ps['kernel_calls']} "
          f"duplex_speedup={ps['duplex_speedup']:.4f} launches={launches} "
          f"host_blocked={ps['host_blocked']} megasteps={ps['megasteps']}",
          flush=True)
    return launches, {"engine": main_run_engine,
                      "tokens": [outs[r] for r in rids],
                      "launches": launches, "stats": engine.stats(),
                      **graph_lines("main", engine)}


def served_run(main: dict, graphs: bool) -> tuple:
    """One more run of the main path's requests on a fresh engine,
    replaying its step graphs or running the eager megastep: the same
    tokens, launches and stats as the main run, or fail. Returns the
    engine and the wall seconds of ``run()``."""
    from repro_torch.kernels import duplex_stream as ds
    eng, rids = main["engine"](graphs=graphs)
    torch.cuda.synchronize()
    ds.reset_launches()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mode = "graphs" if graphs else "eager"
    if any(not np.array_equal(outs[r], t)
           for r, t in zip(rids, main["tokens"])):
        fail(f"the main path's {mode} run served other tokens")
    if dict(ds.LAUNCHES) != main["launches"] or \
            eng.stats() != main["stats"]:
        fail(f"the main path's {mode} run launched {dict(ds.LAUNCHES)} "
             f"with stats {eng.stats()}; the main run {main['launches']}, "
             f"{main['stats']}")
    return eng, wall


def megastep_turns(main: dict) -> dict:
    """The eager megastep (the engine before its step graphs) and the
    graphed one on the main path's requests, in turns (eager, graphs,
    graphs, eager): wall seconds of each run, by mode."""
    walls = {"eager": [], "graphs": []}
    for graphs in (False, True, True, False):
        eng, wall = served_run(main, graphs)
        walls["graphs" if graphs else "eager"].append(wall)
    tokens = sum(len(t) for t in main["tokens"])
    out = {mode: {"wall_s": w, "tokens_per_s": [tokens / x for x in w],
                  "wall_ms_per_decode_step": [x * 1e3 / eng.decode_steps
                                              for x in w]}
           for mode, w in walls.items()}
    out["decode_steps"] = eng.decode_steps
    print(json.dumps({"megastep_turns": out}), flush=True)
    return walls


@contextlib.contextmanager
def stream_shapes(seen: dict):
    """Count, by kernel, the (N, T, D) shapes the serving path hands each
    stream kernel while the block runs (into ``seen``)."""
    from repro_torch.kernels import duplex_stream as ds
    real = {name: getattr(ds, name) for name in STREAMS}

    def recorder(name):
        def rec(*a):
            seen.setdefault(name, Counter())[tuple(a[0].shape)] += 1
            return real[name](*a)
        return rec

    for name in STREAMS:
        setattr(ds, name, recorder(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(ds, name, fn)


def check_store(kv, pool, what: str, lost_ok: bool = False) -> tuple:
    """Every store block holds the synthesized value of its latest SET
    version, as tests/test_workloads.py:49-61: from HBM where it is
    resident, else dequantized from its host-tier slot (int8 round-trip
    tolerance for both). With ``lost_ok`` (a fault run) a block may
    instead have lost its value: all zero in HBM (the zero-install of a
    tenant block whose host copy was lost) or no host slot at all.
    Returns the counts of blocks checked and of blocks found lost."""
    from repro_torch.kernels import ref
    from repro_torch.serve.workloads import _synth_blocks, kv_value_seed
    T, D = pool.block_shape
    checked = lost = 0
    for b in kv._store:
        if b not in kv._version:
            continue
        slot, hs = pool.slot_of[b], pool.host.slot_of[b]
        if slot >= 0:
            got = pool.hbm[slot].float()
        elif hs >= 0:
            got = ref.dequantize_int8(pool.host_q[hs],
                                      pool.host_scale[hs]).float()
        elif lost_ok:
            lost += 1
            continue
        else:
            fail(f"{what}: store block {b} is neither resident nor on the "
                 f"host tier")
        want = _synth_blocks(torch.tensor(
            [kv_value_seed(b, kv._version[b])], dtype=torch.int32,
            device=pool.device), tokens=T, dims=D)[0].float()
        err = (got - want).abs().max().item()
        if err > 1.0 / 127.0 + 0.05:
            if not (lost_ok and slot >= 0 and not got.any().item()):
                fail(f"{what}: store block {b} differs from its value by "
                     f"{err}")
            lost += 1
        checked += 1
    if checked == 0:
        fail(f"{what}: no store block to check")
    return checked, lost


def serve_tenants(api, params, l2_shapes: Counter) -> dict:
    """The tenant path: smollm-135m FULL decode co-served with a KV-store
    tenant (two sequential streams, one read-heavy stream over a preloaded
    32-block store) and a vector-search tenant (one 4-query walk over a
    16-block dataset) in one oversubscribed pool, replaying the engine's
    step graphs. Run once under ``torch.cuda.set_sync_debug_mode("warn")``,
    then once more with the eager megastep, which must serve the same;
    returns the launch counts of the graphed run alone."""
    from repro_torch.device import sync_watch
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import vector_distance as vd
    from repro_torch.serve import (EngineConfig, KVStoreTenant, ServeEngine,
                                   VectorSearchTenant)
    from repro_torch.serve.workloads import _synth_blocks

    prompts = np.random.default_rng(2).integers(
        0, api.cfg.vocab, (TENANT_LLM_REQUESTS, PROMPT_LEN)).astype(np.int32)

    def tenant_engine(graphs: bool) -> tuple:
        eng = ServeEngine(api, params, EngineConfig(
            **TENANT_SERVE, max_queue=TENANT_LLM_REQUESTS + 8,
            device="cuda"), _graphs=None if graphs else False)
        kv = eng.add_tenant(KVStoreTenant(n_slots=3, ops_per_step=2,
                                          store_blocks=32))
        kv.preload(32)
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, n_queries=4, visits_per_step=2, data_blocks=16,
            load_per_step=1, result_every=4))
        rids = [eng.submit(prompts[i], TENANT_GEN,
                           arrival_step=i * ARRIVAL_EVERY).rid
                for i in range(TENANT_LLM_REQUESTS)]
        treqs = [kv.submit("sequential", n_steps=TENANT_STEPS,
                           phase="read"),
                 kv.submit("sequential", n_steps=TENANT_STEPS,
                           phase="write"),
                 kv.submit("read_heavy", n_steps=TENANT_STEPS),
                 vec.submit(n_steps=TENANT_STEPS)]
        return eng, kv, vec, rids, treqs

    eng, kv, vec, rids, treqs = tenant_engine(graphs=True)

    real = vd.l2_distance

    def rec(queries, blocks):
        l2_shapes[(queries.shape[0],) + tuple(blocks.shape)] += 1
        return real(queries, blocks)

    vd.l2_distance = rec
    torch.cuda.synchronize()
    ds.reset_launches()
    vd.reset_launches()
    # only the engine's run is watched: the synchronize that ends the
    # timing below is this script's own
    with sync_watch() as sync_sites:
        t0 = time.perf_counter()
        outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ds.LAUNCHES, **vd.LAUNCHES}
    vd.l2_distance = real

    check_decode(api, params, prompts, outs, rids, TENANT_GEN,
                 TENANT_SERVE["max_batch"], TENANT_SERVE["cache_len"])
    missing = [r.rid for r in treqs if r.rid not in eng.completed]
    if missing:
        fail(f"tenant requests {missing} did not complete")
    if kv.ops_done <= 0 or vec.queries_done <= 0:
        fail(f"tenants served nothing: {kv.ops_done} ops, "
             f"{vec.queries_done} queries")
    pool = eng.pool
    T, D = pool.block_shape
    checked, _ = check_store(kv, pool, "the tenant path")
    # the walk's minima equal a brute-force scan of the visited blocks
    # (tolerance of tests/test_workloads.py:196-197)
    vreq = treqs[-1]
    best = vec.result()["best"][vreq.rid]
    seeds = torch.tensor([vec.data_seed(i) for i in sorted(vreq.work.visited)],
                         dtype=torch.int32, device="cuda")
    data = _synth_blocks(seeds, tokens=T, dims=D).float().reshape(-1, D)
    q = vreq.work.queries
    want = ((q[:, None, :] - data[None]) ** 2).sum(-1).amin(1).cpu().numpy()
    if not np.allclose(best, want, rtol=1e-2, atol=0.05 * D / 32):
        fail(f"vector walk minima {best} differ from the brute-force "
             f"scan {want}")
    ps = eng.paging_stats()
    withdrawn = ps["by_path"]["/serve/redis/read_heavy"]
    if withdrawn["fused_calls"] != 0 or \
            withdrawn["duplex_us"] != withdrawn["serial_us"]:
        fail(f"/serve/redis/read_heavy rode the fused kernel: {withdrawn}")
    for path in ("/serve/redis/seq/read", "/serve/redis/seq/write",
                 "/serve/vectordb"):
        if ps["by_path"][path]["fused_calls"] <= 0:
            fail(f"opted-in scope {path} never ran fused")
    pool.check_invariants()
    for name, n in launches.items():
        if n <= 0:
            fail(f"the tenant path never launched {name}")
    tokens = sum(len(outs[r]) for r in rids)
    by_path = {p: [st["fused_calls"], st["page_ins"], st["page_outs"]]
               for p, st in ps["by_path"].items()}
    print(f"tenant path: {TENANT_LLM_REQUESTS} LLM requests of smollm-135m "
          f"(full width) co-served with both tenants on the card: "
          f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s), "
          f"all token-exact; redis ops={kv.ops_done} vectordb "
          f"queries={vec.queries_done}; {checked} store blocks and the "
          f"walk's minima checked; duplex_speedup="
          f"{ps['duplex_speedup']:.4f} by_path [fused, ins, outs]="
          f"{json.dumps(by_path)} launches={launches} "
          f"sync_warnings={sum(sync_sites.values())} {dict(sync_sites)} "
          f"steps={ps['steps']} megasteps={ps['megasteps']} "
          f"host_blocked={ps['host_blocked']}", flush=True)
    out = {"graphs": {"wall_s": wall, "tokens_per_s": tokens / wall,
                      "wall_ms_per_decode_step":
                      wall * 1e3 / eng.decode_steps,
                      **graph_lines("tenant", eng)}}

    # the eager megastep on the same requests: the same tokens, tenant
    # work, paging and launches
    eager, ekv, evec, erids, _ = tenant_engine(graphs=False)
    torch.cuda.synchronize()
    ds.reset_launches()
    vd.reset_launches()
    t0 = time.perf_counter()
    eouts = eager.run()
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    if any(not np.array_equal(eouts[a], outs[b])
           for a, b in zip(erids, rids)):
        fail("the tenant path's eager run served other tokens")
    if {**ds.LAUNCHES, **vd.LAUNCHES} != launches or \
            eager.paging_stats() != ps or \
            (ekv.ops_done, evec.queries_done) != (kv.ops_done,
                                                  vec.queries_done):
        fail("the tenant path's eager run paged or served otherwise")
    out["eager"] = {"wall_s": ewall, "tokens_per_s": tokens / ewall,
                    "wall_ms_per_decode_step":
                    ewall * 1e3 / eager.decode_steps}
    print(json.dumps({"tenant_serving": out}), flush=True)
    return launches


def tiered_run(api, params, prompts, graphs: bool, plan=None,
               trace: bool = False) -> dict:
    """One run of the tiered path (``TIER_SPEC``, the KV-store tenant of
    ``TIER_KV``) with the main path's LLM requests, under a fault plan or
    without: the graphed run under the sync watch. Every boundary's
    migration is followed by ``check_invariants``; every evacuation's
    moved rows are compared, on the device, with their values before the
    move; the store blocks are checked after the run. Returns
    the host-deterministic readings the graphed and eager runs must share
    (the stream shapes among them, as [N, T, D, launches]), and the run's
    wall seconds, syncs and engine."""
    from repro_torch.core import faults as faults_lib
    from repro_torch.device import sync_watch, to_device
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.serve import EngineConfig, KVStoreTenant, ServeEngine

    fx = None
    if plan is not None:
        events = (faults_lib.parse_fault_plan(plan) if isinstance(plan, str)
                  else plan)
        fx = faults_lib.FaultInjector(events, seed=FAULT_SEED)
    eng = ServeEngine(api, params, EngineConfig(
        **SERVE, max_queue=N_REQUESTS + 8, tiers=TIER_SPEC, faults=fx,
        trace=True if trace else None, device="cuda"),
        _graphs=None if graphs else False)
    kv = eng.add_tenant(KVStoreTenant(**TIER_KV))
    kv.preload(TIER_KV["store_blocks"])
    for pattern, phase in TIER_STREAMS:
        kv.submit(pattern, n_steps=TIER_STEPS, phase=phase)
    reqs = [eng.submit(prompts[i], GEN, arrival_step=i * ARRIVAL_EVERY)
            for i in range(N_REQUESTS)]
    pool = eng.pool
    static = [*eng._dev.values(), *eng.cache.values(), pool.hbm,
              pool.host_q, pool.host_scale]

    # wrapped here, not in the package: invariants at every boundary, and
    # each evacuated row against its bytes before the move
    migrate, evacuate_channel = pool.migrate_tiers, pool._evacuate_channel
    boundaries, moves = [0], []

    def checked_migrate():
        out = migrate()
        pool.check_invariants()
        boundaries[0] += 1
        return out

    def compared_evacuate_channel(c):
        before = pool.host.slot_of.copy()
        q, sc = pool.host_q.clone(), pool.host_scale.clone()
        out = evacuate_channel(c)
        after = pool.host.slot_of
        moved = np.flatnonzero((before != after) & (before >= 0)
                               & (after >= 0))
        si = to_device(before[moved].astype(np.int64), pool.device)
        di = to_device(after[moved].astype(np.int64), pool.device)
        moves.append((int(moved.size),
                      (pool.host_q.index_select(0, di)
                       == q.index_select(0, si)).all()
                      & (pool.host_scale.index_select(0, di).view(
                          torch.int32) == sc.index_select(0, si).view(
                          torch.int32)).all()))
        return out

    pool.migrate_tiers = checked_migrate
    pool._evacuate_channel = compared_evacuate_channel
    shapes: dict = {}
    torch.cuda.synchronize()
    ds.reset_launches()
    with (sync_watch() if graphs else contextlib.nullcontext(Counter())) \
            as syncs, stream_shapes(shapes):
        t0 = time.perf_counter()
        outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool.check_invariants()
    if any(a is not b for a, b in zip(static[-3:], [
            pool.hbm, pool.host_q, pool.host_scale])) or (graphs and any(
            a is not b for a, b in zip(static, [*eng._dev.values(),
                                                *eng.cache.values()]))):
        fail("the tiered path rebound a static tensor")
    bad = [n for n, ok in moves if not bool(ok)]
    if bad:
        fail(f"evacuated rows changed in the move: {bad}")
    stored, lost = check_store(kv, pool, f"the tiered path (plan {plan})",
                               lost_ok=plan is not None)
    readings = {
        "served": {i: outs[r.rid].tolist() for i, r in enumerate(reqs)
                   if r.rid in outs},
        "failed": {i: r.error for i, r in enumerate(reqs)
                   if r.rid in eng.failed},
        "stats": eng.stats(), "paging": eng.paging_stats(),
        "kv_ops": kv.ops_done, "boundaries": boundaries[0],
        "evacuated_rows": sum(n for n, _ in moves),
        "store_blocks_checked": stored, "store_blocks_lost": lost,
        "launches": dict(ds.LAUNCHES),
        "shapes": {name: sorted([*s, n] for s, n in cnt.items())
                   for name, cnt in shapes.items()}}
    return {"readings": readings, "wall": wall, "syncs": dict(syncs),
            "engine": eng}


def tiered_pair(api, params, main: dict, what: str, plan=None) -> dict:
    """The tiered path graphed, then eager, on the same requests: every
    host-deterministic reading equal, survivors token for token the main
    path's tokens (which held against ``reference_decode``), no sync in
    the graphed run. Returns the graphed run's readings with both runs'
    wall times."""
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    runs = {mode: tiered_run(api, params, prompts, mode == "graphs", plan)
            for mode in ("graphs", "eager")}
    g, e = runs["graphs"]["readings"], runs["eager"]["readings"]
    for key in g:
        if g[key] != e[key]:
            fail(f"{what}: the graphed and eager runs differ in {key}: "
                 f"{g[key]} against {e[key]}")
    if runs["graphs"]["syncs"]:
        fail(f"{what}: the graphed run synced with the host: "
             f"{runs['graphs']['syncs']}")
    for i, toks in g["served"].items():
        if toks != main["tokens"][i].tolist():
            fail(f"{what}: request {i} served other tokens than the "
                 f"main path")
    for i, err in g["failed"].items():
        if err["kind"] not in ("poisoned_block", "evacuation_casualty",
                               "shed") or "step" not in err:
            fail(f"{what}: request {i} failed without a recoverable "
                 f"error: {err}")
    if len(g["served"]) + len(g["failed"]) != N_REQUESTS:
        fail(f"{what}: requests went missing")
    eng = runs["graphs"]["engine"]
    graph_lines(what, eng)
    tokens = sum(len(t) for t in g["served"].values())
    ts = g["paging"]["tiers"]
    out = {"readings": g, "graphs": {}, "eager": {}}
    for mode, run in runs.items():
        steps = run["engine"].decode_steps
        out[mode] = {"wall_s": run["wall"],
                     "tokens_per_s": tokens / run["wall"],
                     "wall_ms_per_decode_step": run["wall"] * 1e3 / steps}
    print(f"{what}: {len(g['served'])} of {N_REQUESTS} LLM requests served "
          f"token-exact beside the KV store on {TIER_SPEC} "
          f"({tokens} tokens, {out['graphs']['tokens_per_s']:.1f} tok/s "
          f"graphed, {out['eager']['tokens_per_s']:.1f} eager); "
          f"migrations={ts['migrations']} tier_speedup="
          f"{ts['tier_speedup']} faults={g['stats']['faults']} "
          f"failed={g['failed']} launches={g['launches']}", flush=True)
    return out


def tiered_line(name: str, out: dict) -> None:
    """Print a tiered path's host-deterministic readings (all but the
    tokens, which were held against the main path's) and its times as one
    JSON line, for later calls to hold."""
    r = out["readings"]
    line = {k: v for k, v in r.items() if k != "served"}
    line["served"] = len(r["served"])
    line.update({mode: out[mode] for mode in ("graphs", "eager")})
    if "plan" in out:
        line["plan"] = out["plan"]
    print(json.dumps({name: line}), flush=True)


def serve_tiered(api, params, main: dict) -> dict:
    """The tiered path without faults: migrations at the boundaries, all
    four channels carrying page-ins and page-outs, ``tier_speedup`` > 1."""
    out = tiered_pair(api, params, main, "tiered")
    g = out["readings"]
    ts = g["paging"]["tiers"]
    if ts["migrations"] <= 0:
        fail("the tiered path never migrated a block")
    idle = [name for name, ch in ts["channels"].items()
            if ch["page_in_blocks"] <= 0 or ch["page_out_blocks"] <= 0]
    if idle:
        fail(f"channels {idle} carried no page-ins or no page-outs")
    if not g["paging"]["tier_speedup"] > 1.0:
        fail(f"tier_speedup {g['paging']['tier_speedup']} is not above 1")
    if g["failed"] or g["boundaries"] <= 0:
        fail("the tiered path failed requests or had no boundary")
    for name, n in g["launches"].items():
        if n <= 0:
            fail(f"the tiered path never launched {name}")
    tiered_line("tiered", out)
    return out


def serve_faults(api, params, main: dict) -> dict:
    """The fault path: the tiered run under ``FAULT_PLAN`` (every
    recoverable kind fires) and under one seeded chaos schedule, each
    graphed against eager. Returns both runs' readings and times."""
    from repro_torch.core import faults as faults_lib
    out = {"fixed": tiered_pair(api, params, main, "faults", FAULT_PLAN)}
    out["fixed"]["plan"] = FAULT_PLAN
    f = out["fixed"]["readings"]["stats"]["faults"]
    want = {"injected": 4, "offline_channels": [3]}
    if any(f[k] != v for k, v in want.items()) or not (
            f["retried"] > 0 and f["quarantined"] > 0
            and f["evacuated"] > 0 and f["failed"] > 0):
        fail(f"the fault plan did not fire as planned: {f}")
    if out["fixed"]["readings"]["evacuated_rows"] != f["evacuated"]:
        fail("not every evacuated row was compared")
    from repro_torch.serve import EngineConfig
    plan = faults_lib.random_plan(CHAOS_SEED, n_channels=4,
                                  n_blocks=EngineConfig(
                                      **SERVE).resolved_pool_blocks(),
                                  horizon=CHAOS_HORIZON,
                                  n_events=CHAOS_EVENTS)
    out["chaos"] = tiered_pair(api, params, main, f"chaos{CHAOS_SEED}",
                               plan)
    out["chaos"]["plan"] = [dataclasses.asdict(e) for e in plan]
    if out["chaos"]["readings"]["stats"]["faults"]["injected"] < 1:
        fail("the chaos schedule never fired")
    tiered_line("faults", out["fixed"])
    tiered_line(f"chaos{CHAOS_SEED}", out["chaos"])
    return out


def check_tracks(tracer, what: str) -> None:
    """Every channel track's modelled-clock intervals in order, disjoint,
    and inside the horizon."""
    for track, ivals in tracer.timelines.items():
        end = -1.0
        for t0, dur, _, _ in ivals:
            if t0 < end - 1e-6 or dur < 0.0:
                fail(f"{what}: track {track} overlaps or runs backwards "
                     f"at {t0}")
            end = t0 + dur
        if end > tracer.model_us + 1e-6:
            fail(f"{what}: track {track} ends past the horizon")


def serve_traced(api, params) -> dict:
    """The tiered path and the fault-plan path with the tracing plane on,
    in turns with untraced runs (the tiered path untraced, traced, traced,
    untraced; the plan untraced, traced): every reading equal, no sync,
    the channel tracks monotonic, the modelled clock as the CPU rehearsal
    predicts, and the Perfetto export read back."""
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    out = {}
    for what, plan, order in (
            ("tiered", None, (False, True, True, False)),
            ("faults", FAULT_PLAN, (False, True))):
        runs = [tiered_run(api, params, prompts, True, plan, trace=t)
                for t in order]
        base = runs[0]["readings"]
        for traced, run in zip(order, runs):
            if run["readings"] != base:
                bad = [k for k in base if run["readings"][k] != base[k]]
                fail(f"traced {what}: a run (traced={traced}) differs "
                     f"from the untraced one in {bad}")
            if run["syncs"]:
                fail(f"traced {what}: a run (traced={traced}) synced "
                     f"with the host: {run['syncs']}")
        eng = runs[order.index(True)]["engine"]
        tracer = eng.tracer
        check_tracks(tracer, f"traced {what}")
        # the host-deterministic part: the modelled horizon and each
        # channel's shares, busy time, bytes and transactions
        reading = {"model_us": round(tracer.model_us, 3),
                   "duplex_util": tracer.duplex_util()}
        if reading != TRACE_EXPECT[what]:
            fail(f"traced {what}: the modelled clock {reading} differs "
                 f"from the CPU rehearsal's {TRACE_EXPECT[what]}")
        path = ROOT / "build" / f"trace_{what}.json"
        eng.export_trace(str(path))
        doc = json.loads(path.read_text())
        evs = doc["traceEvents"]
        n_x = sum(e["ph"] == "X" for e in evs)
        if n_x != len(tracer.spans) + sum(
                len(v) for v in tracer.timelines.values()) or \
                sum(e["ph"] == "i" for e in evs) != len(tracer.instants):
            fail(f"traced {what}: the Perfetto file lost events")
        tokens = sum(len(t) for t in base["served"].values())
        turns = [{"traced": t, "tokens_per_s": tokens / r["wall"],
                  "wall_s": r["wall"]} for t, r in zip(order, runs)]
        summary = tracer.summary()
        out[what] = {"phase_us": summary["phase_us"], **reading,
                     "events": summary["events"],
                     "instants": summary["instants"], "turns": turns,
                     "perfetto": str(path.relative_to(ROOT)),
                     "perfetto_events": len(evs)}
        print(json.dumps({f"traced_{what}": out[what]}), flush=True)
    return out


def sim_cases() -> dict:
    """Every simulation of the simulator path, by name: (channel preset,
    stream specs, policy, SimConfig fields, lockstep)."""
    from repro_torch.core import channel as ch
    from repro_torch.core.requests import StreamSpec
    prefill = [StreamSpec(name=f"chunk{i}", pattern="uniform",
                          offered_gbps=80.0 / 8, read_fraction=0.95)
               for i in range(8)]
    decode = [StreamSpec(name=f"layer{i}", pattern="llm_decode",
                         offered_gbps=120.0 / 8, phase_steps=32)
              for i in range(8)]
    cases = {}
    for name, specs in (("prefill", prefill), ("decode", decode)):
        for pol in ("cfs", "hinted"):
            cases[f"llm/{name}/{pol}"] = ("cxl-512gb", specs, pol,
                                          {"steps": 768}, False)
    for pattern in ("phased", "gaussian"):
        seq = pattern == "phased"
        for rf in SIM_RATIOS:
            specs = [StreamSpec(name=f"{pattern}{i}", pattern=pattern,
                                offered_gbps=64.0 / 8, read_fraction=rf,
                                phase_steps=64 if seq else 48 + 16 * (i % 4),
                                sequential=seq) for i in range(8)]
            for pol in ("cfs", "timeseries"):
                cases[f"micro/{pattern}/{rf}/{pol}"] = (
                    "cxl-512gb", specs, pol,
                    {"steps": 1024, "sequential": seq},
                    seq and pol == "timeseries")
    for name, c in ch.PRESETS.items():
        specs = [StreamSpec(name=f"w{i}", pattern="uniform",
                            offered_gbps=c.read_bw, read_fraction=0.55)
                 for i in range(4)]
        cases[f"char/{name}"] = (name, specs, "cfs", {"steps": 512}, False)
    for pol in SIM_POLICIES:
        if pol not in ("cfs", "hinted"):
            cases[f"llm/decode/{pol}"] = ("cxl-512gb", decode, pol,
                                          {"steps": 768}, False)
    return cases


def run_sim(case, device: str, graphs=None):
    from repro_torch.core import channel as ch
    from repro_torch.core import scheduler as sched
    name, specs, pol, kw, _ = case
    return sched.simulate(ch.PRESETS[name], specs, pol,
                          sim=sched.SimConfig(**kw), device=device,
                          _graphs=graphs)


def cpu_sims(path: str) -> int:
    """The simulator path's simulations on the CPU (``--cpu-sims``, run as
    a subprocess beside the card's work): their summaries, as JSON."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import scheduler as sched
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = {key: sched.summarize(run_sim(case, "cpu"))
           for key, case in sim_cases().items()}
    Path(path).write_text(json.dumps(
        {"summaries": out, "seconds": time.perf_counter() - t0}))
    return 0


def start_cpu_sims() -> tuple:
    """Start ``cpu_sims`` in a subprocess that cannot see the card."""
    path = ROOT / "build" / "sim_cpu.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--cpu-sims", str(path)], env=env)
    return proc, path


def simulate_phase(cpu: tuple) -> dict:
    """The simulator path on the card: every case replayed from its step
    graphs under the sync watch and held against the CPU's summaries; the
    ``SIM_EAGER`` cases also stepped eagerly on the card and held bit for
    bit (the timed one graphed and eager in turns); the timed case's
    capture and replays timed at each of ``SIM_BLOCKS``."""
    from repro_torch.core import channel as ch
    from repro_torch.core import scheduler as sched
    from repro_torch.device import sync_watch
    cases = sim_cases()
    got, syncs, bad = {}, Counter(), []
    t0 = time.perf_counter()
    results = {}
    for key, case in cases.items():
        with sync_watch() as s:
            res = run_sim(case, "cuda")
        syncs.update(s)
        results[key] = res
        got[key] = sched.summarize(res)
    graphed_s = time.perf_counter() - t0
    if syncs:
        bad.append(f"the simulator synced with the host: {dict(syncs)}")
    walls = {"graphs": [], "eager": []}
    for key in SIM_EAGER:
        modes = (("graphs", "eager", "eager", "graphs") if key == SIM_TIMED
                 else ("eager",))
        for mode in modes:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = run_sim(cases[key], "cuda", graphs=mode == "graphs")
            torch.cuda.synchronize()
            if key == SIM_TIMED:
                walls[mode].append((time.perf_counter() - t1) * 1e3)
            if not all(torch.equal(a, b)
                       for a, b in zip(results[key], res)):
                bad.append(f"simulator {key}: the {mode} run differs from "
                           f"the first graphed one on the card")
    proc, path = cpu
    if proc.wait(timeout=600) != 0:
        fail("the CPU simulations failed")
    cpu_out = json.loads(path.read_text())
    for key, (_, _, _, _, lockstep) in cases.items():
        want, have = cpu_out["summaries"][key], got[key]
        rtol = SIM_LOCKSTEP_RTOL if lockstep else SIM_SUMMARY_RTOL
        off = {m: (have[m], want[m]) for m in want
               if abs(have[m] - want[m]) > rtol * abs(want[m]) + 1e-9}
        if off or have["switches"] != want["switches"]:
            bad.append(f"simulator {key}: the card against the CPU "
                       f"(rtol {rtol}): {off}")
    imp = {"llm/prefill": sched.improvement(
        {p: got[f"llm/prefill/{p}"] for p in ("cfs", "hinted")},
        "hinted", "cfs"),
           "llm/decode": sched.improvement(
        {p: got[f"llm/decode/{p}"] for p in ("cfs", "hinted")},
        "hinted", "cfs")}
    for pattern in ("phased", "gaussian"):
        for rf in SIM_RATIOS:
            imp[f"micro/{pattern}/{rf}"] = sched.improvement(
                {p: got[f"micro/{pattern}/{rf}/{p}"]
                 for p in ("cfs", "timeseries")})

    # the timed case's capture and replays alone at each graph block size
    case = cases[SIM_TIMED]
    steps = case[3]["steps"]
    blocks = []
    for g in SIM_BLOCKS:
        scan = sched._Scan(ch.PRESETS[case[0]], case[1],
                           sched.policies_lib.get_policy(case[2]),
                           sched.PolicyParams(), sched.SimConfig(**case[3]),
                           torch.device("cuda"))
        graphs = sched.ScanGraphs(scan, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graphs.run()
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t1) * 1e3
        if not torch.equal(scan.result().moved_read,
                           results[SIM_TIMED].moved_read):
            fail(f"simulator: graph block {g} moved other bytes")
        blocks.append({"block": g, "capture_s": graphs.capture_s,
                       "replay_ms": run_ms,
                       "steps_per_s": steps / run_ms * 1e3})
    out = {
        "duplex_benefit": {name: ch.duplex_benefit(ch.PRESETS[name])
                           for name in ("cxl-512gb", "ddr5-local")},
        "improvement": imp,
        "policies": {p: got[f"llm/decode/{p}"] for p in SIM_POLICIES},
        "timed": SIM_TIMED, "steps": steps,
        "graphed_ms": walls["graphs"], "eager_ms": walls["eager"],
        "steps_per_s_graphed": steps / min(walls["graphs"]) * 1e3,
        "steps_per_s_eager": steps / min(walls["eager"]) * 1e3,
        "blocks": blocks, "block": sched.GRAPH_STEPS,
        "cases": len(cases), "all_graphed_s": graphed_s,
        "cpu_s": cpu_out["seconds"], "card": gpu_line()}
    print(json.dumps({"simulator": out}), flush=True)
    if bad:
        fail("; ".join(bad))
    return out


def profile_serving(api, params, main: dict, walls: dict) -> None:
    """How busy the card is on the main path, with the eager megastep and
    with the step graphs: the profiler's device time over one more run
    of the main path's requests in each mode, against the host wall clock
    of that mode's unprofiled runs (``megastep_turns``; their mean). The
    decode steps are the engine's count of the micro-steps it ran (each
    a ``decode_step``); a wrapped ``decode_step`` must count as many in
    the eager run and none in the graphed one (its graphs were captured
    before the profile). Also splits the device operations between the
    decoder and the rest (paging, engine bookkeeping) by profiling one
    ``decode_step`` at the engine's batch."""
    # one decode_step first: after a run's million-operation trace the
    # profiler has been seen to drop events of a later profile in the same
    # process (PERF.md); five calls, as for rwkv6-7b's step: windows of 20
    # (57,840 operations) came back short of a few to 342 operations in
    # four of five profiles in one run
    B = SERVE["max_batch"]
    cache = api.init_cache(B, SERVE["cache_len"])
    toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
    pos = torch.full((B,), PROMPT_LEN, dtype=torch.int32, device="cuda")
    dec_ms, dec_ops = device_profile(
        lambda: api.decode_step(params, cache, toks, pos), iters=5)
    out = {"requests": N_REQUESTS, "prompt": PROMPT_LEN, "gen": GEN,
           "decoder_ops_per_step": dec_ops, "decoder_ms_per_step": dec_ms}
    for mode in ("eager", "graphs"):
        calls = [0]

        def counted_decode(*a):
            calls[0] += 1
            return api.decode_step(*a)

        eng, rids = main["engine"](api._replace(decode_step=counted_decode),
                                   graphs=mode == "graphs")
        built = calls[0]
        got = {}
        t0 = time.perf_counter()
        count, ns, _ = _profile(lambda: got.update(eng.run()), iters=1)
        profiled_s = time.perf_counter() - t0
        if not count:
            fail(f"the profiler recorded no device time in the main "
                 f"path's {mode} run")
        if any(not np.array_equal(got[r], t)
               for r, t in zip(rids, main["tokens"])):
            fail(f"the profiled {mode} run of the main path served other "
                 f"tokens")
        n_decode = eng.decode_steps
        ran = calls[0] - built
        if ran != (0 if mode == "graphs" else n_decode):
            fail(f"the {mode} run called decode_step {ran} times for "
                 f"{n_decode} decode steps")
        busy_ms = sum(ns.values()) / 1e6
        ops = sum(count.values())
        stream_ms = sum(n for k, n in ns.items()
                        if "duplex_kernel" in k or "quant_kernel" in k) / 1e6
        wall_ms = float(np.mean(walls[mode])) * 1e3
        out[mode] = {
            "wall_ms": wall_ms, "profiled_wall_ms": profiled_s * 1e3,
            "tokens_per_s": sum(len(t) for t in main["tokens"])
            / wall_ms * 1e3,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "decode_steps": n_decode, "device_ops": ops,
            "device_ops_per_decode_step": ops / n_decode,
            "wall_ms_per_decode_step": wall_ms / n_decode,
            "decoder_share_of_ops": n_decode * dec_ops / ops,
            "decoder_share_of_device_ms": n_decode * dec_ms / busy_ms,
            "stream_kernels_ms": stream_ms}
    print(json.dumps({"serving_profile": out}), flush=True)


def build_all() -> None:
    """Build every kernel library, one nvcc each, all started together,
    and print their logs."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import vector_distance as vd
    from repro_torch.kernels import _build
    mods = (ds, vd, fa, rs)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 1) as pool:
        floor = pool.submit(_build.build, floor_source())
        logs = list(pool.map(lambda m: m.build(), mods))
        floor.result()
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for mod, log in zip(mods, logs):
        print(f"{mod.SOURCE.name}:\n{log.strip()}", flush=True)
    usage = {}
    for log in logs:
        usage.update(ptxas_usage(log))
    print(json.dumps({"ptxas": usage}), flush=True)
    spilled = {k: u for k, u in usage.items()
               if k in NO_SPILL and u["spill_stores"] + u["spill_loads"]}
    if spilled:
        fail(f"kernels spill to local memory: {spilled}")
    built = {mod for mod, log in zip(mods, logs) if log}
    if {ds, fa, rs} <= built and not NO_SPILL <= usage.keys():
        fail(f"ptxas reported no usage for {sorted(NO_SPILL - usage.keys())}")


def ptxas_usage(log: str) -> dict:
    """Registers, shared memory and spills per kernel instance from
    nvcc's ``-Xptxas -v`` log, keyed as ``name<N>`` (N the head dim or
    head size it is instantiated for; 1 or 0 for the stream kernels'
    16-byte or element path)."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?"
                      r"(flash_kernel_\w+?|wkv6_kernel|duplex_kernel|"
                      r"dequant_kernel|quant_kernel)IL[ib](\d+)E", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
            out[cur] = {"registers": 0, "smem_bytes": 0, "spill_stores": 0,
                        "spill_loads": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def main() -> int:
    if sys.argv[1:2] == ["--cpu-sims"]:
        return cpu_sims(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    cpu = start_cpu_sims()
    try:
        return card_main(cpu)
    finally:
        if cpu[0].poll() is None:
            cpu[0].kill()
        cpu[0].wait()


def card_main(cpu: tuple) -> int:

    print(f"card: {gpu_line()}", flush=True)
    # wall seconds of each phase, printed before the kernels line
    phase_s, last = {}, [time.perf_counter()]
    start = last[0]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now

    build_all()
    mark("build")
    D = 30 * 2 * 3 * 64          # kv_dims of smollm-135m FULL
    check_kernels([(2, 16, D), (8, 16, D), (32, 16, D), (3, 5, 1001)])
    check_l2([(4, 3, 16, 64), (1, 1, 8, 128), (8, 5, 32, 32),
              (4, 2, 16, D), (4, 32, 16, D), (3, 4, 16, 1001),
              (12, 2, 16, D)])
    sweep = [{k: row[k] for k in ("name", "shape", "ms", "plain_ms",
                                  "call_ms", "bound_ms")}
             for n in (2, 8, 32)
             for row in (measure(name, (n, 16, D)) for name in STREAMS)]
    sweep += [{k: row[k] for k in ("name", "shape", "ms", "plain_ms",
                                   "call_ms", "bound_ms")}
              for row in (measure_l2((4, n, 16, D)) for n in (2, 8, 32))]
    print(json.dumps({"kernel_sweep": sweep}), flush=True)
    kernels = [measure(name, PATH_SHAPES[name]) for name in STREAMS]
    kernels.append(measure_l2(PATH_SHAPES["l2_distance"]))
    mark("stream_and_l2_kernels")
    check_flash()
    # device_events takes a profile as measured only when two agree: the
    # profiler has been seen to drop this kernel's events (PERF.md)
    flash_row = measure_flash((4, 2048, 9, 3, 64), {})
    print(json.dumps({"flash_attention_paligemma": measure_flash(
        (2, 512, 8, 1, 256), {"prefix_len": 256})}), flush=True)
    # hd 80 and 112: no model of the port runs them, so no path launches
    # them; timed beside SDPA at a path shape of a config that has them
    print(json.dumps({"flash_attention_widths": [
        {"config": arch, **measure_flash(shape, {})}
        for arch, shape in FLASH_WIDTHS]}), flush=True)
    mark("flash_kernel")
    check_wkv6()
    wkv_row = measure_wkv6(WKV_CHECKS[-1][:4])
    mark("wkv6_kernel")

    api, params = full_model()
    shapes_seen: dict = {}
    launches, main_run = serve_full(api, params, shapes_seen)
    mark("serve")
    walls = megastep_turns(main_run)
    mark("megastep_turns")
    l2_shapes: Counter = Counter()
    tenant_launches = serve_tenants(api, params, l2_shapes)
    mark("tenants")
    tiered = serve_tiered(api, params, main_run)
    mark("tiered")
    faulted = serve_faults(api, params, main_run)
    tier_runs = {"tiered": tiered["readings"],
                 "faults": faulted["fixed"]["readings"],
                 f"chaos{CHAOS_SEED}": faulted["chaos"]["readings"]}
    # every shape the tiered and fault runs handed a stream kernel, held
    # against the plain version (the rows below are timed at the main
    # path's shapes)
    check_kernels(sorted({tuple(s[:3]) for r in tier_runs.values()
                          for rows in r["shapes"].values() for s in rows}))
    mark("faults")
    serve_traced(api, params)
    mark("traced")
    simulate_phase(cpu)
    mark("simulator")
    forward = {}
    for arch, B, S in FORWARD_RUNS:
        forward[arch] = forward_phase(arch, B, S)
        mark(f"forward_{arch}")
    torch.cuda.empty_cache()
    rwkv_api, rwkv_params, rwkv_forward = rwkv_forward_phase(*RWKV_FORWARD)
    mark("rwkv_forward")
    rwkv_serve = rwkv_serve_phase(rwkv_api, rwkv_params)
    mark("rwkv_serve")
    del rwkv_api, rwkv_params
    torch.cuda.empty_cache()

    seen = {name: shapes_seen[name].most_common(1)[0][0] for name in STREAMS}
    seen["l2_distance"] = l2_shapes.most_common(1)[0][0]
    if seen != PATH_SHAPES:
        fail(f"the serving paths handed the kernels {seen} most often; "
             f"their rows were measured at {PATH_SHAPES}")
    for row in kernels:     # the main path's runs, l2 the tenant path's
        row["launches"] = (tenant_launches if row["name"] == "l2_distance"
                           else launches)[row["name"]]
        if row["name"] in STREAMS:
            # the graphed tiered run and the graphed fixed-plan fault
            # run, each with the shape it handed the kernel most often
            for path in ("tiered", "faults"):
                r = tier_runs[path]
                row[f"launches_{path}"] = r["launches"][row["name"]]
                row[f"shape_{path}"] = max(r["shapes"][row["name"]],
                                           key=lambda s: s[3])[:3]
    # measured at the smollm-135m prefill shape; launched per forward
    flash_row["launches"] = forward["smollm-135m"]["launches"]
    flash_row["launches_paligemma"] = forward["paligemma-3b"]["launches"]
    kernels.append(flash_row)
    # measured at the rwkv6-7b prefill shape; launched per forward, never
    # in decode
    wkv_row["launches"] = rwkv_forward["launches"]
    wkv_row["launches_serving"] = rwkv_serve["wkv6_launches"]
    kernels.append(wkv_row)
    # last: after a trace of a million operations, the profiler has been
    # seen to record nothing of a later short profile of a kernel
    mark("kernel_rows")
    profile_serving(api, params, main_run, walls)
    mark("serving_profile")
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": time.perf_counter() - start}), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
