"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version on the card (``wkv6``'s backward too;
``flash_attention`` also at head dims
80, 112 and 128, timed at a stablelm-3b, a kimi-k2, a llama3.2-3b and a
windowed mixtral-8x7b prefill shape; the stream kernels also at the MoE
paths' row widths), records beside the short kernels the
device time of an empty kernel launched at the same geometry (the launch
floor), and drives two serving paths at full
width (smollm-135m: 30 layers, d_model 576, vocab 49152; random seeded
weights), the full-sequence forward of ten models and the serving of
rwkv6-7b, mixtral-8x7b, kimi-k2-1t-a32b, zamba2-7b and whisper-base,
each with the launch counters set to 0 just before it and read just
after:

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
    eager megastep, which must serve the same (``serve_unpaged``: no
    kernel may launch);
  * the MoE paths: mixtral-8x7b (16 of its 32 layers, 46.97 GB) and
    kimi-k2-1t-a32b (1 of its 61 layers, 38.8 GB), at the published
    widths, weights drawn on the card, one at a time: each served through
    the paged pool with the main path's settings and its first 8 requests
    (graphed under the sync watch, then eager: token-exact vs
    ``reference_decode``, the same tokens, stats and paging both ways,
    the three stream kernels launched at row widths 32768 and 1792, no
    host sync), then one
    forward (mixtral at B=1, S=8192, past its 4096-token window; kimi-k2
    at B=1, S=2048, hd 112) that must launch ``flash_attention`` once per
    layer, with logits within ``LOGITS_ATOL`` of the plain forward on the
    kernel forward's routing and a control beyond it;
  * the Zamba2 paths: zamba2-7b FULL (81 Mamba2 layers, d_model 3584, a
    shared attention block applied 13 times; 13.5 GB of weights drawn on
    the card) served as the RWKV path is at a batch of 8, its nested
    cache (Mamba state kept per row, attention rings written in place) on
    the step graphs; then one forward at B=1, S=512 (cut from its 4096
    context: the SSD scan is a Python loop), whose first 32 positions
    must equal 32 ``decode_step``s in f32 against a control fault;
  * the Whisper path: whisper-base FULL served the same way (self rings
    in place, cross K/V zeros as the reference serves them), then one
    forward at B=2 over 1500 stub frames and 448 decoder tokens;
  * the snapshot path: the main path's run with a crash-consistent cut
    every ``SNAP_EVERY`` megasteps (its flushes through ``quant_stream``),
    then the same run killed by ``crash:@S`` halfway through and restored
    into a fresh graphed engine (and, flat, into an eager one): the
    restored run's signature (tokens, admission and done steps, billing
    per path and per channel, fault stats, ``tier_speedup``), cut count
    and final pool bytes equal the uncrashed run's, the restore writes
    the static tensors in place, and the host syncs only at the snapshot
    and checkpoint sites; flat, then on ``TIER_SPEC``; every stream shape
    the runs hand a kernel is held against the plain version;
  * the dense-width path: one full-width forward each of llama3.2-3b,
    qwen2.5-14b and stablelm-3b (weights drawn on the card), which must
    launch ``flash_attention`` once per layer (head dims 128, 128, 80)
    with logits within ``LOGITS_ATOL`` of the plain forward's and a
    control beyond it;
  * the training path (before the snapshot phase): smollm-135m FULL
    trained by ``Trainer`` (device AdamW, 20 steps of 8 x 2048 tokens:
    every loss finite, the loss falling, no kernel launched); its host
    optimizer (moments pinned in host memory, streamed leaf by leaf)
    against device AdamW in f32, parameters within 1e-5, with the
    modelled link report beside the measured round trip; rwkv6-7b at
    full width cut to ``RWKV_TRAIN_LAYERS`` layers, trained with the host
    optimizer through the ``wkv6`` forward and backward kernels (each
    once per layer a step; every leaf, and each of ``mu``'s five rows,
    with a finite non-zero gradient); and its gradient at two layers in
    f32 against autograd through the plain loop. The ``wkv6_backward``
    kernel is held against ``ref.wkv6_backward`` beside the forward's
    checks (hs 16, 32, 128, a ragged S, the design's segment and sub-chunk
    edges, the training shape, and a control that must fail), its
    geometry against ``rwkv6_scan.backward_geometry``, and timed beside
    the forward at the training shape;
  * training at full width for the other families (after the rwkv6-7b
    phases, before the dry-run), each with no kernel launched (the
    reference's training loss runs none), every loss finite and the first
    step's gradient finite and non-zero on every leaf: mixtral-8x7b cut
    to ``MIXTRAL_TRAIN_LAYERS`` layers with the host optimizer (its
    moments pinned after a check of the host's RAM), then its first
    layer's expert gradients through ``_BmmF32`` against the CPU's f32
    product of the step's operands (``MOE_GRAD_COLUMNS`` of the ffn
    columns) within ``BMM_F32_RTOL``, a control (the bf16 product)
    beyond; zamba2-7b cut to two applications of its shared block, then
    its f32 gradient at one application against the same step on the CPU
    within ``ZAMBA_GRAD_TOL``, a control (the Mamba state zeroed halfway)
    beyond; paligemma-3b (18 layers) and whisper-base FULL, device AdamW,
    the loss falling;
  * the examples (``repro_torch.examples``): each ``main`` on the card,
    its closing line printed, ``duplex_kv_stream`` launched by
    ``serve_offload`` and ``multi_tenant_serve`` (``l2_distance`` too),
    ``duplex_tour``'s fused output held against the two halves and the
    plain version, both routes timed; the serve CLI's ``--offload-demo``
    (the deprecated ``OffloadedKVCache`` shim) on the card and on the
    CPU, with equal reports;
  * the dry-run path (after training, before the snapshot phase): the
    multi-pod dry-run's ``trace_cell`` (``launch/dryrun.py``) on a (1, 1)
    mesh of its fake process group for smollm-135m ``train_4k`` at B=4,
    llama3.2-3b ``decode_32k`` at B=8 (30 GB of cache) and rwkv6-7b
    ``train_4k`` at B=2 on two layers, traced on the host by a
    subprocess started first (``--dryruns``) as the port's own step (no
    shard env, no unroll knob), then each step run for real on the card
    as a user runs it (``dryrun_vs_card``): FLOPs equal to
    ``FlopCounterMode``'s, argument bytes equal, the peak within
    ``PEAK_RTOL``, no roofline bound above the profiled device time;
    ``remat_on_card``: rwkv6-7b's gradient with remat equal to it
    without, ``wkv6`` recomputed once per layer; and three production
    cells of the dry-run (``dryrun_cells``), which must end ``ok``;
  * the sharded path (right after the main path): the main path's
    requests on ``ShardedServeEngine`` over (1, 1), (2, 1) and (2, 2)
    meshes of logical ranks on the card, each rank on its own step
    graphs, each pool shard holding the flat pool's HBM split over the
    data ranks: the flat engine's tokens and admission/done steps,
    invariants after every boundary, ICI bytes exactly on the axes of
    size > 1, no sync but one readback per dispatched megastep, and the
    stream kernels' launches per shard as the CPU rehearsal counts them;
    then (2, 2) graphed and eager on 8 requests, which must serve and
    page the same.

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
import gc
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

# the sharded path: the main path's requests on ShardedServeEngine over
# these (data, model) meshes of logical ranks on the card, each graphed;
# then (2, 2) graphed and eager on the first 8 requests, 16 tokens each,
# 12 HBM blocks a shard so that every shard pages (eager runs are
# host-bound: four eager ranks take ~25 s on these 128 tokens)
SHARD_MESHES = ((1, 1), (2, 1), (2, 2))
SHARD_EAGER = (8, 16, 12)
# the stream kernels' launches of each graphed sharded run, in all and by
# pool shard: from the CPU rehearsal at the full width's byte counts (the
# flat main path launches 30 / 2 / 4)
SHARD_EXPECT = {
    (1, 1): {"launches": {"duplex_kv_stream": 30, "quant_stream": 2,
                          "dequant_stream": 4},
             "shard_kernel_calls": [36]},
    (2, 1): {"launches": {"duplex_kv_stream": 39, "quant_stream": 4,
                          "dequant_stream": 21},
             "shard_kernel_calls": [32, 32]},
    (2, 2): {"launches": {"duplex_kv_stream": 39, "quant_stream": 4,
                          "dequant_stream": 21},
             "shard_kernel_calls": [32, 32]},
}

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

# the snapshot path: the main path's run with a crash-consistent cut every
# SNAP_EVERY megasteps, written under build/, then the same run killed by
# crash:@S at the pool transaction halfway through it (S from the
# uncrashed run's transaction clock) and restored into a fresh engine;
# flat, then on TIER_SPEC without a tenant. The six cuts of the
# uncrashed run flush 0, 12, 20, 7, 28 and 6 dirty blocks (the CPU
# rehearsal at full-width byte counts); FLUSH_SHAPE is the largest flush,
# at which quant_stream's flush row is timed (main() fails if the card's
# largest is another).
SNAP_EVERY = 8
SNAP_DIR = ROOT / "build" / "snapshots"
FLUSH_SHAPE = (28, 16, 11520)

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
    # the gradient of that kernel's function; the Pallas wkv6 has no
    # backward (the reference trains through its plain wkv_scan,
    # src/repro/models/rwkv6.py:100, which jax.grad differentiates)
    "wkv6_backward": "src/repro/kernels/rwkv6_scan.py:70",
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
    # head dim 128 at the llama3.2-3b (24 heads on 8) and qwen2.5-14b (40
    # on 8) prefill shapes, which the dense-width path runs
    (1, 2048, 24, 8, 128, torch.bfloat16, {}),
    (1, 2048, 40, 8, 128, torch.bfloat16, {}),
    # mixtral-8x7b's forward on the MoE path: 32 heads on 8, a window of
    # 4096 at S=8192 (kimi-k2's hd-112 shape is above)
    (1, 8192, 32, 8, 128, torch.bfloat16, {"window": 4096}),
]

# the tensor-core body at the path shapes, held tighter than 3e-2, which
# is about the size of |o| itself in the last rows at S = 2048 (~0.03):
# in every 64-query block of each (batch, head), the kernel's max abs
# error against ref.attention may exceed that of one
# scaled_dot_product_attention call on the same inputs (which rounds P to
# bf16 too) by at most FLASH_TC_ULPS bf16 ulps of the block's largest
# |o|. A control, ref.attention with the last 64 queries losing their
# first 64 keys (a window of S - 64: one kv tile; under a window W, every
# query past W - 64 losing its oldest 64), must break it.
FLASH_PATH = {(4, 2048, 9, 3, 64), (2, 512, 8, 1, 256), (1, 2048, 32, 32, 80),
              (1, 2048, 64, 8, 112), (1, 2048, 24, 8, 128),
              (1, 2048, 40, 8, 128), (1, 8192, 32, 8, 128)}
# the head dims beyond the serving and forward paths' 64 and 256, timed at
# a prefill shape of a config of the repo that has them (causal, S =
# 2048): stablelm-3b (d_model 2560, 32 heads of 80), kimi-k2 (64 heads of
# 112 on 8 kv heads) and llama3.2-3b (24 heads of 128 on 8); and
# mixtral-8x7b's forward shape (32 heads of 128 on 8, S = 8192, a window
# of 4096)
FLASH_WIDTHS = [("stablelm-3b", (1, 2048, 32, 32, 80), {}),
                ("kimi-k2-1t", (1, 2048, 64, 8, 112), {}),
                ("llama3.2-3b", (1, 2048, 24, 8, 128), {}),
                ("mixtral-8x7b", (1, 8192, 32, 8, 128), {"window": 4096})]
FLASH_TC_ULPS = 1

# the forward path: (arch, batch, sequence); paligemma's first 256
# positions are the stub patch embeddings, then 256 text tokens
FORWARD_RUNS = [("smollm-135m", 4, 2048), ("paligemma-3b", 2, 512)]
# the dense-width path: one full-width forward each of the other dense
# configs, with the kernel and without (arch, batch, sequence); their head
# dims are 128, 128 and 80, weights drawn on the card
DENSE_RUNS = [("llama3.2-3b", 1, 2048), ("qwen2.5-14b", 1, 2048),
              ("stablelm-3b", 1, 2048)]
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
# the wkv6 backward against ref.wkv6_backward on the card, each gradient
# within WKV_BWD_TOL of its largest magnitude: (B, S, H, hs, draw w and u
# as the model does). hs 16, 32 and 128, a ragged S (1000 is no multiple
# of the kernel's 64-step segment nor of its 8-step sub-chunk); the
# design's edges at hs 64: S = 1, one sub-chunk less a step (7), one
# segment (64) and a step more (65); S = 203, a multiple of neither, at hs
# 16 and 128; and last the path shape: the rwkv6-7b training shape
# (B, S) = RWKV_TRAIN, 64 heads of 64
WKV_BWD_CHECKS = [
    (2, 64, 2, 16, False), (1, 128, 3, 32, False), (1, 96, 2, 128, True),
    (2, 1000, 3, 64, True), (1, 1, 2, 64, True), (2, 7, 2, 64, True),
    (1, 64, 3, 64, True), (2, 65, 2, 64, True), (1, 203, 3, 16, True),
    (1, 203, 2, 128, True), (2, 4096, 64, 64, True),
]
WKV_BWD_TOL = 1e-4
# the training path. smollm-135m FULL: Trainer steps at a global batch of
# 8 sequences of 2048 tokens (its published context), warm-up 2, peak lr
# 1e-3 (the reference CLI's 3e-4 moves a random model's loss too little
# in 20 steps to gate on); host against device AdamW for
# TRAIN_PARITY_STEPS steps each
SMOLLM_TRAIN = dict(global_batch=8, seq_len=2048, steps=20)
# the dry-run against the card: (arch, shape cell, batch, layers) traced on
# a (1, 1) mesh and run for real; the production cells traced on the host
DRYRUN_CARD_CELLS = [("smollm-135m", "train_4k", 4, None),
                     ("llama3.2-3b", "decode_32k", 8, None),
                     ("rwkv6-7b", "train_4k", 2, 2)]
DRYRUN_CELLS = [("qwen2.5-14b", "decode_32k", "pod"),
                ("mixtral-8x7b", "train_4k", "multipod"),
                ("rwkv6-7b", "prefill_32k", "pod")]
# the caching allocator's largest rounding of one tensor: 512 bytes in the
# small pool, and a large block keeps a remainder under 1 MiB unsplit
ALLOC_ROUND = 1 << 20
# predicted peak against max_memory_allocated (relative), set from the
# readings of the design as it stands (H100 80GB HBM3, 700 W; PERF.md)
PEAK_RTOL = 0.02
DRYRUN_WAIT_S = 900
# remat on the card: rwkv6-7b's gradient, and a smollm-135m step
REMAT_RWKV = (2, 4096)
REMAT_TOL = 1e-6
REMAT_SMOLLM = (8, 2048)
SMOLLM_WARMUP, SMOLLM_LR = 2, 1e-3
TRAIN_PARITY_STEPS = 3
# rwkv6-7b at full width (d_model 4096, 64 heads of 64, vocab 65536) with
# the host optimizer: cut to RWKV_TRAIN_LAYERS of its 32 layers at (B, S)
# = RWKV_TRAIN (its context), for RWKV_TRAIN_STEPS steps. The peak was
# 49.0 GB at 8 layers (PERF.md), ~5 GB of it a layer (autograd
# residuals at B*S = 8192 tokens): 12 layers take ~69 GB of the 80, 13
# would take ~74; the moments of 12 layers are 25 GB of pinned host RAM
RWKV_TRAIN = (2, 4096)
RWKV_TRAIN_LAYERS = 12
RWKV_TRAIN_STEPS = 3
# rwkv6-7b's gradient through the kernels against the plain loop's
# (autograd through wkv_scan), f32 weights, TF32 off, each leaf within
# RWKV_GRAD_TOL of its largest magnitude: FULL width at RWKV_GRAD_LAYERS
# layers, (B, S) = RWKV_GRAD
RWKV_GRAD = (1, 512)
RWKV_GRAD_LAYERS = 2
RWKV_GRAD_TOL = 1e-3
# training on the card at the published widths, depth cut only as far as
# one card forces it (each cut in the line's ``reduced``); the training
# loss runs no kernel in the reference (``loss_fn(..., use_kernel=False)``)
# and launches none here. mixtral-8x7b with the host optimizer (the
# paper's capacity case) at (B, S) = MIXTRAL_TRAIN: its 4096-token window
# and the dry-run's train_4k. A layer is 1.4513 B parameters, 2.90 GB in
# bf16: 5.80 GB a layer on the card with its bf16 gradients, and 11.61 GB
# a layer of f32 moments in pinned host RAM (the untied 32000 x 4096
# embedding and head add 0.52 GB, 2.10 GB of moments). The host's
# MemAvailable read 96.3 GB at the rwkv6-7b training phase (PR 26's chip
# calls, H100 80GB HBM3, 700 W): 0.6 of it, 57.8 GB, holds the moments of
# 4 layers (48.5 GB), not of 5 (60.2 GB). On the card 4 layers are 12.1
# GB of parameters, as much of gradients and of clipped gradients while
# the optimizer runs, and its 64 MB chunks (the host optimizer streams a
# leaf chunk by chunk; whole leaves took about ten f32 copies of the 7.5
# GB expert stack, which held the cut to 2 layers); with the activations
# at 4096 tokens the peak read 61.5 GB (chip call 1 of PR 27, H100 80GB
# HBM3, 700 W), so the card would take a fifth layer, the host's RAM not
MIXTRAL_TRAIN = (1, 4096)
MIXTRAL_TRAIN_LAYERS = 4
MIXTRAL_TRAIN_STEPS = 2
MIXTRAL_CONTEXT = 32768        # the published context, for ``reduced``
# zamba2-7b with device AdamW at (B, S) = ZAMBA_TRAIN (the SSD scan is a
# Python loop under autograd, keeping a (B, H, P, N) f32 state per step
# per layer, ~1.8 MB a step and 0.94 GB a layer at S = 512), cut to the
# fewest layers that hold two applications of the shared attention block
# (``attn_every`` 6): 12 of 81. Its step is
# host-bound, ~306 K device operations in 7.3-9.8 s of wall at S = 512
# (chip calls 1-2 of PR 27, H100 80GB HBM3, 700 W), so for the run's time
# it takes 2 steps (cut from 3) at S = 256 (cut from its forward phase's
# 512)
ZAMBA_TRAIN = (1, 256)
ZAMBA_TRAIN_LAYERS = 12
ZAMBA_TRAIN_STEPS = 2
ZAMBA_CONTEXT = 4096
# zamba2-7b's gradient in f32 (TF32 off) on the card against the same step
# on the CPU: full width, the fewest layers that hold one application of
# the shared block, (B, S) = ZAMBA_GRAD; each leaf within ZAMBA_GRAD_TOL of
# its largest; the control, the Mamba state zeroed halfway through the
# sequence, must exceed it
ZAMBA_GRAD = (1, 64)
ZAMBA_GRAD_LAYERS = 6
ZAMBA_GRAD_TOL = 1e-4
# paligemma-3b (all 18 layers; B=2, 256 stub patch embeddings as the
# prefix and 256 text tokens, its forward phase's shape) and whisper-base
# FULL (B=2, 1500 stub frames, 448 decoder tokens: Whisper's n_audio_ctx
# and n_text_ctx), device AdamW (paligemma: 2.51 B parameters x 12 bytes,
# 30 GB with its moments; the chunked update keeps its peak at 60.7 GB),
# TRAIN_STEPS steps at the smollm phase's warm-up; the mean loss of the
# last TRAIN_FALL steps must be below that of the first TRAIN_FALL.
# whisper-base takes the smollm phase's peak lr; paligemma-3b
# PALIGEMMA_LR: at 1e-3 its loss rose to 17.3 at step 3 before falling to
# 5.8, at 1e-4 it peaked at 12.7 and fell to 7.4 (chip call 3 of PR 27,
# H100 80GB HBM3, 700 W), Adam's first steps moving its 2048- and
# 16384-wide products further
PALIGEMMA_TRAIN = (2, 512)
PALIGEMMA_LR = 1e-4
WHISPER_TRAIN = (2, 1500, 448)
TRAIN_STEPS = 10
TRAIN_FALL = 3
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
# the nested-cache serving paths (zamba2-7b, whisper-base FULL): the RWKV
# path's requests and engine settings at a batch of 8
NESTED_SERVE = dict(RWKV_SERVE, max_batch=8)
# zamba2-7b's forward at (batch, sequence): cut to 512 of its 4096 context
# tokens, since the SSD scan is a Python loop over time (81 layers x 512
# steps of ~10 operations: ~0.4 M launches a forward)
ZAMBA_FORWARD = (1, 512)
# the forward's first positions held against as many decode_steps, with
# the weights in f32 (TF32 off), within the CPU test's f32 tolerance of
# decode against the forward (tests/test_torch_hybrid.py: atol = rtol =
# 1e-4). On an H100 the f32 gap was 6.1e-5 and the bf16 one 0.258 (PERF.md,
# PR 21): bf16 rounding through 81 random-weight layers, past the CPU
# test's bf16 1e-2, so bf16 is recorded, not gated.
ZAMBA_DECODE_CHECK = 32
ZAMBA_F32_TOL = 1e-4
# whisper-base's forward: (batch, stub frames, decoder tokens); 1500 and
# 448 are Whisper's published n_audio_ctx and n_text_ctx, so no cut
WHISPER_FORWARD = (2, 1500, 448)
# the MoE paths: (arch, layers kept, the published config's num_layers,
# d_model, num_heads, num_kv_heads, d_ff, vocab, experts, top_k, window,
# and the forward's batch and sequence). Widths are the published ones;
# depth is cut to fit the card's 80 GB. mixtral-8x7b's 32 layers are 93.4
# GB in bf16 (1.4513 B parameters a layer, an untied 32000 x 4096
# embedding and head): 16 layers are 46.97 GB. One layer of
# kimi-k2-1t-a32b is 17.03 B parameters, 16.91 B of them its 384 experts
# (34.05 GB), and its untied 163840 x 7168 embedding and head add 4.70
# GB: 38.8 GB in all, where two layers would be ~72.8 GB before any
# activation. The forwards: mixtral at S=8192, past its 4096-token
# window; kimi-k2 at S=2048, the hd-112 row's shape. Each is served at
# the main path's SERVE settings (max_batch 8: the capacity of 8 slots an
# expert is at least the batch, so no slot is dropped and rows do not
# interact).
MOE_RUNS = [
    ("mixtral-8x7b", 16, (32, 4096, 32, 8, 14336, 32000, 8, 2, 4096),
     (1, 8192)),
    ("kimi-k2-1t-a32b", 1, (61, 7168, 64, 8, 2048, 163840, 384, 8, None),
     (1, 2048)),
]
# the MoE serving paths serve the first MOE_REQUESTS of the main path's
# requests (one batch of max_batch: the reference decode, host-bound at
# these depths, runs once, and so does the eager megastep's pass), still
# oversubscribing the pool both ways
MOE_REQUESTS = 8
# the MoE experts' gate and up products (``layers._bmm_f32``: cuBLAS
# writes f32 from bf16 operands) against the f32 product of the same bf16
# values, relative to the largest |product|: the two differ only in the
# order of f32 sums (~1e-6 relative at 7168 terms), where rounding the
# product to bf16, the control, is ~2**-9 off
BMM_F32_RTOL = 1e-4
# the ffn columns of mixtral-8x7b's expert gradients that the CPU takes
# in f32 to check the card's (moe_expert_grads): 2048 of 14336, 0.7-2.2 s
# a product on the card machine's host, where the whole two products took
# 35 s (chip calls 9, 10 and 14 of PR 27, H100 80GB HBM3, 700 W)
MOE_GRAD_COLUMNS = 2048
# the stream kernels' row widths on the MoE serving paths, as cut:
# kv_dims = layers x 2 x kv heads x hd (32768 and 1792)
MOE_KV_DIMS = {arch: layers * 2 * dims[3] * (dims[1] // dims[2])
               for arch, layers, dims, _ in MOE_RUNS}
# kernel instances whose -Xptxas -v report must show no spills: the
# tensor-core flash body at every head dim, wkv6 at the path's hs, and the
# stream kernels' 16-byte path (<1>), held to 64 registers by their launch
# bounds so that two blocks fit an SM (duplex_stream.WAVE_BLOCKS)
NO_SPILL = {"flash_kernel_tc<64>", "flash_kernel_tc<80>",
            "flash_kernel_tc<112>", "flash_kernel_tc<128>",
            "flash_kernel_tc<256>", "wkv6_kernel<64>",
            "wkv6_backward_kernel<64>", "duplex_kernel<1>",
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
# clock cycles of each spin kernel queued after a window's sync (~6 µs):
# 32 of them outlast the 52 short operations a window has lost there
LEAD_CYCLES = 10_000
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
        # kernels, which the counts leave out, before the sync and after
        # it (the first 1-52 operations queued after the sync were lost
        # in four runs, PR 21; a held window starts with its hold spin)
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(LEAD_CYCLES)
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


def stream_ms(fn) -> float:
    """One call of ``fn`` timed by CUDA events on the current stream."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


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
    which must exceed the limit (under a window W, a window of W - 64)."""
    from repro_torch.kernels import ref
    B, S, H, hd = q.shape
    blocks = lambda x: x.float().view(B, S // 64, 64, H, hd).amax((2, 4))
    top = blocks(want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp(min=2.0 ** -126)))
                     - 7)
    lib_err = blocks((sdpa_call(q, k, v, mask)().transpose(1, 2).float()
                      - want.float()).abs())
    control = ref.attention(q, k, v, **{
        **mask, "window": (mask.get("window") or S) - 64})
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


def wkv_grad_inputs(B, S, H, hs, seed: int, model_like: bool):
    """``wkv_inputs`` and an upstream gradient dout N(0, 1), on the card."""
    x = wkv_inputs(B, S, H, hs, seed, model_like)
    g = torch.Generator().manual_seed(seed + 1)
    return (*x, torch.randn((B, S, H, hs), generator=g).cuda())


def grad_shares(got, want) -> list:
    """Per gradient (dr, dk, dv, dw, du): the largest absolute difference
    over the largest magnitude of ``want``'s."""
    out = []
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != torch.float32:
            fail(f"wkv6_backward returned {tuple(a.shape)} {a.dtype}, want "
                 f"{tuple(b.shape)} f32")
        out.append((a - b).abs().max().item()
                   / max(b.abs().max().item(), 1e-30))
    return out


def check_wkv6_backward() -> dict:
    """The wkv6 backward kernel against ref.wkv6_backward at every shape
    of WKV_BWD_CHECKS, each of dr, dk, dv, dw, du within WKV_BWD_TOL of
    that gradient's largest magnitude; at the path shape a control, the
    kernel's gradients for dout shifted by one step, must exceed it.
    Returns the path shape's shares and the control's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, (B, S, H, hs, model_like) in enumerate(WKV_BWD_CHECKS):
        x = wkv_grad_inputs(B, S, H, hs, seed=400 + i,
                            model_like=model_like)
        want = ref.wkv6_backward(*x)
        shares = grad_shares(rs.wkv6_backward(*x), want)
        torch.cuda.synchronize()
        where = f"B,S,H,hs = {B},{S},{H},{hs}"
        if max(shares) > WKV_BWD_TOL:
            fail(f"wkv6_backward differs from the plain version at {where}: "
                 f"max abs / max |grad| of dr, dk, dv, dw, du {shares}")
        print(f"wkv6_backward matches the plain version at {where} "
              f"(max abs / max |grad|: {[f'{e:.3g}' for e in shares]})",
              flush=True)
    shifted = torch.roll(x[5], 1, dims=1)
    control = grad_shares(rs.wkv6_backward(*x[:5], shifted), want)
    if max(control) <= WKV_BWD_TOL:
        fail(f"the control (dout shifted one step) passed the wkv6_backward "
             f"gate: {control}")
    print(f"wkv6_backward control (dout shifted one step): "
          f"{[f'{e:.3g}' for e in control]}", flush=True)
    return {"shares": shares, "control_shares": control}


def backward_geometry_on_card() -> dict:
    """The backward kernel's geometry as its source sets it
    (``wkv6_backward_geometry``) for each head size, held equal to
    ``rwkv6_scan.backward_geometry``: the shared memory the Python side
    budgets is the kernel's own."""
    import ctypes

    from repro_torch.kernels import rwkv6_scan as rs
    lib = rs._load()
    keys = ("threads", "rows", "cols", "sub", "seg", "slices", "stages",
            "smem_bytes")
    out = {}
    for hs in rs.HEAD_SIZES:
        buf = (ctypes.c_longlong * len(keys))()
        if lib.wkv6_backward_geometry(hs, buf) != 0:
            fail(f"wkv6_backward_geometry refused hs {hs}")
        card = dict(zip(keys, buf))
        want = {k: rs.backward_geometry(hs)[k] for k in keys}
        if card != want or card["smem_bytes"] > rs.SMEM_LIMIT:
            fail(f"wkv6_backward geometry at hs {hs}: the kernel's {card}, "
                 f"the wrapper's {want}")
        out[hs] = card
    return out


def measure_wkv6_backward(shape, checked: dict, forward_ms: float) -> dict:
    """Time the wkv6 backward kernel (its call: the kernel and the sum of
    du's partials over b) at (B, S, H, hs) with the model's w and u, as
    ``measure_wkv6`` times the forward, and its plain version by CUDA
    events over one call (``stream_ms``). Bound: r, k,
    v, w, dout read and dr, dk, dv, dw written once (and u, du) against
    3.35 TB/s, and the fewest f32 operations the function needs, 14 hs^2
    per (b, t, h) (the state recomputed, 3; dout*S, G*v, G*k and G*S with
    their sums, 8; the G update, 3) plus 16 hs (the bonus terms and du),
    against 67 TFLOP/s on CUDA cores. Beside it: the design's own count
    (pass 1's walk, 3 hs^2; the segment's forward walk, 3 (seg - sub) /
    seg; a sub-chunk's recomputation, 3 (sub - 1) / sub; the walk back,
    11: 19.25 hs^2 at seg 64, sub 8) and its time at that rate; the
    checkpoint bytes it moves beyond the bound's (written once, read
    once); its launches a call; and its time over ``forward_ms``, the
    forward kernel's at the same shape in this run (device times move
    between runs; the ratio less). No single PyTorch call computes it:
    no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rs
    B, S, H, hs = shape
    x = wkv_grad_inputs(B, S, H, hs, seed=98, model_like=True)
    fn = lambda: rs.wkv6_backward(*x)
    plain = lambda: ref.wkv6_backward(*x)
    err = max((a - b).abs().max().item() for a, b in zip(fn(), plain()))
    geo = rs.backward_geometry(hs, B, S, H)
    seg, sub = geo["seg"], geo["sub"]
    n = B * S * H
    flops = (14 * hs * hs + 16 * hs) * n
    design_per = 3 + 3 * (seg - sub) / seg + 3 * (sub - 1) / sub + 11
    design_flops = (design_per * hs * hs + 16 * hs) * n
    ckpt_bytes = 2 * 4 * geo["scratch_floats"]
    nbytes = 4 * (9 * n * hs + 2 * H * hs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    t_design = design_flops / FP32_OPS_PER_S * 1e3
    before = rs.LAUNCHES["wkv6_backward"]
    fn()
    launches_per_call = rs.LAUNCHES["wkv6_backward"] - before
    ms, per_call, ev = median(paired_profile, fn, iters=5,
                              per_call={"wkv6_backward_kernel": 1})
    # the plain version's ~140,000 small operations a call lose events in
    # the profiler: one call by CUDA events (host-bound; the comparison
    # above was its warm-up)
    plain_ms = stream_ms(plain)
    print(f"wkv6_backward at {shape}: device ms (profiler) {ms:.4f}, stream "
          f"ms (CUDA events, stream held) {ev:.4f}, plain (CUDA events) "
          f"{plain_ms:.4f}, bound {bound:.4f} ({t_bytes:.4f} by bytes, "
          f"{t_ops:.4f} by operations; the design's {design_per:g} hs^2 "
          f"a (b, t, h): "
          f"{t_design:.4f}), checkpoints {ckpt_bytes / 1e9:.4f} GB, "
          f"{launches_per_call} launch a call, {ms / forward_ms:.3f} x the "
          f"forward's {forward_ms:.4f} ms", flush=True)
    if launches_per_call != 1:
        fail(f"wkv6_backward: {launches_per_call} launches a call, want 1")
    if ms < bound or abs(ms - ev) > FLASH_EVENT_SHARE * ev:
        fail(f"wkv6_backward at {shape}: {ms} ms by the profiler is below "
             f"its bound {bound} ms or more than {FLASH_EVENT_SHARE:.0%} off "
             f"its stream time {ev} ms")
    return {"name": "wkv6_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            "replaces": REPLACES["wkv6_backward"], "shape": list(shape),
            "max_abs_err": err, "max_share_of_max_grad": max(
                checked["shares"]), "control_share": max(
                checked["control_shares"]),
            "ms": ms, "plain_ms": plain_ms, "event_ms": ev,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flop": flops, "design_flop": design_flops,
            "design_ms": t_design, "checkpoint_bytes": ckpt_bytes,
            "bytes": nbytes, "launches_per_call": launches_per_call,
            "over_forward": ms / forward_ms, "forward_ms": forward_ms,
            "geometry": {k: geo[k] for k in ("threads", "rows", "cols",
                                             "sub", "seg", "stages",
                                             "smem_bytes")},
            "device_ops_per_call": per_call, "library_ms": None}


def host_ram_bytes() -> dict:
    """The machine's total and available RAM (``/proc/meminfo``)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def settled_host_ram(limit_s: float = 30.0) -> dict:
    """``host_ram_bytes`` once MemAvailable has stopped rising (by less
    than 512 MiB in a second): pinned host memory handed back by
    ``free_memory`` returns to it over seconds (25.8 GB took ~5 s on the
    card machine, PR 27), and an earlier phase's moments must not count
    against the next one's."""
    ram = host_ram_bytes()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        time.sleep(1.0)
        now = host_ram_bytes()
        if now["MemAvailable"] - ram["MemAvailable"] < 1 << 29:
            return now
        ram = now
    return ram


def train_batch(api, B: int, S: int, seed: int) -> dict:
    """Batch ``seed`` of the port's data pipeline on the card."""
    from repro_torch.data import DataConfig, device_batch, make_batch
    cfg = DataConfig(vocab=api.cfg.vocab, seq_len=S, global_batch=B)
    return device_batch(make_batch(cfg, seed), None, "cuda")


def smollm_train_phase() -> dict:
    """The training path: smollm-135m FULL, device AdamW, ``Trainer`` for
    SMOLLM_TRAIN (launch counters set to 0 just before, read just after).
    Gates: every loss finite, the mean of the last 5 below the mean of
    the first 5, no kernel launched (the loss runs the plain attention,
    as the reference's). Records the step wall ms (median after the
    first), tokens/s, one step's device ms and operations (profiled as it
    comes) and the peak memory."""
    from repro_torch.models import registry
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    api = registry.build("smollm-135m", smoke=False, device="cuda")
    cfg = TrainConfig(**SMOLLM_TRAIN, optim=AdamWConfig(
        peak_lr=SMOLLM_LR, warmup_steps=SMOLLM_WARMUP,
        total_steps=SMOLLM_TRAIN["steps"]))
    tr = Trainer(api, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    params, opt, hist = tr.run()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"smollm-135m training: a loss is not finite: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"smollm-135m training: the loss did not fall: {losses}")
    if any(launches.values()):
        fail(f"smollm-135m training launched kernels: {launches}")
    batch = train_batch(api, cfg.global_batch, cfg.seq_len, 0)
    ops, dev_ms = profile_once(lambda: tr._one_step(params, opt, batch))
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    tokens = cfg.global_batch * cfg.seq_len
    out = {"arch": "smollm-135m", "batch": cfg.global_batch,
           "seq": cfg.seq_len, "steps": cfg.steps, "losses": losses,
           "first_step_ms": hist[0]["sec"] * 1e3,
           "step_wall_ms_median": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "step_device_ms": dev_ms,
           "step_device_ops": ops, "peak_gb": peak / 1e9,
           "launches": launches, "card": gpu_line()}
    print(json.dumps({"train_smollm": out}), flush=True)
    return out


def smollm_host_vs_device_phase() -> dict:
    """smollm-135m FULL with f32 weights (in bf16 a parameter within
    2e-10 of a bf16 rounding midpoint flips by one bf16 ulp, ~2.4e-4, and
    135 M parameters have ~100 of them) trained TRAIN_PARITY_STEPS steps
    by device AdamW and by ``HostOffloadAdamW`` (moments pinned in host
    memory, each leaf's copied to the card and back every step), grads in
    f32: every parameter within 1e-5 (the reference's bound). Records the
    host optimizer's modelled link report beside the measured wall time
    of its moments' round trip."""
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    base = registry.build("smollm-135m", smoke=False, device="cuda")
    api = registry._lm_api("smollm-135m", dataclasses.replace(
        base.cfg, dtype=torch.float32), "cuda")
    opt = AdamWConfig(peak_lr=SMOLLM_LR, warmup_steps=1,
                      total_steps=TRAIN_PARITY_STEPS,
                      grad_dtype=torch.float32)
    runs = {}
    for place in ("device", "host"):
        tr = Trainer(api, TrainConfig(
            seq_len=SMOLLM_TRAIN["seq_len"],
            global_batch=SMOLLM_TRAIN["global_batch"],
            steps=TRAIN_PARITY_STEPS, optimizer_placement=place, optim=opt))
        reset_all_launches()
        params, _, hist = tr.run()
        if any(all_launches().values()):
            fail(f"smollm-135m {place} AdamW launched kernels")
        runs[place] = (tr, params, hist)
    diff = max((a - b).abs().max().item() for a, b in zip(
        nn.tree_leaves(runs["device"][1]), nn.tree_leaves(runs["host"][1])))
    if not diff <= 1e-5:
        fail(f"smollm-135m: host and device AdamW parameters differ by "
             f"{diff} > 1e-5")
    rep = dict(runs["host"][0].host_opt.last_transfer_report)
    both_ways = 2 * rep["moment_bytes"]
    out = {"max_param_diff": diff, "steps": TRAIN_PARITY_STEPS,
           "report": rep,
           "measured_round_trip_ms": rep["measured_us"] / 1e3,
           "modelled_duplex_ms": rep["duplex_us"] / 1e3,
           "modelled_serial_ms": rep["serial_us"] / 1e3,
           "measured_gb_per_s_both_ways": both_ways / rep["measured_us"]
           / 1e3,
           "step_wall_ms": {place: float(np.median(
               [h["sec"] for h in runs[place][2][1:]])) * 1e3
               for place in runs},
           "card": gpu_line()}
    print(json.dumps({"train_host_vs_device": out}), flush=True)
    return out


def rwkv_model(layers: int, dtype=torch.bfloat16):
    """rwkv6-7b's FULL widths cut to ``layers`` layers, on the card."""
    from repro_torch.models import registry
    api = registry.build("rwkv6-7b", smoke=False, device="cuda")
    cfg = api.cfg
    if (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.head_size) != (32, 4096, 14336, 65536, 64):
        fail(f"not the full-width config: {cfg}")
    cfg = dataclasses.replace(cfg, num_layers=layers, dtype=dtype)
    return registry._rwkv_api("rwkv6-7b", cfg, "cuda")


def leaf_paths(tree) -> list:
    """(``/``-joined path, leaf) of a nested dict, keys sorted
    (``tree_leaves``'s order)."""
    from repro_torch.checkpoint.sharded import _leaf_paths
    return list(zip(*_leaf_paths(tree)))


def grad_leaf_check(grads, what: str) -> dict:
    """Every leaf of ``grads`` finite and not all zero, and for RWKV6 each
    of the time-mix ``mu``'s five rows (r, k, v, w, g) too: the gradient
    the recurrence passes upstream (a kernel outside autograd leaves the
    four rows feeding r, k, v, w at zero and wr, wk, wv, w_a, w_b, w0, u
    with none)."""
    paths = leaf_paths(grads)
    for path, g in paths:
        if not torch.isfinite(g.float()).all():
            fail(f"{what}: the gradient of {path} is not finite")
        if not g.abs().max() > 0:
            fail(f"{what}: the gradient of {path} is all zero")
    out = {"leaves": len(paths),
           "min_leaf_max_abs": min(g.abs().max().item() for _, g in paths)}
    if "tm" in grads.get("layers", {}):
        mu = grads["layers"]["tm"]["mu"].float().abs().amax(dim=(0, 2))
        if not (mu > 0).all():
            fail(f"{what}: a row of mu has no gradient: {mu.tolist()}")
        out["mu_rows_max_abs"] = mu.tolist()
    return out


def rwkv_train_phase() -> dict:
    """rwkv6-7b at full width, RWKV_TRAIN_LAYERS of its 32 layers, trained
    RWKV_TRAIN_STEPS steps by ``Trainer`` with the host optimizer at
    (B, S) = RWKV_TRAIN: the recurrence through the wkv6 forward and
    backward kernels. Gates: each step launches wkv6 and wkv6_backward
    once per layer; the first step's gradient reaches every leaf, finite
    and not all zero, and each of mu's five rows; every loss finite. The
    host RAM is checked before the moments (8 bytes a parameter) are
    pinned."""
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.models import layers as nn
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    B, S = RWKV_TRAIN
    L = RWKV_TRAIN_LAYERS
    api = rwkv_model(L)
    ram = host_ram_bytes()
    moments = 8 * api.cfg.param_count()
    if moments > 0.6 * ram["MemAvailable"]:
        fail(f"rwkv6-7b at {L} layers: its moments take {moments / 1e9:.1f} "
             f"GB of the host's {ram['MemAvailable'] / 1e9:.1f} GB available")
    tr = Trainer(api, TrainConfig(
        seq_len=S, global_batch=B, steps=RWKV_TRAIN_STEPS,
        optimizer_placement="host",
        optim=AdamWConfig(warmup_steps=1, total_steps=RWKV_TRAIN_STEPS)))
    per_step, checked = [], {}
    real = tr._grads

    def grads_spy(params, batch):
        before = dict(rs.LAUNCHES)
        out = real(params, batch)
        torch.cuda.synchronize()
        per_step.append({k: rs.LAUNCHES[k] - before[k] for k in before})
        if not checked:
            checked.update(grad_leaf_check(out[2], "rwkv6-7b training"))
        return out

    tr._grads = grads_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_all_launches()
    params, opt, hist = tr.run(params, opt)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {"wkv6": L, "wkv6_backward": L}
    if per_step != [want] * RWKV_TRAIN_STEPS:
        fail(f"rwkv6-7b training: wkv6 launches per step {per_step}, want "
             f"{want} each step")
    others = {k: n for k, n in launches.items() if k not in want}
    if any(others.values()):
        fail(f"rwkv6-7b training launched other kernels: {others}")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"rwkv6-7b training: a loss is not finite: {losses}")
    rep = dict(tr.host_opt.last_transfer_report)
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    out = {"arch": "rwkv6-7b", "reduced": {"num_layers": [32, L]},
           "batch": B, "seq": S, "steps": RWKV_TRAIN_STEPS,
           "param_count": api.cfg.param_count(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in nn.tree_leaves(params)),
           "host_ram": ram, "init_s": init_s, "losses": losses,
           "launches": launches, "launches_per_step": per_step[0],
           "grads": checked, "step_wall_ms": [h["sec"] * 1e3 for h in hist],
           "tokens_per_s": B * S / step_s, "peak_gb": peak / 1e9,
           "report": rep, "measured_round_trip_ms": rep["measured_us"] / 1e3,
           "card": gpu_line()}
    print(json.dumps({"train_rwkv": out}), flush=True)
    del tr, params, opt
    torch.cuda.empty_cache()
    return out


def rwkv_grad_phase() -> dict:
    """rwkv6-7b's gradient at full width, RWKV_GRAD_LAYERS layers, f32
    weights, TF32 off, at (B, S) = RWKV_GRAD: through the wkv6 kernels
    against autograd through the plain loop (``use_kernel=False``), each
    leaf within RWKV_GRAD_TOL of its largest magnitude; the kernel run
    launches each kernel once per layer."""
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    from repro_torch.models import rwkv6 as W
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S = RWKV_GRAD
    api = rwkv_model(RWKV_GRAD_LAYERS, torch.float32)
    cfg = api.cfg
    params = api.init(torch.Generator("cuda").manual_seed(1))
    batch = train_batch(api, B, S, 1)
    reset_all_launches()
    t0 = time.perf_counter()
    loss_k, _, got = value_and_grad(api.loss_fn, params, batch,
                                    torch.float32)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = all_launches()
    if launches["wkv6"] != cfg.num_layers \
            or launches["wkv6_backward"] != cfg.num_layers:
        fail(f"rwkv6-7b gradient: launches {launches}, want "
             f"{cfg.num_layers} of wkv6 and of wkv6_backward")

    def plain(p, b):
        logits, _ = W.forward(p, cfg, b["tokens"], use_kernel=False)
        return nn.cross_entropy(logits, b["labels"]), {}

    t0 = time.perf_counter()
    loss_p, _, want = value_and_grad(plain, params, batch, torch.float32)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    worst, where = 0.0, None
    for (path, a), b in zip(leaf_paths(got), nn.tree_leaves(want)):
        share = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                 1e-30)
        if share > worst:
            worst, where = share, path
    if not worst <= RWKV_GRAD_TOL:
        fail(f"rwkv6-7b gradient through the kernels differs from the plain "
             f"loop's by {worst} of {where}'s largest magnitude")
    checked = grad_leaf_check(got, "rwkv6-7b gradient")
    out = {"layers": cfg.num_layers, "batch": B, "seq": S,
           "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "worst_leaf_share": worst, "worst_leaf": where,
           "grads": checked, "kernel_grad_s": kernel_s,
           "plain_grad_s": plain_s, "launches": launches,
           "card": gpu_line()}
    print(json.dumps({"train_rwkv_gradient": out}), flush=True)
    del params, got, want
    torch.cuda.empty_cache()
    return out


def train_on_card(name: str, api, cfg, reduced: dict,
                  extras: dict | None = None) -> tuple[dict, object]:
    """``Trainer`` at ``cfg`` on the card from its own seeded state (the
    weights drawn on the card; no other reference to the first weights
    and moments is held, so each step frees its inputs), the launch
    counters set to 0 just before the run and read just after. Gates: no
    kernel launched, every loss finite, the first step's gradient finite
    and non-zero on every leaf (``grad_leaf_check``). With the host
    optimizer the host's RAM is checked before the moments (8 bytes a
    parameter) are pinned. One more step is profiled as it comes. Returns
    the phase's record (its JSON line's body) and the trained
    parameters."""
    from repro_torch.data import DataConfig, device_batch, make_batch
    from repro_torch.runtime import Trainer
    host = cfg.optimizer_placement == "host"
    free_memory()
    ram = settled_host_ram() if host else host_ram_bytes()
    if host:
        moments = 8 * api.param_count
        if moments > 0.6 * ram["MemAvailable"]:
            fail(f"{name}: its moments take {moments / 1e9:.1f} GB of the "
                 f"host's {ram['MemAvailable'] / 1e9:.1f} GB available")
    tr = Trainer(api, cfg, extras_fn=(lambda: extras) if extras else None)
    checked, timed = {}, {}
    real_grads, real_init = tr._grads, tr.init_state

    def grads_spy(p, batch):
        out = real_grads(p, batch)
        if not checked:
            checked.update(grad_leaf_check(out[2], f"{name} training"))
        return out

    def init_spy(generator=None):
        t0 = time.perf_counter()
        out = real_init(generator)
        torch.cuda.synchronize()
        timed["init_s"] = time.perf_counter() - t0
        return out

    tr._grads, tr.init_state = grads_spy, init_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    params, opt, hist = tr.run()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        fail(f"{name} training launched kernels: {launches}")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        fail(f"{name} training: a loss is not finite: {losses}")
    batch = device_batch(make_batch(DataConfig(
        vocab=api.cfg.vocab, seq_len=cfg.seq_len,
        global_batch=cfg.global_batch), cfg.steps), extras, "cuda")
    ops, dev_ms = profile_once(lambda: tr._one_step(params, opt, batch))
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    out = {"arch": api.arch_id, "reduced": reduced,
           "batch": cfg.global_batch, "seq": cfg.seq_len,
           "steps": cfg.steps, "optimizer": cfg.optimizer_placement,
           "peak_lr": cfg.optim.peak_lr, "param_count": api.param_count,
           "param_bytes": param_bytes(params), "init_s": timed["init_s"],
           "losses": losses, "launches": launches, "grads": checked,
           "step_wall_ms": [h["sec"] * 1e3 for h in hist],
           "step_wall_ms_median": step_s * 1e3,
           "step_device_ms": dev_ms, "step_device_ops": ops,
           "tokens_per_s": cfg.global_batch * cfg.seq_len / step_s,
           "peak_gb": peak / 1e9}
    if host:
        rep = dict(tr.host_opt.last_transfer_report)
        out.update({"host_ram": ram, "report": rep,
                    "measured_round_trip_ms": rep["measured_us"] / 1e3,
                    "modelled_duplex_ms": rep["duplex_us"] / 1e3,
                    "modelled_serial_ms": rep["serial_us"] / 1e3})
    del tr, opt, batch
    return out, params


def falling(name: str, losses: list) -> None:
    """The mean loss of the last TRAIN_FALL steps below that of the
    first TRAIN_FALL."""
    if not np.mean(losses[-TRAIN_FALL:]) < np.mean(losses[:TRAIN_FALL]):
        fail(f"{name} training: the loss did not fall: {losses}")


def free_memory() -> None:
    """Collect garbage, then hand back what PyTorch's caching allocators
    keep after their tensors are freed: the card's blocks, and the pinned
    host blocks (the host optimizer's moments), which would otherwise stay
    out of the host's MemAvailable for the rest of the process."""
    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(getattr(torch, "accelerator", None),
                         "empty_host_cache", None) or torch._C._host_emptyCache
    empty_host()


def finish(key: str, out: dict) -> dict:
    """Print a phase's line, the card's name and power limit last."""
    out["card"] = gpu_line()
    print(json.dumps({key: out}), flush=True)
    free_memory()
    return out


def moe_expert_grads(api, params, batch) -> dict:
    """The first layer's expert gradients (w_gate, w_up) of one step of
    ``api`` on ``batch`` (TF32 off) through the card's ``_BmmF32``, held
    against a second backend: the CPU takes the same f32 product ``a^T g``
    from copies of the step's operands (for each ``_bmm_f32`` product of
    the layer, its buffer ``a`` and the f32 cotangent ``g`` of its output,
    recorded by an output hook).

    ``_BmmF32.backward`` takes the weight gradient as one f32 cuBLAS
    product and rounds it to the leaf's bf16. Gates, each relative to the
    largest |product|: the leaf equals the card's product of the recorded
    operands rounded to bf16 (the same call, so the same bits); that
    product within BMM_F32_RTOL of the CPU's, and the control, the product
    taken in bf16 (``check_bmm_f32``'s control), beyond it; the leaf no
    more than BMM_F32_RTOL beyond half a bf16 unit in the last place of
    the CPU's product (a correct rounding of a product within x of the
    CPU's lies at most x beyond it). The CPU takes MOE_GRAD_COLUMNS of the
    ffn columns (seeded, the same for every expert): the whole product is
    ~35 s of the card machine's host."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    card_route = nn._bmm_f32
    seen = []

    def recording(a, b):
        out = card_route(a, b)
        if out.requires_grad and len(seen) < 2:
            seen.append({"a": a.detach()})
            out.register_hook(
                lambda g, rec=seen[-1]: rec.update(g=g.detach()))
        return out

    def beyond(got, want):
        """max(|got - want| - half an ulp of want in bf16, 0), largest."""
        exp = torch.frexp(want)[1]
        half_ulp = torch.where(want == 0, 0.0, torch.ldexp(
            torch.ones_like(want), exp - 9))
        return ((got - want).abs() - half_ulp).clamp_(min=0).max().item()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    nn._bmm_f32 = recording
    out = {}
    try:
        _, _, grads = value_and_grad(api.loss_fn, params, batch,
                                     torch.bfloat16)
        moe = grads["layers"]["moe"]
        leaves = {"w_gate": moe["w_gate"][0], "w_up": moe["w_up"][0]}
        del grads, moe
        for (name, leaf), rec in zip(leaves.items(), seen):
            t0 = time.perf_counter()
            # the backward's own call: a (E, C, D), g (E, C, F) f32
            prod = torch.bmm(rec["a"].float().transpose(1, 2), rec["g"])
            control = torch.bmm(rec["a"].transpose(1, 2),
                                rec["g"].to(torch.bfloat16))
            exact = torch.equal(leaf, prod.to(leaf.dtype))
            top = prod.abs().max().item()
            cols = torch.randperm(prod.shape[2], generator=torch.Generator(
            ).manual_seed(0))[:MOE_GRAD_COLUMNS].sort().values
            on_card = cols.to(prod.device)
            a, g = rec["a"].cpu(), rec["g"][:, :, on_card].cpu()
            err = control_err = leaf_err = 0.0
            for e in range(a.shape[0]):
                want = a[e].float().T @ g[e]
                pick = lambda t: t[e][:, on_card].float().cpu()
                err = max(err, (pick(prod) - want).abs().max().item())
                control_err = max(control_err,
                                  (pick(control) - want).abs().max().item())
                leaf_err = max(leaf_err, beyond(pick(leaf), want))
            out[name] = {
                "shape": list(leaf.shape), "dtype": str(leaf.dtype),
                "columns": len(cols), "leaf_is_rounded_product": exact,
                "max_rel_err": err / top,
                "control_max_rel_err": control_err / top,
                "leaf_beyond_rounding_max_rel": leaf_err / top,
                "cpu_threads": torch.get_num_threads(),
                "s": time.perf_counter() - t0}
            del prod, control
    finally:
        nn._bmm_f32 = card_route
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del seen, leaves
    return out


def mixtral_train_phase() -> dict:
    """mixtral-8x7b at full width, MIXTRAL_TRAIN_LAYERS of its 32 layers,
    trained MIXTRAL_TRAIN_STEPS steps with the host optimizer at (B, S) =
    MIXTRAL_TRAIN (``train_on_card``); then the first layer of the
    trained weights at full width, one step: its expert gradients through
    the card's ``_BmmF32`` against the CPU's f32 product of the step's
    operands, each leaf the bf16 rounding of the card's f32 product, that
    product within BMM_F32_RTOL of the CPU's and the leaf within it beyond
    its rounding, and the control (the bf16 product) beyond it
    (``moe_expert_grads``)."""
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig
    B, S = MIXTRAL_TRAIN
    L = MIXTRAL_TRAIN_LAYERS
    api, reduced = moe_api("mixtral-8x7b", L, MOE_RUNS[0][2])
    reduced["seq_len"] = [MIXTRAL_CONTEXT, S]
    cfg = TrainConfig(seq_len=S, global_batch=B, steps=MIXTRAL_TRAIN_STEPS,
                      optimizer_placement="host",
                      optim=AdamWConfig(warmup_steps=1,
                                        total_steps=MIXTRAL_TRAIN_STEPS))
    out, params = train_on_card("mixtral-8x7b", api, cfg, reduced)
    one = registry._lm_api(api.arch_id, dataclasses.replace(
        api.cfg, num_layers=1), "cuda")
    first = {**params, "layers": nn.tree_map(lambda t: t[:1],
                                             params["layers"])}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    grads = moe_expert_grads(one, first, train_batch(one, B, S, 0))
    out["expert_grads"] = {"layers": 1, "rtol": BMM_F32_RTOL, **grads}
    finish("train_mixtral", out)
    for name, g in grads.items():
        if not g["leaf_is_rounded_product"]:
            fail(f"mixtral-8x7b: the card's {name} gradient is not its "
                 f"f32 product rounded to bf16")
        if not g["max_rel_err"] <= BMM_F32_RTOL:
            fail(f"mixtral-8x7b: the card's {name} product is "
                 f"{g['max_rel_err']} of its largest off the CPU's "
                 f"(limit {BMM_F32_RTOL})")
        if not g["leaf_beyond_rounding_max_rel"] <= BMM_F32_RTOL:
            fail(f"mixtral-8x7b: the card's {name} gradient is "
                 f"{g['leaf_beyond_rounding_max_rel']} of its largest "
                 f"beyond its bf16 rounding of the CPU's product (limit "
                 f"{BMM_F32_RTOL})")
        if not g["control_max_rel_err"] > BMM_F32_RTOL:
            fail(f"mixtral-8x7b: the bf16 {name} product is "
                 f"{g['control_max_rel_err']} off, within the limit: the "
                 f"check cannot see a rounding")
    return out


def zamba2_cut(layers: int, dtype=torch.bfloat16, device: str = "cuda"):
    """zamba2-7b's published widths cut to ``layers`` layers."""
    from repro_torch.models import registry
    full = registry.build("zamba2-7b", smoke=False, device=device).cfg
    dims = (full.num_layers, full.d_model, full.num_heads, full.d_ff,
            full.vocab, full.ssm_state, full.attn_every)
    if dims != (81, 3584, 32, 14336, 32000, 64, 6):
        fail(f"zamba2-7b: not the full-width config: {dims}")
    return registry._hybrid_api("zamba2-7b", dataclasses.replace(
        full, num_layers=layers, dtype=dtype), device)


def zamba2_train_phase() -> dict:
    """zamba2-7b at full width, ZAMBA_TRAIN_LAYERS of its 81 layers (two
    applications of the shared block), device AdamW, ZAMBA_TRAIN_STEPS
    steps at (B, S) = ZAMBA_TRAIN (``train_on_card``): the SSD scan's
    Python loop under autograd."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig
    B, S = ZAMBA_TRAIN
    api = zamba2_cut(ZAMBA_TRAIN_LAYERS)
    if api.cfg.num_attn_apps != 2:
        fail(f"zamba2-7b at {ZAMBA_TRAIN_LAYERS} layers applies the shared "
             f"block {api.cfg.num_attn_apps} times, not 2")
    cfg = TrainConfig(seq_len=S, global_batch=B, steps=ZAMBA_TRAIN_STEPS,
                      optim=AdamWConfig(warmup_steps=1,
                                        total_steps=ZAMBA_TRAIN_STEPS))
    out, params = train_on_card(
        "zamba2-7b", api, cfg, {"num_layers": [81, ZAMBA_TRAIN_LAYERS],
                                "seq_len": [ZAMBA_CONTEXT, S]})
    out["attn_apps"] = api.cfg.num_attn_apps
    del params
    return finish("train_zamba2", out)


def zamba2_grad_phase() -> dict:
    """zamba2-7b's gradient in f32 (TF32 off) at full width,
    ZAMBA_GRAD_LAYERS layers (one application of the shared block), (B,
    S) = ZAMBA_GRAD, on the card against the same step on the CPU (the
    same weights, copied): each leaf within ZAMBA_GRAD_TOL of its
    largest; the control (the Mamba state zeroed halfway through the
    sequence on the card) must exceed it."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    from repro_torch.models import ssm
    B, S = ZAMBA_GRAD
    api = zamba2_cut(ZAMBA_GRAD_LAYERS, torch.float32)
    cpu_api = zamba2_cut(ZAMBA_GRAD_LAYERS, torch.float32, "cpu")
    if api.cfg.num_attn_apps != 1:
        fail(f"zamba2-7b at {ZAMBA_GRAD_LAYERS} layers applies the shared "
             f"block {api.cfg.num_attn_apps} times, not 1")
    params = api.init(torch.Generator("cuda").manual_seed(2))
    batch = train_batch(api, B, S, 2)
    real_loop = ssm._ssd_loop

    def zeroed_halfway(xh, Bmat, Cmat, dt, A_log, D, h):
        half = xh.shape[1] // 2
        y1, h1 = real_loop(xh[:, :half], Bmat[:, :half], Cmat[:, :half],
                           dt[:, :half], A_log, D, h)
        y2, h2 = real_loop(xh[:, half:], Bmat[:, half:], Cmat[:, half:],
                           dt[:, half:], A_log, D, torch.zeros_like(h1))
        return torch.cat([y1, y2], dim=1), h2

    def worst(got, want) -> tuple[float, str]:
        w, where = 0.0, None
        for (path, a), b in zip(leaf_paths(got), nn.tree_leaves(want)):
            share = ((a.cpu() - b).abs().max().item()
                     / max(b.abs().max().item(), 1e-30))
            if share > w:
                w, where = share, path
        return w, where

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_all_launches()
        t0 = time.perf_counter()
        loss_c, _, got = value_and_grad(api.loss_fn, params, batch,
                                        torch.float32)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = all_launches()
        ssm._ssd_loop = zeroed_halfway
        try:
            _, _, faulted = value_and_grad(api.loss_fn, params, batch,
                                           torch.float32)
        finally:
            ssm._ssd_loop = real_loop
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    checked = grad_leaf_check(got, "zamba2-7b gradient")
    cpu_params = nn.tree_map(lambda t: t.cpu(), params)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    del params
    t0 = time.perf_counter()
    loss_h, _, want = value_and_grad(cpu_api.loss_fn, cpu_params, cpu_batch,
                                     torch.float32)
    cpu_s = time.perf_counter() - t0
    share, where = worst(got, want)
    control, control_where = worst(faulted, want)
    out = {"arch": "zamba2-7b", "layers": ZAMBA_GRAD_LAYERS,
           "attn_apps": api.cfg.num_attn_apps, "batch": B, "seq": S,
           "reduced": {"num_layers": [81, ZAMBA_GRAD_LAYERS],
                       "seq_len": [ZAMBA_CONTEXT, S]},
           "loss_card": loss_c.item(), "loss_cpu": loss_h.item(),
           "worst_leaf_share": share, "worst_leaf": where,
           "tol": ZAMBA_GRAD_TOL,
           "control_fault": f"Mamba state zeroed at step {S // 2}",
           "control_worst_leaf_share": control,
           "control_worst_leaf": control_where, "grads": checked,
           "card_grad_s": card_s, "cpu_grad_s": cpu_s,
           "launches": launches}
    del got, faulted, want, cpu_params
    finish("train_zamba2_gradient", out)
    if any(launches.values()):
        fail(f"zamba2-7b gradient launched kernels: {launches}")
    if not share <= ZAMBA_GRAD_TOL:
        fail(f"zamba2-7b: the card's f32 gradient differs from the CPU's by "
             f"{share} of {where}'s largest (limit {ZAMBA_GRAD_TOL})")
    if not control > ZAMBA_GRAD_TOL:
        fail(f"zamba2-7b: the control ({out['control_fault']}) moved the "
             f"gradient by {control}, within the limit: the check cannot "
             f"see it")
    return out


def paligemma_train_phase() -> dict:
    """paligemma-3b FULL (18 layers) at B=2 over 256 stub patch embeddings
    and 256 tokens, device AdamW, TRAIN_STEPS steps (``train_on_card``);
    the loss must fall."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig
    B, S = PALIGEMMA_TRAIN
    api = full_api(
        "paligemma-3b", (18, 2048, 8, 1, 16384, 257216, 256, 256),
        ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
         "vocab", "head_dim", "prefix_len"))
    pe = (0.1 * torch.randn((B, api.cfg.prefix_len, api.cfg.d_model),
                            generator=torch.Generator("cuda").manual_seed(4),
                            device="cuda")).to(torch.bfloat16)
    cfg = TrainConfig(seq_len=S, global_batch=B, steps=TRAIN_STEPS,
                      optim=AdamWConfig(peak_lr=PALIGEMMA_LR,
                                        warmup_steps=SMOLLM_WARMUP,
                                        total_steps=TRAIN_STEPS))
    out, params = train_on_card("paligemma-3b", api, cfg, {},
                                {"prefix_embeds": pe})
    out["prefix_len"] = api.cfg.prefix_len
    del params
    finish("train_paligemma", out)
    falling("paligemma-3b", out["losses"])
    return out


def whisper_train_phase() -> dict:
    """whisper-base FULL at B=2 over 1500 stub frames and 448 decoder
    tokens, device AdamW, TRAIN_STEPS steps (``train_on_card``); the loss
    must fall."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig
    B, S_enc, S_dec = WHISPER_TRAIN
    api = full_api(
        "whisper-base", (6, 512, 8, 8, 2048, 51865),
        ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
         "vocab"))
    frames = torch.randn((B, S_enc, api.cfg.d_model), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(8))
    cfg = TrainConfig(seq_len=S_dec, global_batch=B, steps=TRAIN_STEPS,
                      optim=AdamWConfig(peak_lr=SMOLLM_LR,
                                        warmup_steps=SMOLLM_WARMUP,
                                        total_steps=TRAIN_STEPS))
    out, params = train_on_card("whisper-base", api, cfg, {},
                                {"frames": frames})
    out["frames"] = S_enc
    del params
    finish("train_whisper", out)
    falling("whisper-base", out["losses"])
    return out


# each example of ``repro_torch.examples``, run by its ``main`` on the card:
# (module, its arguments, the start of its closing line, kernels it must
# launch); train_smollm at 100 of its default 300 steps, for the run's time
EXAMPLES = [
    ("quickstart", [], "  served 2x12 greedy tokens", ()),
    ("duplex_tour", [], "   64 GB of Adam moments: duplex",
     ("duplex_kv_stream", "quant_stream", "dequant_stream")),
    ("serve_offload", [], "OK", ("duplex_kv_stream",)),
    ("multi_tenant_serve", [],
     "staggered multi-tenant == static-batch reference: True",
     ("duplex_kv_stream", "l2_distance")),
    ("train_smollm", ["--steps", "100"], "OK", ()),
]


def examples_phase() -> dict:
    """Each example's ``main`` on the card, in this process (its launch
    counters read directly, and no process start of ~8 s an example),
    its output captured and printed with the example's name: each must
    return 0, print its closing line and launch the kernels EXAMPLES
    names (counters set to 0 just before each ``main``, read just after);
    serve_offload's staggered run must match its static-batch reference.
    Then duplex_tour's layer 2 again on its streams: the fused kernel's
    outputs equal the phase-separated pair's and hold against the plain
    version (``compare``), both routes timed."""
    import importlib
    import io
    from repro_torch.kernels import ref
    runs = {}
    for name, argv, closing, must in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        out = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        reset_all_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = all_launches()
        lines = out.getvalue().splitlines()
        for line in lines:
            print(f"  [{name}] {line}")
        runs[name] = {"rc": rc, "seconds": seconds, "launches": launches,
                      "closing": lines[-1] if lines else None}
        if rc != 0 or not lines or not lines[-1].startswith(closing):
            fail(f"example {name}: exit {rc}, closing line "
                 f"{runs[name]['closing']!r}")
        missing = [k for k in must if not launches[k] > 0]
        if missing:
            fail(f"example {name} launched no {missing}: {launches}")
        if name == "serve_offload" and "staggered == static-batch " \
                "reference (first 2 reqs): True" not in lines:
            fail("example serve_offload: the staggered run is off its "
                 "static-batch reference")
    from repro_torch.examples import duplex_tour
    streams = duplex_tour.stream_inputs(torch.device("cuda"))
    with contextlib.redirect_stdout(io.StringIO()):
        tour = duplex_tour.layer2(*streams)
    if not tour["same"]:
        fail("duplex_tour: the fused kernel's outputs differ from the "
             "phase-separated pair's")
    want = ref.duplex_kv_stream(*streams)
    errs = [compare("duplex_tour fused", tour["fused"], want),
            compare("duplex_tour phase-separated", tour["split"], want)]
    out = {"runs": runs, "layer2": {
        "shape": list(duplex_tour.STREAM_SHAPE), "bytes": tour["bytes"],
        "fused_equals_split": tour["same"], "max_abs_err": max(errs),
        "fused_ms": tour["fused_ms"], "split_ms": tour["split_ms"]}}
    return finish("examples", out)


def offload_demo_phase() -> dict:
    """``python -m repro_torch.launch.serve --offload-demo`` (the
    deprecated ``OffloadedKVCache`` shim) in this process on the card,
    then with ``--device cpu``: the run report's fields (wall clock and
    ``device`` left out), the demo's stats and its speedup line equal;
    the card's run launches ``duplex_kv_stream`` and the CPU's nothing."""
    import io
    import warnings
    from repro_torch.launch import serve
    argv = ["serve", "--requests", "2", "--gen", "3", "--no-warmup",
            "--offload-demo"]
    runs = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        saved = sys.argv
        sys.argv = argv + ["--device", device]
        reset_all_launches()
        try:
            with contextlib.redirect_stdout(out), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                rc = serve.main()
        finally:
            sys.argv = saved
        lines = out.getvalue().strip().splitlines()
        if rc != 0 or len(lines) < 3 \
                or not lines[-2].startswith("offload demo stats: "):
            fail(f"--offload-demo on {device}: exit {rc}, {lines[-3:]}")
        runs[device] = {"report": json.loads(lines[-3]),
                        "stats": json.loads(lines[-2].split(": ", 1)[1]),
                        "speedup_line": lines[-1],
                        "launches": all_launches()}
    card, cpu = runs["cuda"], runs["cpu"]
    skip = {"wall_s", "tok_s", "device"}
    diff = sorted(k for k in set(card["report"]) | set(cpu["report"])
                  if k not in skip
                  and card["report"].get(k) != cpu["report"].get(k))
    out = {"stats": card["stats"], "speedup_line": card["speedup_line"],
           "launches_card": card["launches"],
           "report_fields_differing": diff,
           "stats_equal": card["stats"] == cpu["stats"]}
    finish("offload_demo", out)
    if diff or card["stats"] != cpu["stats"] \
            or card["speedup_line"] != cpu["speedup_line"]:
        fail(f"--offload-demo: the card's run differs from the CPU's in "
             f"{diff or 'the demo stats'}")
    if not card["launches"]["duplex_kv_stream"] > 0 \
            or any(cpu["launches"].values()):
        fail(f"--offload-demo launches: card {card['launches']}, cpu "
             f"{cpu['launches']}")
    return out


def cell_api(arch: str, layers: int | None, device: str):
    """The arch's full-width api on ``device``, its depth cut to
    ``layers`` when given (rwkv6-7b, the gradient check's two layers)."""
    from repro_torch.models import registry
    api = registry.build(arch, smoke=False, device=device)
    if layers is None:
        return api
    if api.family != "ssm":
        fail(f"cell_api cuts only rwkv6-7b's depth, not {arch}'s")
    return registry._rwkv_api(arch, dataclasses.replace(
        api.cfg, num_layers=layers), device)


def dryrun_predictions() -> dict:
    """The dry-run's side of ``dryrun_vs_card`` and the ``dryrun_cells``
    (run in the ``--dryruns`` subprocess, on the host only): each
    DRYRUN_CARD_CELLS cell traced on a (1, 1) mesh of the fake process
    group (the port's own step: no shard env, no unroll knob), and each
    DRYRUN_CELLS cell on its production mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import device_mesh
    mesh = device_mesh((1, 1), ("data", "model"))
    card = []
    for arch, shape, B, layers in DRYRUN_CARD_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.trace_cell(cell_api(arch, layers, "cpu"), shape, mesh,
                                remat=True, unroll=False, batch_override=B)
        card.append({"arch": arch, "shape": shape, "batch": B,
                     "layers": layers, "trace_s": time.perf_counter() - t0,
                     **{k: rec[k] for k in ("cost_analysis",
                                            "memory_analysis",
                                            "collectives")}})
    cells = []
    for arch, shape, mk in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, mk, save=False)
        rec.pop("traceback", None)
        cells.append(rec)
    return {"card": card, "cells": cells}


def dryruns(path: str) -> int:
    """``--dryruns``: ``dryrun_predictions`` as JSON (a subprocess that
    cannot see the card, started beside the card's work; at a lower
    priority, so that it takes no host time from the card's phases)."""
    sys.path.insert(0, str(ROOT / "src"))
    os.nice(10)
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    out = dryrun_predictions()
    out["seconds"] = time.perf_counter() - t0
    Path(path).write_text(json.dumps(out))
    return 0


def start_dryruns() -> tuple:
    path = ROOT / "build" / "dryruns.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryruns", str(path)], env=env)
    return proc, path


def wait_dryruns(proc_path: tuple) -> dict:
    proc, path = proc_path
    rc = proc.wait(timeout=DRYRUN_WAIT_S)
    if rc != 0 or not path.exists():
        fail(f"the dry-run subprocess exited {rc}")
    return json.loads(path.read_text())


def cell_args(api, shape: str, B: int) -> tuple:
    """Real arguments of the cell's step on the card: weights from a
    CUDA generator, tokens and labels from a seeded generator, the decode
    cache from ``init_cache`` at the cell's depth, every row at its last
    position; AdamW's moments for a train cell."""
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    cell = registry.SHAPES[shape]
    S = cell.seq_len
    g = torch.Generator("cuda").manual_seed(0)
    params = api.init(g)
    V = api.cfg.vocab

    def ints(*shape_):
        return torch.randint(0, V, shape_, generator=g, device="cuda",
                             dtype=torch.int32)

    if cell.kind == "decode":
        cache = api.init_cache(B, S)
        pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        return (params, cache, ints(B), pos)
    batch = {"tokens": ints(B, S), "labels": ints(B, S)}
    if cell.kind == "prefill":
        return (params, batch)
    return (params, adamw_init(params), batch)


def dryrun_vs_card(pred: list) -> list:
    """Each DRYRUN_CARD_CELLS cell's step run for real on the card, on the
    arguments the dry-run traced as fake tensors, as a user runs it
    (remat for train; no shard env and no unroll knob, as the dry-run
    traces a (1, 1) mesh): the FLOPs ``FlopCounterMode`` counts on the
    card equal the dry-run's count (the ``wkv6`` ops through their
    formulas); the argument bytes
    the tensors requested equal the prediction, and the bytes the
    allocator holds for them equal it within ``ALLOC_ROUND`` a tensor; the
    peak (``max_memory_allocated`` over the allocation before
    the arguments) within ``PEAK_RTOL`` of the predicted peak; and the
    roofline's lower bound, the larger of the FLOPs over the bf16 dense
    peak and the argument bytes over the HBM rate, at most the profiled
    device time of the step (a bound above it is a counting fault)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import roofline
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry, runconfig
    from repro_torch.models.layers import tree_leaves
    rows = []
    for (arch, shape, B, layers), p in zip(DRYRUN_CARD_CELLS, pred):
        kind = registry.SHAPES[shape].kind
        api = cell_api(arch, layers, "cuda")
        # garbage of earlier phases collected now, not freed by a
        # collection during the measured step (that once lowered the peak
        # over the base by 7.9 GB); the collector stays on in the step, as
        # it is while the dry-run traces it (with it off, rwkv6-7b's peak
        # read 6.9 % above the prediction)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        base_req = torch.cuda.memory_stats()["requested_bytes.all.current"]
        args = cell_args(api, shape, B)
        torch.cuda.synchronize()
        arg_bytes = torch.cuda.memory_allocated() - base
        requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
        n_args = sum(1 for a in args for _ in (
            tree_leaves(a) if isinstance(a, dict) else [a]))
        step = {"train": steps_lib.make_train_step,
                "prefill": steps_lib.make_prefill_step,
                "decode": steps_lib.make_serve_step}[kind](api)

        def run():
            with runconfig.options(remat=kind == "train"):
                return step(*args)

        run()                  # a first call: lazy initialisation out of
        reset_all_launches()   # the counted one
        with FlopCounterMode(display=False) as fc:
            out = run()
        launches = all_launches()
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        ops, dev_ms = profile_once(lambda: run())
        flops = fc.get_total_flops()
        want_flops = p["cost_analysis"]["global_flops"]
        ma = p["memory_analysis"]
        compute_ms = flops / roofline.PEAK_FLOPS * 1e3
        args_ms = ma["argument_size_in_bytes"] / roofline.HBM_BW * 1e3
        upper_ms = p["cost_analysis"]["bytes accessed"] / roofline.HBM_BW \
            * 1e3
        row = {"arch": arch, "shape": shape, "batch": B, "layers": layers,
               "flops_card": flops, "flops_dryrun": want_flops,
               "flops_by_op_card": {str(k): v for k, v in
                                    fc.get_flop_counts()["Global"].items()},
               "flops_by_op_dryrun": p["cost_analysis"][
                   "global_flops_by_op"],
               "arg_bytes_card": arg_bytes,
               "arg_bytes_dryrun": ma["argument_size_in_bytes"],
               "arg_requested_bytes_card": requested - base_req,
               "arg_tensors": n_args, "peak_bytes_card": peak,
               "peak_bytes_dryrun": ma["peak_bytes"],
               "peak_ratio": peak / ma["peak_bytes"],
               "compute_term_ms": compute_ms, "args_memory_term_ms": args_ms,
               "bytes_accessed_term_ms": upper_ms,
               "device_ms": dev_ms, "device_ops": ops,
               "trace_s": p["trace_s"], "launches": launches,
               "card": gpu_line()}
        print(json.dumps({"dryrun_vs_card": row}), flush=True)
        if flops != want_flops:
            fail(f"{arch} {shape}: FlopCounterMode counts {flops} FLOPs on "
                 f"the card, the dry-run {want_flops}")
        if requested - base_req != ma["argument_size_in_bytes"] \
                or abs(arg_bytes - ma["argument_size_in_bytes"]) \
                > ALLOC_ROUND * n_args:
            fail(f"{arch} {shape}: the arguments requested "
                 f"{requested - base_req} bytes and hold {arg_bytes} on the "
                 f"card, the dry-run predicted "
                 f"{ma['argument_size_in_bytes']}")
        if not abs(peak / ma["peak_bytes"] - 1) <= PEAK_RTOL:
            fail(f"{arch} {shape}: peak {peak} bytes on the card against "
                 f"{ma['peak_bytes']} predicted (limit {PEAK_RTOL})")
        if max(compute_ms, args_ms) > dev_ms:
            fail(f"{arch} {shape}: the roofline bound "
                 f"{max(compute_ms, args_ms)} ms is above the measured "
                 f"{dev_ms} ms: a counting fault")
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    return rows


def remat_on_card() -> dict:
    """Remat on the card: rwkv6-7b's gradient at RWKV_GRAD_LAYERS layers,
    (B, S) = REMAT_RWKV, f32 weights, TF32 off, with ``runconfig``'s
    remat and without: every leaf within REMAT_TOL of its largest
    magnitude (expected bit-equal: the recomputed forward launches the
    same kernel on the same inputs); ``wkv6`` launched 2 x layers with
    remat (the recompute) and layers without, ``wkv6_backward`` layers
    both ways. Then smollm-135m FULL at (B, S) = REMAT_SMOLLM, one loss
    and gradient with remat and one without: equal losses, and the peak
    GB and step ms of each recorded."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    from repro_torch.models import registry, runconfig
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S = REMAT_RWKV
    api = rwkv_model(RWKV_GRAD_LAYERS, torch.float32)
    L = api.cfg.num_layers
    params = api.init(torch.Generator("cuda").manual_seed(2))
    batch = train_batch(api, B, S, 2)
    got = {}
    for remat in (True, False):
        reset_all_launches()
        with runconfig.options(remat=remat):
            loss, _, grads = value_and_grad(api.loss_fn, params, batch,
                                            torch.float32)
        torch.cuda.synchronize()
        got[remat] = (loss, grads, all_launches())
    worst, where = 0.0, None
    for (path, a), b in zip(leaf_paths(got[True][1]),
                            nn.tree_leaves(got[False][1])):
        share = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                 1e-30)
        if share > worst:
            worst, where = share, path
    lw = {k: got[k][2] for k in got}
    if not worst <= REMAT_TOL:
        fail(f"rwkv6-7b: remat moved the gradient of {where} by {worst} of "
             f"its largest magnitude (limit {REMAT_TOL})")
    if (lw[True]["wkv6"], lw[False]["wkv6"]) != (2 * L, L) \
            or lw[True]["wkv6_backward"] != L \
            or lw[False]["wkv6_backward"] != L:
        fail(f"rwkv6-7b remat launches {lw}: want wkv6 {2 * L} with remat, "
             f"{L} without, wkv6_backward {L} both ways")
    rwkv = {"layers": L, "batch": B, "seq": S, "worst_leaf_share": worst,
            "worst_leaf": where, "bit_equal": worst == 0.0,
            "loss": {str(k): got[k][0].item() for k in got},
            "launches": {"remat": lw[True], "no_remat": lw[False]}}
    del params, got
    torch.cuda.empty_cache()
    # the process's own setting back: the snapshot phase after this one
    # serves the main path's tokens, whose f32 score products TF32 would
    # round otherwise (its tokens changed so once)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    api = registry.build("smollm-135m", smoke=False, device="cuda")
    params = api.init(torch.Generator("cuda").manual_seed(3))
    batch = train_batch(api, *REMAT_SMOLLM, 3)
    smollm = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with runconfig.options(remat=remat):
            loss, _, grads = value_and_grad(api.loss_fn, params, batch,
                                            torch.bfloat16)
        torch.cuda.synchronize()
        smollm[str(remat)] = {
            "loss": loss.item(), "step_ms": (time.perf_counter() - t0) * 1e3,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        del grads
    if smollm["True"]["loss"] != smollm["False"]["loss"]:
        fail(f"smollm-135m: remat changed the loss: {smollm}")
    out = {"rwkv6": rwkv, "smollm": {"batch": REMAT_SMOLLM[0],
                                     "seq": REMAT_SMOLLM[1], **smollm},
           "card": gpu_line()}
    print(json.dumps({"remat_on_card": out}), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def dryrun_cells(cells: list) -> list:
    """The production dry-run of DRYRUN_CELLS on the card machine's host
    (the ``--dryruns`` subprocess): each must end ``ok``."""
    rows = [{k: r.get(k) for k in ("arch", "shape", "mesh", "status",
                                   "error", "cost_analysis", "collectives",
                                   "memory_analysis", "total_s")}
            for r in cells]
    print(json.dumps({"dryrun_cells": rows}), flush=True)
    for r in rows:
        if r["status"] != "ok":
            fail(f"dry-run {r['arch']} {r['shape']} {r['mesh']}: "
                 f"{r['status']} {r['error']}")
    return rows


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


def all_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import vector_distance as vd
    return {**ds.LAUNCHES, **vd.LAUNCHES, **fa.LAUNCHES, **rs.LAUNCHES}


def reset_all_launches() -> None:
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import vector_distance as vd
    for mod in (ds, vd, fa, rs):
        mod.reset_launches()


def serve_unpaged(path: str, api, params, settings: dict) -> dict:
    """An unpaged serving path at full width: ``api``'s model through
    ``ServeEngine`` with paging gated off by its cache family, replaying
    the engine's step graphs, every request token for token against
    ``reference_decode`` in batches of the engine's max_batch; then once
    more with the eager megastep, which must serve the same tokens and
    stats. No kernel may launch in the run (the recurrences run their
    one-step form and attention its plain decode). Also reads the peak
    device memory of the run. Returns the phase's numbers and one
    ``decode_step`` call at the engine's batch on a fresh cache, for the
    caller to profile."""
    from repro_torch.serve import EngineConfig, ServeEngine

    arch = api.arch_id
    prompts = np.random.default_rng(6).integers(
        0, api.cfg.vocab, (RWKV_REQUESTS, RWKV_PROMPT)).astype(np.int32)
    engine_cfg = EngineConfig(**settings, max_queue=RWKV_REQUESTS + 8,
                              device="cuda")
    warm = ServeEngine(api, params, engine_cfg)
    for i in range(settings["max_batch"]):
        warm.submit(prompts[i, :8], 4)
    warm.run()
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(api, params, engine_cfg)
    if eng.paged or eng.pool is not None:
        fail(f"{arch}: the engine paged a {api.cache_kind} cache")
    rids = [eng.submit(prompts[i], RWKV_GEN,
                       arrival_step=i * ARRIVAL_EVERY).rid
            for i in range(RWKV_REQUESTS)]
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    check_decode(api, params, prompts, outs, rids, RWKV_GEN,
                 settings["max_batch"], settings["cache_len"])
    ps = eng.paging_stats()
    if ps["paged"] is not False:
        fail(f"{arch}: paging_stats says paged={ps['paged']}")
    if any(launches.values()):
        fail(f"{arch}: serving launched kernels {launches} (want none)")
    tokens = sum(len(outs[r]) for r in rids)
    graphs = graph_lines(path, eng)
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
        fail(f"{arch}: the eager megastep served otherwise")
    peak = torch.cuda.max_memory_allocated()
    eager_steps = eager.decode_steps
    del eager
    B = settings["max_batch"]
    cache = api.init_cache(B, settings["cache_len"])
    toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
    out = {"arch": arch, "requests": RWKV_REQUESTS,
           "prompt": RWKV_PROMPT, "gen": RWKV_GEN, "tokens": tokens,
           "max_batch": B, "paged": ps["paged"], "wall_ms": wall * 1e3,
           "tokens_per_s": tokens / wall, "launches": launches,
           "steps": ps["steps"], "host_dispatches": ps["host_dispatches"],
           "megasteps": ps["megasteps"], "host_blocked": ps["host_blocked"],
           "decode_steps": eng.decode_steps,
           "wall_ms_per_decode_step": wall * 1e3 / eng.decode_steps,
           "peak_memory_bytes": peak, **graphs, "eager": {
               "wall_ms": ewall * 1e3, "tokens_per_s": tokens / ewall,
               "wall_ms_per_decode_step": ewall * 1e3 / eager_steps},
           "card": gpu_line()}
    print(f"served {RWKV_REQUESTS} requests of {arch} (full width) on "
          f"the card: {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tok/s), all token-exact vs "
          f"reference_decode, paged={ps['paged']}", flush=True)
    return out, lambda: api.decode_step(params, cache, toks, toks)


def profile_once(fn) -> tuple[int, float]:
    """One profile of one call of ``fn``, taken as it comes (late in the
    process the profiler loses an event or a few of a window, PERF.md):
    its device operations and device ms. Fails if it saw nothing."""
    count, ns, _ = _profile(fn, iters=1)
    if not count:
        fail("the profiler saw no device operation of a profiled call")
    return sum(count.values()), sum(ns.values()) / 1e6


def step_profile(step) -> dict:
    """One ``decode_step`` call profiled as it comes (``profile_once``),
    after a warm-up call."""
    step()
    ops, ms = profile_once(step)
    return {"decoder_ops_per_step": ops, "decoder_ms_per_step": ms}


def rwkv_serve_phase(api, params) -> dict:
    """The RWKV serving path: rwkv6-7b FULL through ``serve_unpaged``.
    Decode runs the one-step recurrence, not the kernel: its wkv6
    launches must be 0 (as every kernel's). One ``decode_step`` at the
    engine's batch is profiled until two profiles see the same whole
    calls (``device_profile``)."""
    out, step = serve_unpaged("rwkv", api, params, RWKV_SERVE)
    out["decoder_ms_per_step"], out["decoder_ops_per_step"] = \
        device_profile(step, iters=5)
    out["wkv6_launches"] = out["launches"]["wkv6"]
    print(json.dumps({"rwkv_serve_phase": out}), flush=True)
    return out


def full_api(arch: str, dims: tuple, fields: tuple):
    """``arch``'s FULL config on the card; fails unless the config's
    ``fields`` read ``dims``."""
    from repro_torch.models import registry
    api = registry.build(arch, smoke=False, device="cuda")
    got = tuple(getattr(api.cfg, f) for f in fields)
    if got != dims:
        fail(f"{arch}: not the full-width config: {dict(zip(fields, got))}")
    return api


def model_on_card(arch: str, dims: tuple, fields: tuple):
    """``full_api``, its weights drawn on the card from a seed with a CUDA
    generator (drawing billions of values on the host would take about a
    minute). Returns (api, params, init seconds)."""
    api = full_api(arch, dims, fields)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    return api, params, time.perf_counter() - t0


def param_bytes(params) -> int:
    from repro_torch.models import layers as nn
    return sum(t.numel() * t.element_size() for t in nn.tree_leaves(params))


def zamba2_serve_phase(api, params) -> dict:
    """The Zamba2 serving path: zamba2-7b FULL through ``serve_unpaged``
    at ``NESTED_SERVE``: its nested cache (the Mamba state of 81 layers
    kept per row, the 13 shared-attention rings written in place) on the
    step graphs, then eager; one ``decode_step`` profiled as it comes
    (``step_profile``)."""
    out, step = serve_unpaged("zamba2", api, params, NESTED_SERVE)
    out.update(step_profile(step))
    print(json.dumps({"zamba2_serve_phase": out}), flush=True)
    return out


def zamba2_decode_logits(api, params, tokens, n: int, reset_at=None):
    """The logits of ``n`` ``decode_step``s over the first ``n`` tokens,
    (B, n, V) in f32. ``reset_at``: the control fault, the Mamba state of
    every layer zeroed before that step (a carry the decode lost)."""
    B = tokens.shape[0]
    cache = api.init_cache(B, tokens.shape[1])
    steps = []
    for t in range(n):
        if t == reset_at:
            cache["mamba"]["ssm"].zero_()
        lg, cache = api.decode_step(
            params, cache, tokens[:, t],
            torch.full((B,), t, dtype=torch.int32, device="cuda"))
        steps.append(lg.float())
    return torch.stack(steps, dim=1)


def zamba2_forward_phase(api, params, B: int, S: int) -> dict:
    """One zamba2-7b FULL forward at (B, S) under ``inference_mode``: no
    kernel launched, logits finite; one wall reading and one profile of
    the forward taken as it comes. Then the forward against the stepwise
    decode: ZAMBA_DECODE_CHECK ``decode_step``s of the same tokens against
    the forward's first positions, the bf16 gap recorded, and the gate in
    f32 (the weights cast to f32, TF32 off): within ZAMBA_F32_TOL, atol =
    rtol, the CPU test's f32 tolerance; the control (the Mamba state
    zeroed halfway) must exceed it. In bf16 the two differ by rounding
    alone beyond the CPU test's 1e-2 (PERF.md, PR 21)."""
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, api.cfg.vocab, (B, S))).cuda()
    batch = {"tokens": tokens}
    n = ZAMBA_DECODE_CHECK
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        logits = api.forward(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        if any(launches.values()):
            fail(f"zamba2-7b: the forward launched kernels {launches}")
        if logits.shape != (B, S, api.cfg.vocab) or \
                not torch.isfinite(logits).all():
            fail(f"zamba2-7b: forward logits {tuple(logits.shape)} not "
                 f"finite")
        ops, device_ms = profile_once(lambda: api.forward(params, batch))
        t0 = time.perf_counter()
        dec = zamba2_decode_logits(api, params, tokens, n)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
        bf16_gap = (dec - logits[:, :n].float()).abs().max().item()
        del dec, logits
        torch.cuda.empty_cache()
        # the gate, in f32
        from repro_torch.models import layers as nn
        from repro_torch.models import registry
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            api32 = registry._hybrid_api(
                api.arch_id, dataclasses.replace(api.cfg,
                                                 dtype=torch.float32),
                api.device)
            p32 = nn.tree_map(lambda t: t.float(), params)
            want = api32.forward(p32, batch)[:, :n].float()
            gap = (zamba2_decode_logits(api32, p32, tokens, n)
                   - want).abs()
            control = (zamba2_decode_logits(api32, p32, tokens, n,
                                            reset_at=n // 2)
                       - want).abs()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        bound = ZAMBA_F32_TOL * (1 + want.abs())
        passed = bool((gap <= bound).all())
        caught = bool((control > bound).any())
        f32_max, control_max = gap.max().item(), control.max().item()
        del p32, want, gap, control, bound
    torch.cuda.empty_cache()
    out = {"arch": "zamba2-7b", "batch": B, "seq": S,
           "layers": api.cfg.num_layers,
           "attn_apps": api.cfg.num_attn_apps, "launches": launches,
           "forward_ms": wall * 1e3, "forward_device_ms": device_ms,
           "device_ops": ops, "tokens_per_s": B * S / wall,
           "decode_check_positions": n,
           "decode_check_wall_ms": dec_wall * 1e3,
           "bf16_decode_vs_forward_max_abs_diff": bf16_gap,
           "f32_decode_vs_forward_max_abs_diff": f32_max,
           "f32_tol": ZAMBA_F32_TOL,
           "control_fault": f"Mamba state zeroed at step {n // 2}",
           "f32_control_max_abs_diff": control_max, "card": gpu_line()}
    print(json.dumps({"zamba2_forward_phase": out}), flush=True)
    if not passed:
        fail(f"zamba2-7b: {n} f32 decode steps differ from the f32 "
             f"forward's first positions by up to {f32_max} (limit "
             f"{ZAMBA_F32_TOL} absolute plus relative)")
    if not caught:
        fail(f"zamba2-7b: the control ({out['control_fault']}) moved the "
             f"f32 logits by {control_max}, within the limit: the check "
             f"cannot see it")
    return out


def whisper_phase(B: int, S_enc: int, S_dec: int) -> dict:
    """whisper-base FULL on the card: served through ``serve_unpaged``
    (its self rings written in place, the cross K/V zeros, as the
    reference serves it), then one forward at (B, S_enc stub frames,
    S_dec decoder tokens) under ``inference_mode``: no kernel launched,
    logits finite, one wall reading and one profile taken as it comes.
    The model is freed before returning."""
    api, params, init_s = model_on_card(
        "whisper-base", (6, 512, 8, 8, 2048, 51865),
        ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
         "vocab"))
    served, step = serve_unpaged("whisper", api, params, NESTED_SERVE)
    served.update(step_profile(step))
    gen = torch.Generator("cuda").manual_seed(8)
    batch = {"frames": torch.randn((B, S_enc, api.cfg.d_model),
                                   generator=gen, device="cuda"),
             "tokens": torch.from_numpy(np.random.default_rng(9).integers(
                 0, api.cfg.vocab, (B, S_dec))).cuda()}
    with torch.inference_mode():
        api.forward(params, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        logits = api.forward(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        if any(launches.values()):
            fail(f"whisper-base: the forward launched kernels {launches}")
        if logits.shape != (B, S_dec, api.cfg.vocab) or \
                not torch.isfinite(logits).all():
            fail(f"whisper-base: forward logits {tuple(logits.shape)} not "
                 f"finite")
        ops, device_ms = profile_once(lambda: api.forward(params, batch))
        del logits
    out = {"serve": served, "forward": {
        "batch": B, "frames": S_enc, "tokens": S_dec, "launches": launches,
        "forward_ms": wall * 1e3, "forward_device_ms": device_ms,
        "device_ops": ops, "peak_memory_bytes": peak},
        "param_bytes": param_bytes(params), "init_s": init_s,
        "card": gpu_line()}
    del params, batch
    torch.cuda.empty_cache()
    print(json.dumps({"whisper_phase": out}), flush=True)
    return out


def check_bmm_f32() -> dict:
    """``layers._bmm_f32`` on the card at kimi-k2's expert shape (8 slots,
    7168 -> 2048; 64 of its 384 experts) against the f32 product of the
    same bf16 operands (TF32 off): an f32 result within BMM_F32_RTOL of
    the largest |product|, and the bf16-rounded product (the control)
    beyond it."""
    from repro_torch.models import layers as nn
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator("cuda").manual_seed(5)
        a = torch.randn((64, 8, 7168), generator=g,
                        device="cuda").to(torch.bfloat16)
        b = (torch.randn((64, 7168, 2048), generator=g, device="cuda")
             / 7168 ** 0.5).to(torch.bfloat16)
        got = nn._bmm_f32(a, b)
        want = torch.bmm(a.float(), b.float())
        control = torch.bmm(a, b).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    top = want.abs().max().item()
    err = (got - want).abs().max().item() / top
    control_err = (control - want).abs().max().item() / top
    out = {"shape": [64, 8, 7168, 2048], "dtype": str(got.dtype),
           "max_rel_err": err, "control_max_rel_err": control_err,
           "rtol": BMM_F32_RTOL, "torch": torch.__version__}
    print(json.dumps({"bmm_f32": out}), flush=True)
    if got.dtype != torch.float32 or not err <= BMM_F32_RTOL:
        fail(f"_bmm_f32 on the card: {got.dtype}, {err} relative to the "
             f"f32 product (limit {BMM_F32_RTOL})")
    if not control_err > BMM_F32_RTOL:
        fail(f"the bf16-rounded product is {control_err} off, within the "
             f"limit {BMM_F32_RTOL}: the check cannot see a rounding")
    return out


def moe_api(arch: str, layers: int, dims: tuple):
    """``arch``'s FULL config cut to its first ``layers`` layers, widths
    untouched, on the card; fails unless the published config reads
    ``dims``. Returns (api, the cut)."""
    from repro_torch.models import registry
    full = registry.build(arch, smoke=False, device="cuda").cfg
    got = (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
           full.d_ff, full.vocab, full.moe.num_experts, full.moe.top_k,
           full.window)
    if got != dims:
        fail(f"{arch}: not the published config: {got}")
    api = registry._lm_api(arch, dataclasses.replace(full,
                                                     num_layers=layers),
                           "cuda")
    return api, {"num_layers": [full.num_layers, layers]}


def moe_model(arch: str, layers: int, dims: tuple):
    """``moe_api``, its weights drawn on the card from a seed with a CUDA
    generator (the expert stacks one matrix at a time). Returns (api,
    params, init seconds, the cut)."""
    api, reduced = moe_api(arch, layers, dims)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    return api, params, time.perf_counter() - t0, reduced


def moe_serve_phase(api, params, reduced: dict, shapes: dict) -> dict:
    """An MoE serving path: ``api``'s model (cut in depth) through
    ``serve_full`` (the main path's settings and its first MOE_REQUESTS
    requests, graphed under the sync watch, token-exact, both ways paged,
    the stream kernels launched; their shapes added to ``shapes``), then
    ``served_run`` with the eager megastep (the same tokens, launches,
    stats and paging). One ``decode_step`` at the engine's batch profiled
    as it comes (``step_profile``)."""
    arch = api.arch_id
    _, run = serve_full(api, params, shapes, path=arch,
                        requests=MOE_REQUESTS)
    eager, ewall = served_run(run, graphs=False)
    del eager
    B = SERVE["max_batch"]
    cache = api.init_cache(B, SERVE["cache_len"])
    toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
    tokens = sum(len(t) for t in run["tokens"])
    steps, wall, ps = run["decode_steps"], run["wall"], run["paging"]
    out = {"arch": arch, "reduced": reduced, "requests": MOE_REQUESTS,
           "prompt": PROMPT_LEN, "gen": GEN, "tokens": tokens,
           "max_batch": B, "wall_ms": wall * 1e3,
           "tokens_per_s": tokens / wall, "decode_steps": steps,
           "wall_ms_per_decode_step": wall * 1e3 / steps,
           "launches": run["launches"],
           "paging": {k: ps[k] for k in (
               "page_ins", "page_outs", "kernel_calls", "duplex_us",
               "serial_us", "duplex_speedup", "steps", "megasteps",
               "host_dispatches", "host_blocked")},
           "peak_memory_bytes": run["peak_memory_bytes"],
           "graphs": run["graphs"], "capture_s": run["capture_s"],
           "eager": {"wall_ms": ewall * 1e3, "tokens_per_s": tokens / ewall,
                     "wall_ms_per_decode_step": ewall * 1e3 / steps},
           **step_profile(lambda: api.decode_step(params, cache, toks, toks)),
           "card": gpu_line()}
    print(json.dumps({"moe_serve_phase": out}), flush=True)
    return out


@contextlib.contextmanager
def routing(replay=None):
    """Record the experts each ``top_k`` call of the MoE layers picks, in
    call order (a list of (T, K) index tensors: per layer, ``moe_apply``'s
    then ``moe_aux_loss``'s), or, given such a list, make each call pick
    those experts (its gate values gathered from its own logits)."""
    from repro_torch.models import layers as nn
    real, picked = nn.top_k, []

    def pick(x, k):
        if replay is None:
            vals, idx = real(x, k)
        else:
            idx = replay[len(picked)]
            vals = torch.gather(x, -1, idx)
        picked.append(idx)
        return vals, idx

    nn.top_k = pick
    try:
        yield picked
    finally:
        nn.top_k = real


def forward_check(api, params, B: int, S: int) -> dict:
    """One full-width forward of ``api``'s model at (B, S) with the flash
    kernel and one without, under ``inference_mode``: the kernel launched
    once per layer and no other kernel, logits finite and within
    LOGITS_ATOL of the plain forward's, which a control (one kv tile
    lost: a window of W - 64, of S - 64 without one) must exceed; one wall
    reading each and one profile of the kernel's forward, taken as it
    comes (the launch counter is the check of the launches; the
    profiler's own count is reported beside it).

    An MoE config's two forwards route each token on their own logits,
    and a token whose K-th and (K+1)-th router logits nearly tie can take
    another expert in each, which moves its output by the gap between two
    experts' outputs, not by rounding. So there the plain forward and the
    control replay the kernel forward's routing (``routing``), and the
    plain forward on its own routing is recorded beside them, with the
    count of (layer, token) routings that differ."""
    from repro_torch.models import transformer as T
    cfg = api.cfg
    arch, L = api.arch_id, cfg.num_layers
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S))).cuda()
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        with routing() as picked:
            t0 = time.perf_counter()
            lk, aux = T.forward(params, cfg, tokens, None, use_kernel=True)
            torch.cuda.synchronize()
            wall_kernel = time.perf_counter() - t0
        launches = all_launches()
        reset_all_launches()
        with routing() as own:
            t0 = time.perf_counter()
            lp, _ = T.forward(params, cfg, tokens, None)
            torch.cuda.synchronize()
            wall_plain = time.perf_counter() - t0
        plain_launches = all_launches()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if launches["flash_attention"] != L or any(
                n for k, n in launches.items() if k != "flash_attention") \
                or any(plain_launches.values()):
            fail(f"{arch}: forward launched {launches} with use_kernel "
                 f"(want {L} flash_attention) and {plain_launches} without")
        if lk.shape != (B, S, cfg.vocab) or not torch.isfinite(lk).all():
            fail(f"{arch}: forward logits {tuple(lk.shape)} not finite")
        replay = picked or None
        if replay:
            out.update(aux=aux.item(), routings=L * B * S, routing_flips=sum(
                int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                for a, b in zip(picked[::2], own[::2])),
                plain_own_routing_max_abs_diff=(
                    lk.float() - lp.float()).abs().max().item())
            del lp
            with routing(replay):
                lp, _ = T.forward(params, cfg, tokens, None)
        del own
        diff = (lk.float() - lp.float()).abs().max().item()
        fault = dataclasses.replace(cfg, window=(cfg.window or S) - 64)
        with routing(replay):
            lc, _ = T.forward(params, fault, tokens, None)
        control = (lc.float() - lp.float()).abs().max().item()
        del lc, lk, lp, picked, replay
        if not diff <= LOGITS_ATOL:
            fail(f"{arch}: logits with the kernel differ from the plain "
                 f"forward's by {diff} (limit {LOGITS_ATOL})")
        if not control > LOGITS_ATOL:
            fail(f"{arch}: the control fault moved the logits by {control}, "
                 f"within the limit {LOGITS_ATOL}")
        count, ns, _ = _profile(lambda: T.forward(params, cfg, tokens, None,
                                                  use_kernel=True), iters=1)
    torch.cuda.empty_cache()
    return {"arch": arch, "batch": B, "seq": S, "layers": L,
            "head_dim": cfg.resolved_head_dim(), "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "window": cfg.window,
            "launches": launches["flash_attention"],
            "forward_kernel_ms": wall_kernel * 1e3,
            "forward_plain_ms": wall_plain * 1e3,
            "forward_device_ms": sum(ns.values()) / 1e6,
            "device_ops": sum(count.values()),
            "flash_kernel_ms": sum(t for n, t in ns.items()
                                   if "flash_kernel" in n) / 1e6,
            "flash_kernels_profiled": sum(c for n, c in count.items()
                                          if "flash_kernel" in n),
            "logits_max_abs_diff": diff,
            "control_logits_max_abs_diff": control, **out,
            "card": gpu_line()}


def moe_phases(shapes: dict, mark) -> dict:
    """Each MoE config of MOE_RUNS drawn on the card, served
    (``moe_serve_phase``), its forward held by ``forward_check``, and
    freed before the next is drawn; ``mark`` after each."""
    out = {}
    for arch, layers, dims, (B, S) in MOE_RUNS:
        api, params, init_s, reduced = moe_model(arch, layers, dims)
        print(json.dumps({"moe_model": {
            "arch": arch, "reduced": reduced,
            "param_bytes": param_bytes(params), "init_s": init_s,
            "card": gpu_line()}}), flush=True)
        serve = moe_serve_phase(api, params, reduced, shapes)
        forward = {**forward_check(api, params, B, S), "reduced": reduced,
                   "experts": api.cfg.moe.num_experts,
                   "top_k": api.cfg.moe.top_k}
        print(json.dumps({"moe_forward": forward}), flush=True)
        out[arch] = {"serve": serve, "forward": forward}
        del api, params
        torch.cuda.empty_cache()
        mark(f"moe_{arch}")
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


def serve_full(api, params, shapes_seen: dict, path: str = "main",
               requests: int = N_REQUESTS) -> tuple[dict, dict]:
    """The main path: smollm-135m FULL (or, on the MoE paths, ``api``'s
    model) served through the paged pool on the card, replaying the
    engine's step graphs under the sync watch: every request token for
    token against ``reference_decode``, both ways paged, the three stream
    kernels launched, no host sync. Returns the launch counts of this run
    alone, and the run (a function that builds its engine, its tokens,
    launches, stats, paging stats, wall seconds, decode steps and peak
    device memory) for ``served_run``, ``megastep_turns`` and
    ``profile_serving``."""
    from repro_torch.device import sync_watch
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = api.cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (requests, PROMPT_LEN)).astype(np.int32)
    engine_cfg = EngineConfig(**SERVE, max_queue=requests + 8,
                              device="cuda")

    def main_run_engine(model=api, graphs: bool = True) -> tuple:
        """A fresh engine holding the path's requests: replaying its step
        graphs, or running the eager megastep."""
        eng = ServeEngine(model, params, engine_cfg,
                          _graphs=None if graphs else False)
        rids = [eng.submit(prompts[i], GEN,
                           arrival_step=i * ARRIVAL_EVERY).rid
                for i in range(requests)]
        return eng, rids

    # warm the libraries and the allocator on a full batch of short requests
    warm = ServeEngine(api, params, engine_cfg)
    for i in range(SERVE["max_batch"]):
        warm.submit(prompts[i, :8], 8)
    warm.run()
    del warm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, rids = main_run_engine()
    torch.cuda.synchronize()
    ds.reset_launches()
    with sync_watch() as syncs, stream_shapes(shapes_seen):
        t0 = time.perf_counter()
        outs = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ds.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

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
    if syncs:
        fail(f"{path}: the graphed run synced with the host: {dict(syncs)}")
    tokens = sum(len(v) for v in outs.values())
    print(f"served {requests} requests of {api.arch_id} (full width, "
          f"{cfg.num_layers} layers) on "
          f"the card: {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tok/s), all token-exact vs "
          f"reference_decode; page_ins={ps['page_ins']} "
          f"page_outs={ps['page_outs']} kernel_calls={ps['kernel_calls']} "
          f"duplex_speedup={ps['duplex_speedup']:.4f} launches={launches} "
          f"host_blocked={ps['host_blocked']} megasteps={ps['megasteps']}",
          flush=True)
    return launches, {"engine": main_run_engine,
                      "tokens": [outs[r] for r in rids],
                      "timing": [(engine.completed[r].admitted_step,
                                  engine.completed[r].done_step)
                                 for r in rids],
                      "launches": launches, "stats": engine.stats(),
                      "paging": ps, "wall": wall,
                      "decode_steps": engine.decode_steps,
                      "peak_memory_bytes": peak, "path": path,
                      **graph_lines(path, engine)}


def served_run(main: dict, graphs: bool) -> tuple:
    """One more run of the main path's requests on a fresh engine,
    replaying its step graphs or running the eager megastep: the same
    tokens, launches, stats and paging stats as the main run, or fail.
    Returns the engine and the wall seconds of ``run()``."""
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
        fail(f"the {main['path']} path's {mode} run served other tokens")
    if dict(ds.LAUNCHES) != main["launches"] or \
            eng.stats() != main["stats"] or \
            eng.paging_stats() != main["paging"]:
        fail(f"the {main['path']} path's {mode} run launched "
             f"{dict(ds.LAUNCHES)} with stats {eng.stats()}; the first run "
             f"{main['launches']}, {main['stats']}")
    return eng, wall


def sharded_run(api, params, dm: tuple, graphs: bool,
                requests: int = N_REQUESTS, gen: int = GEN,
                hbm_blocks: int | None = None) -> dict:
    """The main path's first ``requests`` requests (``gen`` tokens each) on
    a ``ShardedServeEngine`` over a ``dm`` = (data, model) mesh of logical
    ranks on the card, each rank on its own step graphs or the eager
    megastep; the graphed run under the sync watch, with the readbacks
    counted (``_Readback.wait``) and ``check_invariants`` after every
    boundary. Each pool shard holds ``hbm_blocks`` (default: the flat
    pool's split over the data ranks). Returns the run's readings, wall
    seconds and syncs."""
    from repro_torch.device import sync_watch
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import EngineConfig, ShardedServeEngine
    from repro_torch.serve import engine as engine_mod

    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    d, m = dm
    mesh = make_debug_mesh(m, devices=[torch.device("cuda", 0)] * (d * m))
    # every pool shard is built with the config's hbm_blocks: split the
    # flat pool's HBM over the shards, so the mesh holds as much as it and
    # every shard pages (with all 48 a shard of 4 rows never evicts)
    settings = dict(SERVE, hbm_blocks=hbm_blocks or SERVE["hbm_blocks"] // d)
    eng = ShardedServeEngine(
        api, params, EngineConfig(**settings, max_queue=N_REQUESTS + 8,
                                  device="cuda"),
        mesh=mesh, _graphs=None if graphs else False)
    rids = [eng.submit(prompts[i], gen, arrival_step=i * ARRIVAL_EVERY).rid
            for i in range(requests)]
    pool = eng.pool
    # wrapped here, not in the package: invariants at every boundary, and
    # the readbacks the host waited on
    reconcile, wait = eng._reconcile, engine_mod._Readback.wait
    boundaries, waits = [0], [0]

    def checked_reconcile(rec):
        out = reconcile(rec)
        pool.check_invariants()
        boundaries[0] += 1
        return out

    def counted_wait(self):
        waits[0] += 1
        return wait(self)

    eng._reconcile = checked_reconcile
    engine_mod._Readback.wait = counted_wait
    torch.cuda.synchronize()
    ds.reset_launches()
    try:
        with (sync_watch() if graphs else contextlib.nullcontext(Counter())) \
                as syncs:
            t0 = time.perf_counter()
            outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod._Readback.wait = wait
    if graphs and (eng.n_graphs == 0 or any(
            len(rk.graphs) > eng.cfg.prefill_chunk + 1
            for rk in eng.ranks)):
        fail(f"mesh {dm}: the ranks did not serve from their step graphs")
    ps = eng.paging_stats()
    readings = {
        "tokens": [outs[r].tolist() for r in rids],
        "timing": [(eng.completed[r].admitted_step,
                    eng.completed[r].done_step) for r in rids],
        "stats": eng.stats(), "paging": ps,
        "launches": dict(ds.LAUNCHES),
        "shard_kernel_calls": [sh.stats["kernel_calls"]
                               for sh in pool.shards],
        "boundaries": boundaries[0], "readbacks": waits[0]}
    return {"readings": readings, "wall": wall, "syncs": dict(syncs),
            "decode_steps": eng.decode_steps, "n_graphs": eng.n_graphs,
            "capture_s": eng.capture_s}


def serve_sharded(api, params, main: dict) -> dict:
    """The sharded path: the main path's requests on ``ShardedServeEngine``
    over each mesh of ``SHARD_MESHES`` (logical ranks on the card), each
    rank replaying its own step graphs: every request's tokens and
    admission/done steps the main path's flat engine's, invariants at
    every boundary, ``/serve/ici/*`` bytes exactly on the axes of size
    > 1, no host sync but the readback (one per dispatched megastep), and
    the stream kernels' launches the CPU rehearsal's (``SHARD_EXPECT``).
    Then (2, 2) graphed and eager on the first ``SHARD_EAGER`` requests:
    equal tokens, stats, paging stats (``ici`` among them) and launches.
    Prints one JSON line; returns it."""
    out = {}
    for dm in SHARD_MESHES:
        run = sharded_run(api, params, dm, graphs=True)
        r = run["readings"]
        name = f"{dm[0]}x{dm[1]}"
        if r["tokens"] != [t.tolist() for t in main["tokens"]]:
            bad = next(i for i, (a, b) in enumerate(
                zip(r["tokens"], main["tokens"])) if a != b.tolist())
            fail(f"mesh {name}: request {bad} served other tokens than "
                 f"the flat engine")
        if r["timing"] != main["timing"]:
            fail(f"mesh {name}: admission/done steps {r['timing']} differ "
                 f"from the flat engine's {main['timing']}")
        if run["syncs"]:
            fail(f"mesh {name}: the graphed run synced with the host: "
                 f"{run['syncs']}")
        if r["readbacks"] != r["stats"]["host_dispatches"]:
            fail(f"mesh {name}: {r['readbacks']} readbacks for "
                 f"{r['stats']['host_dispatches']} dispatched megasteps")
        ici = {axis: r["paging"]["by_path"].get(f"/serve/ici/{axis}",
                                                {}).get("bytes", 0.0)
               for axis in ("data", "model")}
        for axis, size in zip(("data", "model"), dm):
            if (ici[axis] > 0) != (size > 1):
                fail(f"mesh {name}: {ici[axis]} ICI bytes on the {axis} "
                     f"axis of size {size}")
        want = SHARD_EXPECT[dm]
        got = {"launches": r["launches"],
               "shard_kernel_calls": r["shard_kernel_calls"]}
        if got != want:
            fail(f"mesh {name}: launched {got}; the CPU rehearsal "
                 f"{want}")
        tokens = sum(len(t) for t in r["tokens"])
        out[name] = {"tokens_per_s": tokens / run["wall"],
                     "wall_s": run["wall"],
                     "wall_ms_per_decode_step":
                         run["wall"] * 1e3 / run["decode_steps"],
                     "decode_steps": run["decode_steps"],
                     "graphs": run["n_graphs"], "capture_s": run["capture_s"],
                     "launches": r["launches"],
                     "shard_kernel_calls": r["shard_kernel_calls"],
                     "ici": r["paging"]["ici"],
                     "boundaries": r["boundaries"],
                     "readbacks": r["readbacks"]}
    runs = {mode: sharded_run(api, params, (2, 2), mode == "graphs",
                              *SHARD_EAGER)
            for mode in ("graphs", "eager")}
    g, e = runs["graphs"]["readings"], runs["eager"]["readings"]
    for key in ("tokens", "timing", "stats", "paging", "launches",
                "shard_kernel_calls", "readbacks"):
        if g[key] != e[key]:
            fail(f"mesh 2x2: the graphed and eager runs differ in {key}: "
                 f"{g[key]} against {e[key]}")
    if min(g["shard_kernel_calls"]) <= 0 or runs["graphs"]["syncs"]:
        fail(f"mesh 2x2, short run: shard launches "
             f"{g['shard_kernel_calls']}, syncs {runs['graphs']['syncs']}")
    for i, toks in enumerate(g["tokens"]):
        if toks != main["tokens"][i][:SHARD_EAGER[1]].tolist():
            fail(f"mesh 2x2, short run: request {i} served other tokens "
                 f"than the flat engine")
    tokens = sum(len(t) for t in g["tokens"])
    out["2x2_short"] = {
        "requests": SHARD_EAGER[0], "gen": SHARD_EAGER[1],
        "hbm_blocks": SHARD_EAGER[2], "launches": g["launches"],
        "shard_kernel_calls": g["shard_kernel_calls"], **{
            mode: {"tokens_per_s": tokens / run["wall"],
                   "wall_s": run["wall"]}
            for mode, run in runs.items()}}
    out["card"] = gpu_line()
    print("sharded path: " + ", ".join(
        f"{k} {v['tokens_per_s']:.1f} tok/s (shard launches "
        f"{v['shard_kernel_calls']}, capture {v['capture_s']:.2f} s)"
        for k, v in out.items() if k in ("1x1", "2x1", "2x2"))
        + f"; 2x2 on {SHARD_EAGER[0]} requests "
        f"{out['2x2_short']['graphs']['tokens_per_s']:.1f} tok/s graphed, "
        f"{out['2x2_short']['eager']['tokens_per_s']:.1f} eager", flush=True)
    print(json.dumps({"serve_sharded": out}), flush=True)
    return out


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


def snap_engine(api, params, d, plan=None, tiers=None, graphs=True,
                trace=False):
    """An engine of the snapshot path: the main path's SERVE config with
    cuts every SNAP_EVERY megasteps into ``d`` and an injector on
    ``plan`` (an empty plan when None), replaying its step graphs or
    running the eager megastep."""
    from repro_torch.core import faults as faults_lib
    from repro_torch.serve import EngineConfig, ServeEngine
    fx = faults_lib.FaultInjector(
        faults_lib.parse_fault_plan(plan) if plan else [], seed=FAULT_SEED)
    return ServeEngine(api, params, EngineConfig(
        **SERVE, max_queue=N_REQUESTS + 8, tiers=tiers, faults=fx,
        snapshot_every=SNAP_EVERY, snapshot_dir=str(d),
        trace=True if trace else None, device="cuda"),
        _graphs=None if graphs else False)


def snap_signature(eng) -> dict:
    """What a restored run must reproduce: the reference test's
    ``_signature`` (tokens, admission and done steps and failed records
    in submission order, billing per path and per channel, fault stats)
    with ``tier_speedup``."""
    done = sorted(eng.completed)
    ps = eng.paging_stats()
    billing = {k: ps[k] for k in ("duplex_us", "serial_us", "page_ins",
                                  "page_outs", "kernel_calls")}
    billing["by_path"] = {p: {k: st[k] for k in ("duplex_us", "serial_us")}
                          for p, st in ps["by_path"].items()}
    billing["tiers"] = {n: {k: ch[k] for k in ("busy_us", "read_bytes",
                                               "write_bytes")}
                        for n, ch in ps["tiers"]["channels"].items()}
    return {"tokens": [eng.completed[r].generated for r in done],
            "timing": [(eng.completed[r].admitted_step,
                        eng.completed[r].done_step) for r in done],
            "errors": sorted((r.error["kind"], r.error.get("block", -1))
                             for r in eng.failed.values()),
            "billing": billing, "faults": dict(eng.stats()["faults"]),
            "tier_speedup": ps["tier_speedup"]}


def snapshot_sync_sites() -> dict:
    """The source lines where a cut or a restore may read the device:
    the snapshot module, the checkpoint writer, and the pool's
    ``snapshot_state`` / ``load_state`` (file name -> allowed lines)."""
    import inspect
    from repro_torch.checkpoint import sharded
    from repro_torch.serve import kv_pool, snapshot

    def lines(obj):
        src, first = inspect.getsourcelines(obj)
        return set(range(first, first + len(src)))

    return {"snapshot.py": lines(snapshot), "sharded.py": lines(sharded),
            "kv_pool.py": lines(kv_pool.PagedKVPool.snapshot_state)
            | lines(kv_pool.PagedKVPool.load_state)}


def check_sync_sites(syncs: Counter, what: str) -> None:
    """Every sync the watch recorded lies at a snapshot or checkpoint
    site (``snapshot_sync_sites``); the steps between cuts stay
    dispatch-only."""
    allowed = snapshot_sync_sites()
    bad = {}
    for site, n in syncs.items():
        name, _, line = site.split(" < ")[0].partition(":")
        if int(line) not in allowed.get(name, ()):
            bad[site] = n
    if bad:
        fail(f"{what}: the host synced outside the snapshot sites: {bad}")


def pool_tensors(eng) -> list:
    return [eng.pool.hbm, eng.pool.host_q, eng.pool.host_scale]


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def snapshot_pair(api, params, main: dict, name: str, tiers, shapes: dict,
                  eager: bool) -> dict:
    """One pool kind of the snapshot path: the uncrashed run (traced, for
    the cuts' spans), the crashed run, the graphed restore, and with
    ``eager`` the same restore on the eager megastep from a copy of the
    crashed run's directory. Returns the readings and times."""
    import gc
    import shutil
    from repro_torch.core.faults import CrashFault
    from repro_torch.device import sync_watch
    from repro_torch.kernels import duplex_stream as ds
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    base = SNAP_DIR / name
    shutil.rmtree(base, ignore_errors=True)

    def submit(eng):
        return [eng.submit(prompts[i], GEN, arrival_step=i * ARRIVAL_EVERY)
                for i in range(N_REQUESTS)]

    # 1. the uncrashed run
    eng = snap_engine(api, params, base / "run", tiers=tiers, trace=True)
    reqs = submit(eng)
    flushes = []
    flush = eng.pool.flush_dirty

    def counted_flush(*a, **kw):
        out = flush(*a, **kw)
        flushes.append(out["page_outs"])
        return out

    eng.pool.flush_dirty = counted_flush
    torch.cuda.synchronize()
    ds.reset_launches()
    with sync_watch() as syncs, stream_shapes(shapes):
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ds.LAUNCHES)
    check_sync_sites(syncs, f"snapshot {name}: the uncrashed run")
    if any(not np.array_equal(outs[r.rid], t)
           for r, t in zip(reqs, main["tokens"])):
        fail(f"snapshot {name}: the uncrashed run served other tokens than "
             f"the main path")
    taken = eng.stats()["snapshot"]["snapshots_taken"]
    if taken <= 0 or taken != len(flushes):
        fail(f"snapshot {name}: {taken} cuts, {len(flushes)} flushes")
    if launches["quant_stream"] < sum(1 for n in flushes if n) or (
            tiers is None and launches["quant_stream"]
            <= main["launches"]["quant_stream"]):
        fail(f"snapshot {name}: quant_stream launched "
             f"{launches['quant_stream']} times for {flushes} flushed "
             f"blocks (main path: {main['launches']['quant_stream']})")
    sig = snap_signature(eng)
    final = [t.clone() for t in pool_tensors(eng)]
    cuts = [(a["megastep"], dur) for n, _, dur, a in eng.tracer.spans
            if n == "snapshot_cut"]
    cut_bytes = {p.name: sum(f.stat().st_size for f in p.iterdir())
                 for p in sorted((base / "run").glob("step_*"))}
    crash_at = (eng._fx.step + 1) // 2
    tokens = sum(len(t) for t in sig["tokens"])
    del eng
    gc.collect()

    # 2. the same run killed at transaction crash_at
    eng = snap_engine(api, params, base / "crash", f"crash:@{crash_at}",
                      tiers)
    submit(eng)
    try:
        eng.run()
        fail(f"snapshot {name}: crash:@{crash_at} never fired")
    except CrashFault:
        pass
    crash_megastep = eng.megasteps
    torch.cuda.synchronize()
    del eng
    gc.collect()
    if eager:
        shutil.copytree(base / "crash", base / "crash_eager")

    def restored(d, graphs: bool) -> dict:
        eng = snap_engine(api, params, d, f"crash:@{crash_at}", tiers,
                          graphs=graphs)
        static = [*eng._dev.values(), *eng.cache.values(),
                  *pool_tensors(eng)]
        torch.cuda.synchronize()
        ds.reset_launches()
        with (sync_watch() if graphs else contextlib.nullcontext(Counter())
              ) as syncs, stream_shapes(shapes):
            t0 = time.perf_counter()
            info = eng.restore()
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            before = sum(len(r.generated) for r in
                         [*eng.completed.values(), *eng.active()])
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        mode = "graphed" if graphs else "eager"
        check_sync_sites(syncs, f"snapshot {name}: the {mode} restore")
        # the pool's tensors stay the same objects in either mode; the
        # eager megastep returns a new slot state where a replay writes
        # the static one
        now = [*eng._dev.values(), *eng.cache.values(), *pool_tensors(eng)]
        if any(a is not b for a, b in zip(static if graphs else static[-3:],
                                          now if graphs else now[-3:])):
            fail(f"snapshot {name}: the {mode} restore rebound a static "
                 f"tensor")
        eng.pool.check_invariants()
        got = snap_signature(eng)
        if got != sig:
            bad = [k for k in sig if got[k] != sig[k]]
            fail(f"snapshot {name}: the {mode} restored run differs from "
                 f"the uncrashed run in {bad}")
        want_cuts = sum(1 for m, _ in cuts if m >= info["restored_step"])
        if eng.stats()["snapshot"]["snapshots_taken"] != want_cuts:
            fail(f"snapshot {name}: the {mode} restored run took "
                 f"{eng.stats()['snapshot']['snapshots_taken']} cuts, the "
                 f"uncrashed run {want_cuts} from megastep "
                 f"{info['restored_step']} on")
        if not all(bitwise_equal(a, b)
                   for a, b in zip(pool_tensors(eng), final)):
            fail(f"snapshot {name}: the {mode} restored pool's bytes differ "
                 f"from the uncrashed run's")
        if not 0 < info["restored_step"] < crash_megastep:
            fail(f"snapshot {name}: restored cut {info['restored_step']} is "
                 f"not between the run's start and the crash (megastep "
                 f"{crash_megastep})")
        after = tokens - before
        return {"restore": info, "restore_s": restore_s, "run_s": run_s,
                "tokens_after_restore": after,
                "tokens_per_s": after / run_s,
                "launches": dict(ds.LAUNCHES), "syncs": dict(syncs),
                "snapshot_stats": eng.stats()["snapshot"]}

    out = {"cuts": [{"megastep": m, "ms": us / 1e3} for m, us in cuts],
           "cut_bytes": cut_bytes, "flushed_blocks": flushes,
           "launches": launches, "wall_s": wall,
           "tokens_per_s": tokens / wall, "syncs": dict(syncs),
           "crash_at": crash_at, "crash_megastep": crash_megastep,
           "graphed": restored(base / "crash", True)}
    if eager:
        out["eager"] = restored(base / "crash_eager", False)
    g = out["graphed"]
    print(f"snapshot {name}: {taken} cuts of {list(cut_bytes.values())} "
          f"bytes in {[round(c['ms'], 3) for c in out['cuts']]} ms; "
          f"crash:@{crash_at} restored from megastep "
          f"{g['restore']['restored_step']} in {g['restore_s']:.3f} s, "
          f"then {g['tokens_per_s']:.1f} tok/s; signature, cuts and pool "
          f"bytes equal the uncrashed run's", flush=True)
    return out


def serve_snapshot(api, params, main: dict, shapes: dict) -> dict:
    """The snapshot path, flat and tiered (``snapshot_pair``), printed as
    one JSON line with the card's name and power limit."""
    out = {"flat": snapshot_pair(api, params, main, "flat", None, shapes,
                                 eager=True),
           "tiered": snapshot_pair(api, params, main, "tiered", TIER_SPEC,
                                   shapes, eager=False),
           "card": gpu_line()}
    print(json.dumps({"serve_snapshot": out}), flush=True)
    return out


def dense_width_phase(arch: str, B: int, S: int) -> dict:
    """``arch``'s FULL config on the card (weights drawn there from a
    seed), its forward held by ``forward_check``; the model is freed
    before returning."""
    from repro_torch.models import registry

    api = registry.build(arch, smoke=False, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {**forward_check(api, params, B, S),
           "param_bytes": param_bytes(params), "init_s": init_s}
    del params
    torch.cuda.empty_cache()
    print(json.dumps({"dense_width": out}), flush=True)
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
                      r"(flash_kernel_\w+?|wkv6_backward_kernel|wkv6_kernel|"
                      r"duplex_kernel|"
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
    if sys.argv[1:2] == ["--dryruns"]:
        return dryruns(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    cpu = start_cpu_sims()
    dry = start_dryruns()
    try:
        return card_main(cpu, dry)
    finally:
        for proc, _ in (cpu, dry):
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def card_main(cpu: tuple, dry: tuple) -> int:

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
    check_kernels([(2, 16, D), (8, 16, D), (32, 16, D), (3, 5, 1001)]
                  + [(n, 16, d) for d in MOE_KV_DIMS.values()
                     for n in (1, 4, 8)])
    check_l2([(4, 3, 16, 64), (1, 1, 8, 128), (8, 5, 32, 32),
              (4, 2, 16, D), (4, 32, 16, D), (3, 4, 16, 1001),
              (12, 2, 16, D)]
             + [(4, 2, 16, d) for d in MOE_KV_DIMS.values()])
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
    # the stream kernels at the MoE serving paths' row widths, at the main
    # path's (N, T): in the CPU rehearsal at full-width byte counts the MoE
    # paths hand each kernel these most often too (main() fails otherwise)
    moe_rows = {arch: {name: measure(name, (*PATH_SHAPES[name][:2], d))
                       for name in STREAMS}
                for arch, d in MOE_KV_DIMS.items()}
    # quant_stream at the snapshot cuts' flush shape, also measured before
    # any graph is captured
    flush_row = measure("quant_stream", FLUSH_SHAPE)
    mark("stream_and_l2_kernels")
    check_flash()
    # device_events takes a profile as measured only when two agree: the
    # profiler has been seen to drop this kernel's events (PERF.md)
    flash_row = measure_flash((4, 2048, 9, 3, 64), {})
    print(json.dumps({"flash_attention_paligemma": measure_flash(
        (2, 512, 8, 1, 256), {"prefix_len": 256})}), flush=True)
    # hd 80, 112 and 128 timed beside SDPA at a prefill shape of a config
    # that has them (stablelm-3b and llama3.2-3b run on the dense-width
    # path, kimi-k2 and mixtral-8x7b with its window on the MoE path)
    widths = [{"config": arch, **measure_flash(shape, mask)}
              for arch, shape, mask in FLASH_WIDTHS]
    print(json.dumps({"flash_attention_widths": widths}), flush=True)
    mark("flash_kernel")
    check_wkv6()
    wkv_row = measure_wkv6(WKV_CHECKS[-1][:4])
    mark("wkv6_kernel")
    backward_geometry_on_card()
    wkv_bwd_row = measure_wkv6_backward(WKV_BWD_CHECKS[-1][:4],
                                        check_wkv6_backward(), wkv_row["ms"])
    mark("wkv6_backward_kernel")

    api, params = full_model()
    shapes_seen: dict = {}
    launches, main_run = serve_full(api, params, shapes_seen)
    mark("serve")
    walls = megastep_turns(main_run)
    mark("megastep_turns")
    sharded = serve_sharded(api, params, main_run)
    mark("serve_sharded")
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
    dense = {}
    for arch, B, S in DENSE_RUNS:
        dense[arch] = dense_width_phase(arch, B, S)
        mark(f"dense_{arch}")

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
            # the graphed sharded runs, by mesh
            row["launches_sharded"] = {
                mesh: sharded[mesh]["launches"][row["name"]]
                for mesh in ("1x1", "2x1", "2x2")}
    # measured at the smollm-135m prefill shape; launched per forward
    flash_row["launches"] = forward["smollm-135m"]["launches"]
    flash_row["launches_paligemma"] = forward["paligemma-3b"]["launches"]
    flash_row["launches_dense"] = {arch: d["launches"]
                                   for arch, d in dense.items()}
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
    # the MoE paths after the whole-call profiles (they take theirs as
    # they come) and before zamba2-7b is drawn: no other large model is
    # resident while one is on the card
    check_bmm_f32()
    moe_shapes: dict = {}
    moe = moe_phases(moe_shapes, mark)
    check_kernels(sorted({s for cnt in moe_shapes.values() for s in cnt}))
    for arch, d in MOE_KV_DIMS.items():
        for name in STREAMS:
            want = (*PATH_SHAPES[name][:2], d)
            got = max((s for s in moe_shapes[name] if s[2] == d),
                      key=lambda s: (moe_shapes[name][s], s[0]))
            if got != want:
                fail(f"{arch}: the serving path handed {name} {got} most "
                     f"often (the larger N on a tie); its row was "
                     f"measured at {want}")
    for row in kernels:
        if row["name"] in STREAMS:
            # at the MoE paths' widths, with the graphed MoE runs' counts
            row["moe"] = {arch: {
                **{k: moe_rows[arch][row["name"]][k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "launch_floor_ms")},
                "launches": moe[arch]["serve"]["launches"][row["name"]]}
                for arch in MOE_KV_DIMS}
        if row["name"] == "flash_attention":
            row["launches_moe"] = {arch: m["forward"]["launches"]
                                   for arch, m in moe.items()}
    mark("moe_kernel_checks")
    # the nested-cache families after the profiles that need whole calls
    # (device_profile), and zamba2-7b's forward, whose trace of ~0.46 M
    # events is the largest, last of all profiles: after it the main
    # path's decode-step profile lost 5 of 14,460 events in four of five
    # windows (PERF.md, PR 21). These phases take their profiles as they
    # come. All before the snapshot phase, which the profiler has lost
    # events after.
    zapi, zparams, zinit = model_on_card(
        "zamba2-7b", (81, 3584, 32, 32, 14336, 32000, 64, 6),
        ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
         "vocab", "ssm_state", "attn_every"))
    print(json.dumps({"zamba2_model": {
        "param_bytes": param_bytes(zparams), "init_s": zinit,
        "card": gpu_line()}}), flush=True)
    zamba2_serve_phase(zapi, zparams)
    mark("zamba2_serve")
    whisper_phase(*WHISPER_FORWARD)
    mark("whisper")
    zamba2_forward_phase(zapi, zparams, *ZAMBA_FORWARD)
    mark("zamba2_forward")
    del zapi, zparams
    torch.cuda.empty_cache()
    # the training path, before the snapshot phase; its step profiles are
    # taken as they come (profile_once)
    train = {"smollm": smollm_train_phase()}
    mark("train_smollm")
    train["host_vs_device"] = smollm_host_vs_device_phase()
    mark("train_host_vs_device")
    train["rwkv"] = rwkv_train_phase()
    mark("train_rwkv")
    train["rwkv_gradient"] = rwkv_grad_phase()
    mark("train_rwkv_gradient")
    # measured at the rwkv6-7b training shape; launched once per layer of
    # each training step (both kernels; the forward's row keeps its
    # forward-path count)
    wkv_row["launches_training"] = train["rwkv"]["launches"]["wkv6"]
    wkv_bwd_row["launches"] = train["rwkv"]["launches"]["wkv6_backward"]
    wkv_bwd_row["launches_per_step"] = \
        train["rwkv"]["launches_per_step"]["wkv6_backward"]
    wkv_bwd_row["launches_gradient_check"] = \
        train["rwkv_gradient"]["launches"]["wkv6_backward"]
    # the backward's share of a training step: its launches a step at its
    # path-shape time, over the median step's wall time after the first
    step_ms = float(np.median(train["rwkv"]["step_wall_ms"][1:]))
    wkv_bwd_row["rwkv_train_step_ms"] = step_ms
    wkv_bwd_row["share_of_rwkv_train_step"] = \
        wkv_bwd_row["launches_per_step"] * wkv_bwd_row["ms"] / step_ms
    # training at full width for the other families (0 kernel launches:
    # their loss runs the plain attention, as the reference's), then the
    # examples and the deprecated serving shims
    train["mixtral"] = mixtral_train_phase()
    mark("train_mixtral")
    train["zamba2"] = zamba2_train_phase()
    mark("train_zamba2")
    train["zamba2_gradient"] = zamba2_grad_phase()
    mark("train_zamba2_gradient")
    train["paligemma"] = paligemma_train_phase()
    mark("train_paligemma")
    train["whisper"] = whisper_train_phase()
    mark("train_whisper")
    examples_phase()
    mark("examples")
    offload_demo_phase()
    mark("offload_demo")
    # the dry-run against the card, remat on the card, and the production
    # dry-run cells (traced on the host beside the card's work)
    predicted = wait_dryruns(dry)
    mark("dryrun_wait")
    vs_card = dryrun_vs_card(predicted["card"])
    mark("dryrun_vs_card")
    remat = remat_on_card()
    mark("remat_on_card")
    dryrun_cells(predicted["cells"])
    mark("dryrun_cells")
    rwkv_cell = vs_card[2]["launches"]
    wkv_row["launches_remat"] = {
        "gradient_remat": remat["rwkv6"]["launches"]["remat"]["wkv6"],
        "gradient_no_remat": remat["rwkv6"]["launches"]["no_remat"]["wkv6"],
        "dryrun_vs_card_train_step": rwkv_cell["wkv6"]}
    wkv_bwd_row["launches_remat"] = {
        "gradient_remat":
            remat["rwkv6"]["launches"]["remat"]["wkv6_backward"],
        "gradient_no_remat":
            remat["rwkv6"]["launches"]["no_remat"]["wkv6_backward"],
        "dryrun_vs_card_train_step": rwkv_cell["wkv6_backward"]}
    kernels.append(wkv_bwd_row)
    # after every profile: with it earlier in the process, the profiler
    # lost device events of rwkv6-7b's decode-step profiles (PERF.md)
    snap_shapes: dict = {}
    snap = serve_snapshot(api, params, main_run, snap_shapes)
    # every stream shape the snapshot runs handed a kernel (the cuts'
    # flushes among them), held against the plain version
    check_kernels(sorted({s for cnt in snap_shapes.values() for s in cnt}))
    flushed = [snap[kind]["flushed_blocks"] for kind in ("flat", "tiered")]
    if max(max(f) for f in flushed) != FLUSH_SHAPE[0]:
        fail(f"the snapshot cuts flushed {flushed} blocks; the flush row "
             f"was measured at {FLUSH_SHAPE}")
    for row in kernels:
        if row["name"] in STREAMS:
            # the uncrashed flat snapshot run: its cuts' flushes on top
            row["launches_snapshot"] = \
                snap["flat"]["launches"][row["name"]]
        if row["name"] == "quant_stream":
            row.update({f"flush_{k}": flush_row[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "launch_floor_ms")})
            row["flushes"] = {kind: snap[kind]["flushed_blocks"]
                              for kind in ("flat", "tiered")}
    mark("snapshot")
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
