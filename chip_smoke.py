"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version on the card, serves
smollm-135m at full width (30 layers, d_model 576, vocab 49152; random
seeded weights) through the duplex-paged KV pool on the card, checks
every request token for token against the port's static-batch
``reference_decode``, and shows through the kernels' launch counters that
the serving path ran every kernel. The last line of its output is a JSON
object ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the line before that the per-kernel
measurements as JSON. Any failed check raises and exits non-zero. Without
a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published rates (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# the serving run: smollm-135m FULL, an oversubscribed pool so blocks page
# both ways (about 18 MB of HBM blocks, 24 MB of int8 host tier).
SERVE = dict(max_batch=8, cache_len=256, block_tokens=16, hbm_blocks=48,
             megastep=8, pipeline_depth=2, prefill_chunk=4)
N_REQUESTS, PROMPT_LEN, GEN, ARRIVAL_EVERY = 16, 64, 64, 2

# what each kernel replaces in the JAX package (the pallas_call line)
REPLACES = {
    "duplex_kv_stream": "src/repro/kernels/duplex_stream.py:157",
    "quant_stream": "src/repro/kernels/duplex_stream.py:111",
    "dequant_stream": "src/repro/kernels/duplex_stream.py:93",
}


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` by CUDA events over back-to-back calls."""
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


def device_events(fn, iters: int = 20, warmup: int = 1) -> list:
    """The work the profiler saw run on the card over ``iters`` calls of
    ``fn``, as (name, count, device µs) per kind of device operation
    (kernel, copy or memset; host-side runtime calls are left out).
    Reads the raw trace events: ``key_averages()`` takes minutes over the
    million operations of a serving run. Raises if the profiler recorded
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    count, ns = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            count[e.name()] += 1
            ns[e.name()] += e.duration_ns()
    if not count:
        fail("the profiler recorded no device time on the card")
    return [(k, count[k], ns[k] / 1e3) for k in count]


def device_profile(fn, iters: int = 20, warmup: int = 1
                   ) -> tuple[float, float]:
    """Per call of ``fn``: device ms and the count of device operations."""
    rows = device_events(fn, iters, warmup)
    return (sum(us for _, _, us in rows) / 1e3 / iters,
            sum(n for _, n, _ in rows) / iters)


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
    """Every kernel (and fused=False) against its plain version."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import ops, ref
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
    computes this quantizer, so there is no library time."""
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
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/duplex_stream.cu",
            "replaces": REPLACES[name], "shape": [n, t, d],
            "max_abs_err": err,
            "ms": device_profile(fn)[0], "plain_ms": device_profile(plain)[0],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def serve_full(shapes_seen: dict) -> tuple[dict, Callable[[], None]]:
    """The main path: smollm-135m FULL served through the paged pool on
    the card. Returns the launch counts of this run alone, and a function
    that profiles a repeat of the run (``profile_serving``)."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, ServeEngine, reference_decode

    api = registry.build("smollm-135m", smoke=False, device="cuda")
    cfg = api.cfg
    if (cfg.num_layers, cfg.d_model, cfg.vocab) != (30, 576, 49152):
        fail(f"not the full-width config: {cfg}")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT_LEN)).astype(np.int32)
    engine_cfg = EngineConfig(**SERVE, max_queue=N_REQUESTS + 8,
                              device="cuda")

    def main_run_engine(model=api) -> tuple:
        """A fresh engine holding the main path's requests."""
        eng = ServeEngine(model, params, engine_cfg)
        rids = [eng.submit(prompts[i], GEN,
                           arrival_step=i * ARRIVAL_EVERY).rid
                for i in range(N_REQUESTS)]
        return eng, rids

    # warm the libraries and the allocator on a full batch of short requests
    warm = ServeEngine(api, params, engine_cfg)
    for i in range(SERVE["max_batch"]):
        warm.submit(prompts[i, :8], 8)
    warm.run()

    # record the stream shapes the serving path hands each kernel
    wrapped = {}
    for name in ("duplex_kv_stream", "quant_stream", "dequant_stream"):
        real = getattr(ds, name)

        def rec(*a, _real=real, _name=name):
            shapes_seen.setdefault(_name, Counter())[tuple(a[0].shape)] += 1
            return _real(*a)

        wrapped[name] = real
        setattr(ds, name, rec)

    engine, rids = main_run_engine()
    torch.cuda.synchronize()
    ds.reset_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ds.LAUNCHES)
    for name, real in wrapped.items():
        setattr(ds, name, real)

    # correctness: token for token against the static-batch oracle, run
    # in batches of max_batch rows so both see the same matmul shapes
    B = SERVE["max_batch"]
    for lo in range(0, N_REQUESTS, B):
        ref = reference_decode(api, params, prompts[lo:lo + B], GEN,
                               cache_len=SERVE["cache_len"]).cpu().numpy()
        for j in range(ref.shape[0]):
            got = outs[rids[lo + j]]
            if not np.array_equal(got, ref[j]):
                bad = int(np.flatnonzero(got != ref[j])[0])
                fail(f"request {lo + j}: token {bad} is {got[bad]}, the "
                     f"reference decode has {ref[j][bad]}")
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
    return launches, functools.partial(
        profile_serving, api, params, main_run_engine,
        [outs[r] for r in rids], wall)


def profile_serving(api, params, main_run_engine, main_tokens,
                    wall_s) -> None:
    """How busy the card is on the main path: the profiler's device time
    over a repeat of the main run (same requests, same paging), against
    the host wall clock of the unprofiled main run. Also splits the
    device operations between the decoder and the rest (paging, engine
    bookkeeping) by profiling one ``decode_step`` at the engine's batch."""
    decode_calls = [0]

    def counted_decode(*a):
        decode_calls[0] += 1
        return api.decode_step(*a)

    repeat_tokens = []

    def repeat():
        eng, rids = main_run_engine(api._replace(decode_step=counted_decode))
        got = eng.run()
        repeat_tokens.extend(got[r] for r in rids)

    t0 = time.perf_counter()
    rows = device_events(repeat, iters=1, warmup=0)
    profiled_s = time.perf_counter() - t0
    if len(repeat_tokens) != len(main_tokens) or any(
            not np.array_equal(a, b)
            for a, b in zip(repeat_tokens, main_tokens)):
        fail("the profiled repeat of the main run served other tokens")
    n_decode = decode_calls[0]
    busy_ms = sum(us for _, _, us in rows) / 1e3
    ops = sum(n for _, n, _ in rows)
    stream_ms = sum(us for k, _, us in rows
                    if "duplex_kernel" in k or "quant_kernel" in k) / 1e3

    B = SERVE["max_batch"]
    cache = api.init_cache(B, SERVE["cache_len"])
    toks = torch.zeros((B,), dtype=torch.int32, device="cuda")
    pos = torch.full((B,), PROMPT_LEN, dtype=torch.int32, device="cuda")
    dec_ms, dec_ops = device_profile(
        lambda: api.decode_step(params, cache, toks, pos))
    wall_ms = wall_s * 1e3
    print(json.dumps({"serving_profile": {
        "requests": N_REQUESTS, "prompt": PROMPT_LEN, "gen": GEN,
        "wall_ms": wall_ms, "profiled_wall_ms": profiled_s * 1e3,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "decode_steps": n_decode, "device_ops": ops,
        "device_ops_per_decode_step": ops / n_decode,
        "wall_ms_per_decode_step": wall_ms / n_decode,
        "decoder_ops_per_step": dec_ops, "decoder_ms_per_step": dec_ms,
        "decoder_share_of_ops": n_decode * dec_ops / ops,
        "decoder_share_of_device_ms": n_decode * dec_ms / busy_ms,
        "stream_kernels_ms": stream_ms}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import duplex_stream as ds

    card = gpu_line()
    t0 = time.perf_counter()
    log = ds.build()
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.2f} s; "
          f"card: {card}", flush=True)
    print(log.strip(), flush=True)

    D = 30 * 2 * 3 * 64          # kv_dims of smollm-135m FULL
    check_kernels([(2, 16, D), (8, 16, D), (32, 16, D), (3, 5, 1001)])
    sweep = [{k: row[k] for k in ("name", "shape", "ms", "plain_ms",
                                  "call_ms", "bound_ms")}
             for n in (2, 8, 32)
             for row in (measure(name, (n, 16, D)) for name in REPLACES)]
    print(json.dumps({"kernel_sweep": sweep}), flush=True)

    shapes_seen: dict = {}
    launches, profile_serving_run = serve_full(shapes_seen)

    kernels = []
    for name in ("duplex_kv_stream", "quant_stream", "dequant_stream"):
        shape = shapes_seen[name].most_common(1)[0][0]
        row = measure(name, shape)
        row["launches"] = launches[name]
        kernels.append(row)
    # last: after a trace of a million operations, the profiler has been
    # seen to record nothing of a later short profile of a kernel
    profile_serving_run()
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
