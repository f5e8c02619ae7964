"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout (one
``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version on the card, and drives two serving paths at full
width (smollm-135m: 30 layers, d_model 576, vocab 49152; random seeded
weights), each with the launch counters set to 0 just before it and read
just after:

  * the main path: LLM decode through the duplex-paged KV pool, every
    request token for token against the port's static-batch
    ``reference_decode``; it must launch the three duplex-stream kernels;
  * the tenant path: the same decode co-served with a KV-store tenant and
    a vector-search tenant that share the pool, the paging transaction and
    the admission queue; LLM tokens exact, tenant data checked against
    its seeds and a brute-force scan, the withdrawn scope
    (``/serve/redis/read_heavy``) never fused, and all four kernels
    (``l2_distance`` too) launched.

The last line of its output is a JSON
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

# the tenant path: a smaller LLM batch co-served with both tenants in an
# oversubscribed pool (40 HBM blocks of (16, 11520) bf16, about 15 MB; the
# tenants reserve 10), so LLM KV, the store and the dataset page both ways
TENANT_SERVE = dict(max_batch=4, cache_len=256, block_tokens=16,
                    hbm_blocks=40, megastep=8, pipeline_depth=2,
                    prefill_chunk=4)
TENANT_LLM_REQUESTS, TENANT_GEN, TENANT_STEPS = 8, 32, 48

# what each kernel replaces in the JAX package (the pallas_call line)
REPLACES = {
    "duplex_kv_stream": "src/repro/kernels/duplex_stream.py:157",
    "quant_stream": "src/repro/kernels/duplex_stream.py:111",
    "dequant_stream": "src/repro/kernels/duplex_stream.py:93",
    "l2_distance": "src/repro/kernels/vector_distance.py:50",
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
    blocks, so there is no library time."""
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
    return {"name": "l2_distance", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/vector_distance.cu",
            "replaces": REPLACES["l2_distance"], "shape": [q, n, t, d],
            "max_abs_err": err,
            "ms": device_profile(fn)[0], "plain_ms": device_profile(plain)[0],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def serve_full(api, params,
               shapes_seen: dict) -> tuple[dict, Callable[[], None]]:
    """The main path: smollm-135m FULL served through the paged pool on
    the card. Returns the launch counts of this run alone, and a function
    that profiles a repeat of the run (``profile_serving``)."""
    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = api.cfg
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
    return launches, functools.partial(
        profile_serving, api, params, main_run_engine,
        [outs[r] for r in rids], wall)


def serve_tenants(api, params, l2_shapes: Counter) -> dict:
    """The tenant path: smollm-135m FULL decode co-served with a KV-store
    tenant (two sequential streams, one read-heavy stream over a preloaded
    32-block store) and a vector-search tenant (one 4-query walk over a
    16-block dataset) in one oversubscribed pool. Run once under
    ``torch.cuda.set_sync_debug_mode("warn")``; returns the launch counts
    of this run alone."""
    import traceback
    import warnings

    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import vector_distance as vd
    from repro_torch.serve import (EngineConfig, KVStoreTenant, ServeEngine,
                                   VectorSearchTenant)
    from repro_torch.serve.workloads import _synth_blocks, kv_value_seed

    prompts = np.random.default_rng(2).integers(
        0, api.cfg.vocab, (TENANT_LLM_REQUESTS, PROMPT_LEN)).astype(np.int32)
    eng = ServeEngine(api, params, EngineConfig(
        **TENANT_SERVE, max_queue=TENANT_LLM_REQUESTS + 8, device="cuda"))
    kv = eng.add_tenant(KVStoreTenant(n_slots=3, ops_per_step=2,
                                      store_blocks=32))
    kv.preload(32)
    vec = eng.add_tenant(VectorSearchTenant(
        n_slots=1, n_queries=4, visits_per_step=2, data_blocks=16,
        load_per_step=1, result_every=4))
    rids = [eng.submit(prompts[i], TENANT_GEN,
                       arrival_step=i * ARRIVAL_EVERY).rid
            for i in range(TENANT_LLM_REQUESTS)]
    treqs = [kv.submit("sequential", n_steps=TENANT_STEPS, phase="read"),
             kv.submit("sequential", n_steps=TENANT_STEPS, phase="write"),
             kv.submit("read_heavy", n_steps=TENANT_STEPS),
             vec.submit(n_steps=TENANT_STEPS)]

    real = vd.l2_distance

    def rec(queries, blocks):
        l2_shapes[(queries.shape[0],) + tuple(blocks.shape)] += 1
        return real(queries, blocks)

    vd.l2_distance = rec
    torch.cuda.synchronize()
    ds.reset_launches()
    vd.reset_launches()
    # each sync warning is charged to the innermost frame of the port's
    # own code on the stack when it was raised
    sync_sites: Counter = Counter()

    def on_warning(message, category, filename, lineno, *rest):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if "repro_torch" in f.filename]
        frames = own[-1:] if own else stack[-3:]
        sync_sites[" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                              for f in reversed(frames))] += 1

    # the watch alone, with nothing between switching it on and off
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    watch_alone = sum(sync_sites.values())
    sync_sites.clear()

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        # only the engine's run is watched: the synchronize that ends the
        # timing below is this script's own
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            outs = eng.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
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
    # resident store blocks hold the synthesized values of their latest
    # SET version (int8 round-trip tolerance for blocks that travelled
    # through the host tier), as tests/test_workloads.py:49-61
    pool = eng.pool
    T, D = pool.block_shape
    checked = 0
    for b in kv._store:
        slot = pool.slot_of[b]
        if slot < 0 or b not in kv._version:
            continue
        want = _synth_blocks(torch.tensor(
            [kv_value_seed(b, kv._version[b])], dtype=torch.int32,
            device="cuda"), tokens=T, dims=D)[0].float()
        err = (pool.hbm[slot].float() - want).abs().max().item()
        if err > 1.0 / 127.0 + 0.05:
            fail(f"store block {b} differs from its value by {err}")
        checked += 1
    if checked == 0:
        fail("no store block was resident to check")
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
          f"(the watch alone: {watch_alone}) "
          f"steps={ps['steps']} megasteps={ps['megasteps']} "
          f"host_blocked={ps['host_blocked']}", flush=True)
    return launches


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


def build_all() -> None:
    """Build both kernel libraries, one nvcc each, started together, and
    print their logs."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import duplex_stream as ds
    from repro_torch.kernels import vector_distance as vd
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        logs = list(pool.map(lambda m: m.build(), (ds, vd)))
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for mod, log in zip((ds, vd), logs):
        print(f"{mod.SOURCE.name}:\n{log.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    print(f"card: {gpu_line()}", flush=True)
    build_all()
    D = 30 * 2 * 3 * 64          # kv_dims of smollm-135m FULL
    check_kernels([(2, 16, D), (8, 16, D), (32, 16, D), (3, 5, 1001)])
    check_l2([(4, 3, 16, 64), (1, 1, 8, 128), (8, 5, 32, 32),
              (4, 2, 16, D), (4, 32, 16, D), (3, 4, 16, 1001),
              (12, 2, 16, D)])
    sweep = [{k: row[k] for k in ("name", "shape", "ms", "plain_ms",
                                  "call_ms", "bound_ms")}
             for n in (2, 8, 32)
             for row in (measure(name, (n, 16, D))
                         for name in REPLACES if name != "l2_distance")]
    sweep += [{k: row[k] for k in ("name", "shape", "ms", "plain_ms",
                                   "call_ms", "bound_ms")}
              for row in (measure_l2((4, n, 16, D)) for n in (2, 8, 32))]
    print(json.dumps({"kernel_sweep": sweep}), flush=True)

    api, params = full_model()
    shapes_seen: dict = {}
    launches, profile_serving_run = serve_full(api, params, shapes_seen)
    l2_shapes: Counter = Counter()
    tenant_launches = serve_tenants(api, params, l2_shapes)

    kernels = []
    for name in ("duplex_kv_stream", "quant_stream", "dequant_stream"):
        shape = shapes_seen[name].most_common(1)[0][0]
        row = measure(name, shape)
        row["launches"] = launches[name]
        kernels.append(row)
    row = measure_l2(l2_shapes.most_common(1)[0][0])
    row["launches"] = tenant_launches["l2_distance"]
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
