"""One run of one cell of the benchmark of ``repro_torch``, the PyTorch and
CUDA port, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up draws the cell's weights from the seed on the card, builds the
program's ``ServeEngine`` with its step graphs, and serves one batch of
short requests through it, so that every kernel is built and loaded and
every graph captured before the window. Then a closed loop of the cell's
clients drives ``submit`` and ``megastep``: for ``RAMP_S`` (set-up too),
then for the window of ``--seconds`` on the host clock.
``--trace 1`` also traces the engine's host spans and profiles
``PROFILE_STEPS`` more engine steps after the window. Then the engine is freed and the
plain reference judges the served tokens (and, where the cell names
them, the paged blocks).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also close standard error. Without a card, or with fewer cards
than the cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
#: top-level module names that must not be loaded: JAX and the JAX
#: package with its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: the engine's span of pure host work (admission and the rows'
#: trajectories; no device sync)
PLAN_SPAN = "plan"
#: the engine's spans whose idle device time is host work it waits on
ENGINE_SPANS = ("plan", "dispatch")
#: engine steps profiled after the window: whole megasteps, at least
PROFILE_STEPS = 16
#: seconds the closed loop runs before the window opens, so that the
#: window sees the loop's steady state and not its start, where every
#: client's first request arrives at once
RAMP_S = 10.0
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def setup_paths() -> None:
    """The checkout's root and its ``src`` on the path (and not this
    folder), the caches of anything the program builds inside the
    checkout at fixed paths."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _counts(engine) -> dict:
    st = engine.pool.stats if engine.paged else {}
    tr = engine.tracer
    return {"steps": engine.step_count, "micro": engine.decode_steps,
            "page_ins": st.get("page_ins", 0),
            "page_outs": st.get("page_outs", 0),
            "spans": len(tr.spans) if tr is not None else 0}


def warm_up(engine, eng: dict, vocab: int, seed: int) -> None:
    """Load the stream kernels (building them in a new checkout) and serve
    one batch of short requests, so that admission, every prefill
    remainder, decoding, completion and slot recycling have run once."""
    import numpy as np
    import torch

    if engine.paged and engine.device.type == "cuda":
        from repro_torch.kernels import ops as kernel_ops
        bt, kvd = engine.pool.block_shape
        x = torch.zeros((2, bt, kvd), dtype=torch.bfloat16,
                        device=engine.device)
        q, s = kernel_ops.quant_kv_stream(x)
        kernel_ops.dequant_kv_stream(q, s)
        kernel_ops.duplex_kv_stream(q, s, x, stage_blocks=2)
    rng = np.random.default_rng([int(seed) % (1 << 64), 5])
    chunk = max(1, int(eng["prefill_chunk"]))
    for i in range(int(eng["max_batch"]) + 1):
        plen = 1 + i % (2 * chunk)
        engine.submit(rng.integers(0, vocab, size=plen).astype(np.int32),
                      2 + i % 2)
    while engine.pending():
        engine.megastep()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def log_halves(recs, history, t_end: float) -> None:
    """Tokens/s and p95 time to first token of each half of the window,
    on standard error: whether the window holds the loop's steady
    state."""
    from portbench import timeline

    half = t_end / 2
    before = max((n for t, n in history if t <= half), default=0)
    after = history[-1][1] - before if history else 0
    parts = []
    for name, lo, hi, n in (("first", 0.0, half, before),
                            ("second", half, t_end, after)):
        v = timeline.p95(timeline.ttft_values(
            [r for r in recs if lo <= r.submit < hi], t_end))
        parts.append(f"{name} half {n / max(hi - lo, 1e-9):.1f} tokens/s, "
                     f"ttft p95 {v * 1e3 if v is not None else None} ms")
    log("window halves: " + "; ".join(parts))


def profile_tail(driver, n: int, block_tokens: int, kv_dims: int):
    """``n`` more megasteps of the closed loop under the profiler, after
    the window. Returns what the per-layer readers and the breakdown
    need."""
    import statistics

    from portbench import devtrace

    engine = driver.engine
    tracer = engine.tracer
    epoch_ns = time.perf_counter_ns() - tracer.now_us() * 1e3
    c0 = _counts(engine)
    driver.ranges, driver.marks = True, []
    with devtrace.DeviceTrace() as dt:
        for _ in range(n):
            driver.boundary()
    driver.ranges = False
    c1 = _counts(engine)
    mega = sorted(r for r in dt.ranges if r[0].endswith("megastep"))
    lo = mega[0][1]
    hi = max(r[2] for r in dt.ranges)
    offset = statistics.median(r[1] - m for r, m in zip(mega, driver.marks))
    dev = [(name, max(s, lo), min(e, hi)) for name, s, e in dt.device
           if e > lo and s < hi]
    busy_ns = devtrace.union_ns([(s, e) for _, s, e in dev])
    stream_ns = sum(e - s for name, s, e in dev
                    if devtrace.STREAM_KERNEL.search(name))
    total_ns = sum(e - s for _, s, e in dev)
    by_name: dict[str, float] = {}
    for name, s, e in dev:
        by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) \
            + (e - s) / 1e9
    # idle stretches, named by what the host was doing at their middle:
    # an engine span (plan / dispatch / reconcile) where one covers it,
    # else the harness's own range (submit / megastep / scan)
    host = [(name, epoch_ns + t0 * 1e3 + offset,
             epoch_ns + (t0 + dur) * 1e3 + offset)
            for name, t0, dur, _ in tracer.spans[c0["spans"]:c1["spans"]]]
    harness = [(name[len(devtrace.RANGE_PREFIX):], s, e)
               for name, s, e in dt.ranges]
    idle: dict[str, float] = {}
    for s, e in devtrace.gaps([(s, e) for _, s, e in dev], lo, hi):
        mid = (s + e) / 2
        name = next((n_ for n_, a, b in host if a <= mid < b), None) \
            or next((f"harness {n_}" for n_, a, b in
                     sorted(harness, key=lambda r: r[2] - r[1])
                     if a <= mid < b), "other")
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return types.SimpleNamespace(
        steps=c1["steps"] - c0["steps"], micro=c1["micro"] - c0["micro"],
        busy_s=busy_ns / 1e9, window_s=(hi - lo) / 1e9,
        engine_idle_s=sum(idle.get(n_, 0.0) for n_ in ENGINE_SPANS),
        stream_s=stream_ns / 1e9, other_s=(total_ns - stream_ns) / 1e9,
        stream_bytes=devtrace.stream_bytes(
            c1["page_ins"] - c0["page_ins"],
            c1["page_outs"] - c0["page_outs"], block_tokens, kv_dims),
        breakdown={"device_ops": [[k, v] for k, v in top],
                   "idle_gaps": [[k, v] for k, v in gaps]})


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False) -> dict:
    """One run of ``cell`` (a ``spec.Cell``) on ``device``. Returns the
    result's fields, the checks last; with ``control`` also the control's
    readings under ``"control"``."""
    import torch

    from portbench import judge, spec
    from portbench.loop import Driver
    from portbench.traffic import ClosedLoop
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    cfg, wl = cell.config, cell.workload
    eng = dict(wl["engine"])
    fam = spec.family(cfg["family"])
    ref = spec.reference(cfg["family"])
    cuda = torch.device(device).type == "cuda"

    marks = {"start": t_start, "imported": time.perf_counter()}
    if cuda:
        torch.zeros(1, device=device)
        marks["cuda_init"] = time.perf_counter()
    weights = fam.make_weights(cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks["weights"] = time.perf_counter()
    api = fam.program_api(cfg, device, eng["cache_len"],
                          smoke=bool(cfg.get("smoke")))
    params = fam.program_params(weights, cfg)
    plan = ClosedLoop(cell.traffic, fam.vocab(cfg), seed)
    if plan.max_total > eng["cache_len"]:
        raise ValueError(f"{cell.name}: requests reach {plan.max_total} "
                         f"positions, cache_len is {eng['cache_len']}")
    marks["api"] = time.perf_counter()
    engine = ServeEngine(api, params, EngineConfig(
        **eng, max_queue=plan.clients + eng["max_batch"],
        trace=True if trace else None, device=device))
    marks["engine"] = time.perf_counter()
    warm_up(engine, eng, fam.vocab(cfg), seed)
    marks["warm_up"] = time.perf_counter()
    driver = Driver(engine, plan,
                    lambda a, b: fam.range_flops(cfg, a, b))
    driver.start()
    while driver.now() < RAMP_S:
        driver.boundary()
    marks["ramp"] = time.perf_counter()
    # what set-up and the ramp left is never collected again: a full
    # collection then walks only what the window makes
    gc.collect()
    gc.freeze()
    driver.open_window()
    c0 = _counts(engine)
    setup_s = time.perf_counter() - t_start
    t_end = 0.0
    while t_end < seconds:
        t_end = driver.boundary()
    c1 = _counts(engine)
    log("set-up s: " + ", ".join(
        f"{b} {marks[b] - marks[a]:.3f}" for a, b in
        zip(list(marks)[:-1], list(marks)[1:])))
    log_halves(driver.recs, driver.history, t_end)
    plan_us = (sum(d for name, _, d, _ in
                   engine.tracer.spans[c0["spans"]:c1["spans"]]
                   if name == PLAN_SPAN)
               if engine.tracer is not None else None)
    window = types.SimpleNamespace(
        seconds=t_end, tokens=driver.tokens, flops=driver.flops,
        steps=c1["steps"] - c0["steps"],
        page_ins=c1["page_ins"] - c0["page_ins"],
        page_outs=c1["page_outs"] - c0["page_outs"],
        plan_us=plan_us, recs=list(driver.recs), t_end=t_end)
    attempted = sum(0.0 <= r.submit < t_end for r in driver.recs)

    tail = None
    if trace and cuda:
        tail = profile_tail(driver, -(-PROFILE_STEPS // max(
            1, int(eng["megastep"]))), eng["block_tokens"], fam.kv_dims(cfg))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # what the reference judges, read before the program's state is freed
    jd = wl["judge"]
    judged = judge.sample_finished(driver.recs, seed, judge.JUDGE_TOKENS)
    kv_recs = (judge.sample_live(driver.recs, seed, int(jd["kv_requests"]))
               if jd.get("kv_requests") and engine.paged else [])
    kv_blocks = [judge.pool_blocks(engine.pool, r) for r in kv_recs]
    failed = driver.failed
    driver.engine = None
    del engine, driver, api, params
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    limits = jd["limits"]
    checks, readings = {}, {}
    seqs = judge.served_sequences(judged)
    ref_out = ref.forward(weights, cfg, seqs) if seqs else []
    served = (judge.served_gaps(ref_out, judged) if seqs
              else torch.zeros(1))
    stats = judge.gap_stats(served)
    # the widest gap, or where a cell's limits name it the mean gap
    for key, stat in (("token_gap", "widest"), ("token_gap_mean", "mean")):
        if key in limits:
            checks[key] = {"value": stats[stat], "limit": limits[key],
                           "rule": "<="}
    checks["judged_tokens"] = {"value": int(served.numel()) if seqs else 0,
                               "limit": judge.JUDGE_TOKENS // 2,
                               "rule": ">="}
    if control and seqs:
        ctrl = judge.gap_stats(judge.control_gaps(
            ref_out, ref.forward(weights, cfg, seqs, mode="fp8")))
        readings.update(token_gap=ctrl["widest"], token_gap_mean=ctrl["mean"],
                        gap_stats={"program": stats, "control": ctrl})
    del ref_out
    if kv_recs:
        bt = eng["block_tokens"]
        errs, ctrl_errs = [], []
        for rec, blocks in zip(kv_recs, kv_blocks):
            toks = judge.fed_tokens(rec, blocks.shape[0] * bt)
            seq = [(toks, len(toks) - 1)]
            kv = ref.forward(weights, cfg, seq, want_kv=True)[0]["kv"]
            errs.append(judge.kv_rel_err(kv, blocks))
            if control:
                ckv = ref.forward(weights, cfg, seq, mode="fp8",
                                  want_kv=True)[0]["kv"]
                ctrl_errs.append(judge.kv_rel_err(
                    kv, ckv.reshape(blocks.shape)))
        checks["kv_rel_err"] = {"value": max(errs),
                                "limit": limits.get("kv_rel_err"),
                                "rule": "<="}
        if control:
            readings["kv_rel_err"] = max(ctrl_errs)
    checks["failed_requests"] = {"value": failed, "limit": 0, "rule": "<="}
    del weights, kv_blocks

    def ok(c):
        if c["limit"] is None:
            return False
        return (c["value"] <= c["limit"] if c["rule"] == "<="
                else c["value"] >= c["limit"])

    correct = all(ok(c) for c in checks.values())

    ctx = types.SimpleNamespace(cell=cell, cfg=cfg, setup_s=setup_s,
                                window=window, tail=tail)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.metric_reader(m.name)(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if tail is not None:
        dev.update(busy_s=tail.busy_s, window_s=tail.window_s)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if tail is not None:
        out["breakdown"] = tail.breakdown
    if control:
        out["control"] = readings
    out["checks"] = checks
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    import torch

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark must not load: {found}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} {c['rule']} {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
