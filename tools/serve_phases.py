"""Where an engine step's host time goes, read from the program's own
trace: one run of a cell of the benchmark (``BENCHMARK.json``,
``portbench/``) on the card, with the engine traced.

    python3 tools/serve_phases.py --workload smollm-chat --seed 7 \
        --seconds 51 [--untraced]

Set-up, ramp and window are the benchmark's (``portbench/run.py``), and
nothing is judged. Over the window it reads the engine's nested phases
(``Tracer.phases``) as host µs an engine step, ``row_advances`` over
``decode_steps`` x ``max_batch`` (the share of the steps' row work that
moved a request), the p95 queue wait and overtakes of the requests'
stamps, and tokens/s. Then it profiles ``run.PROFILE_STEPS`` more engine
steps and puts each stretch of device idle down to the innermost
``engine/`` profiler range that covers its middle, on the profiler's own
clock, or to ``outside engine``. ``--untraced`` runs the same window and
profile with tracing off, for the cost of tracing. The last line of
standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _program_trace():
    """``devtrace.DeviceTrace`` that also keeps the program's own host
    ranges, ``program_ranges`` (name without ``engine/``, start ns, end
    ns), and counts the ``engine/`` events the profiler placed on the
    device, ``device_program_events`` (none is expected: the ranges are
    CPU ops)."""
    from torch.autograd import DeviceType

    from portbench import devtrace
    from repro_torch.serve.trace import RANGE_PREFIX

    class ProgramTrace(devtrace.DeviceTrace):
        def __exit__(self, *exc):
            prof = self._prof
            out = super().__exit__(*exc)
            self.program_ranges, self.device_program_events = [], 0
            for e in prof.profiler.kineto_results.events():
                name = e.name()
                if not name.startswith(RANGE_PREFIX):
                    continue
                if e.device_type() == DeviceType.CUDA:
                    self.device_program_events += 1
                else:
                    self.program_ranges.append(
                        (name[len(RANGE_PREFIX):], e.start_ns(),
                         e.start_ns() + e.duration_ns()))
            return out

    return ProgramTrace()


def idle_by_range(dt) -> dict:
    """The profiled megasteps' device idle (``portbench/run.py``'s window:
    from the first ``pb:megastep`` range to the last harness range's end),
    each gap put down to the innermost ``engine/`` range covering its
    middle, else ``outside engine``; with the window's seconds, busy
    seconds and the ranges that stick out of it."""
    from portbench import devtrace

    mega = sorted(r for r in dt.ranges if r[0].endswith("megastep"))
    lo, hi = mega[0][1], max(r[2] for r in dt.ranges)
    dev = [(max(s, lo), min(e, hi)) for _, s, e in dt.device
           if e > lo and s < hi]
    ranges = sorted(dt.program_ranges, key=lambda r: r[2] - r[1])
    idle: dict[str, float] = {}
    for s, e in devtrace.gaps(dev, lo, hi):
        mid = (s + e) / 2
        name = next((n for n, a, b in ranges if a <= mid < b),
                    "outside engine")
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    first = mega[0][1]
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": devtrace.union_ns(dev) / 1e9,
            "idle_phases": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "ranges": len(dt.program_ranges),
            "ranges_outside": sum(a < first or b > hi
                                  for _, a, b in dt.program_ranges),
            "device_program_events": dt.device_program_events}


def host_us(tracer, c0, c1) -> dict:
    """Host µs by span and phase name between two ``counts()``."""
    per: dict[str, float] = {}
    for name, _, dur, _ in (tracer.phases[c0[3]:c1[3]]
                            + tracer.spans[c0[4]:c1[4]]):
        per[name] = per.get(name, 0.0) + dur
    return dict(sorted(per.items()))


def measure(cell, seed: int, seconds: float, traced: bool,
            device: str) -> dict:
    """One run of ``cell`` (a ``spec.Cell``) on ``device``; the profile
    only on a CUDA device."""
    import torch

    from portbench import run, spec
    from portbench.loop import Driver
    from portbench.traffic import ClosedLoop
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    t_start = time.perf_counter()
    cfg, eng = cell.config, dict(cell.workload["engine"])
    fam = spec.family(cfg["family"])
    weights = fam.make_weights(cfg, seed, device)
    api = fam.program_api(cfg, device, eng["cache_len"],
                          smoke=bool(cfg.get("smoke")))
    plan = ClosedLoop(cell.traffic, fam.vocab(cfg), seed)
    engine = ServeEngine(api, fam.program_params(weights, cfg), EngineConfig(
        **eng, max_queue=plan.clients + eng["max_batch"],
        trace=True if traced else None, device=device))
    run.warm_up(engine, eng, fam.vocab(cfg), seed)
    loop = Driver(engine, plan, lambda a, b: fam.range_flops(cfg, a, b))
    loop.start()
    while loop.now() < run.RAMP_S:
        loop.boundary()
    gc.collect()
    gc.freeze()
    tr = engine.tracer

    def counts():
        return (engine.step_count, engine.decode_steps, engine.row_advances,
                len(tr.phases) if tr is not None else 0,
                len(tr.spans) if tr is not None else 0)

    loop.open_window()
    c0 = counts()
    setup_s = time.perf_counter() - t_start
    t_end = 0.0
    while t_end < seconds:
        t_end = loop.boundary()
    c1 = counts()
    steps, micro, adv = (c1[i] - c0[i] for i in range(3))
    window = types.SimpleNamespace(recs=list(loop.recs), t_end=t_end)
    ctx = types.SimpleNamespace(window=window)
    out = {"cell": cell.name, "seed": seed, "traced": tr is not None,
           "device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else device), "setup_s": setup_s,
           "window": {"seconds": t_end, "steps": steps, "micro": micro,
                      "row_advances": adv,
                      "tokens_per_s": loop.tokens / t_end,
                      "useful_row_share": adv / (micro * eng["max_batch"])
                      * 100.0}}
    if tr is not None:
        per = host_us(tr, c0, c1)
        w = out["window"]
        w["phase_us_per_step"] = {k: v / steps for k, v in per.items()}
        w["readback_wait_ms_per_step"] = \
            per.get("reconcile.wait", 0.0) / steps / 1e3
        w["paging_host_us_per_step"] = per.get("dispatch.page", 0.0) / steps
        for name in ("queue_wait_p95_ms", "admission_overtakes_p95",
                     "queue_wait_ms"):
            w[name] = spec.metric_reader(name)(ctx)

    if device != "cuda":
        gc.unfreeze()
        return out
    n = -(-run.PROFILE_STEPS // max(1, int(eng["megastep"])))
    c0 = counts()
    loop.ranges, loop.marks = True, []
    with _program_trace() as dt:
        for _ in range(n):
            loop.boundary()
    loop.ranges = False
    c1 = counts()
    prof = idle_by_range(dt)
    prof["steps"] = c1[0] - c0[0]
    if tr is not None:
        # the host's phases under the profiler, beside the window's
        prof["phase_us_per_step"] = {
            k: v / prof["steps"] for k, v in host_us(tr, c0, c1).items()}
    prof["step_ms"] = prof["window_s"] / prof["steps"] * 1e3
    prof["idle_share"] = (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
    prof["idle_ms_per_step"] = {
        k: v / prof["steps"] * 1e3 for k, v in prof["idle_phases"].items()}
    out["profile"] = prof
    gc.unfreeze()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--untraced", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run
    run.setup_paths()
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 2
    out = measure(spec.load_cell(args.workload), args.seed, args.seconds,
                  not args.untraced, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
