"""Duplex tour — every layer of the paper's idea in one script (port of
``examples/duplex_tour.py``).

  layer 0: the channel physics (half vs full duplex, Obs 1);
  layer 1: Algorithm 1's moving parts (oversubscription, withdrawal,
           priming, quota dispatch) on a live trace;
  layer 2: the DMA-level expression — the fused CUDA duplex kernel vs
           its phase-separated twin (dequant_stream + quant_stream), with
           both routes' device times on a GPU;
  layer 3: the distributed expression — optimizer moments streaming
           through the host pool, duplex vs serial plans.

Run:  PYTHONPATH=src python -m repro_torch.examples.duplex_tour
      (add ``--device cpu`` to run on the CPU)
"""

from __future__ import annotations

import torch

from repro_torch.core import channel as ch
from repro_torch.core import scheduler as sched
from repro_torch.core.offload import DuplexOffloadEngine
from repro_torch.core.requests import StreamSpec
from repro_torch.examples import device_line, parse_device
from repro_torch.kernels import ops, ref

POLICIES = ("cfs", "ddr_batching", "threshold", "timeseries")
#: layer 2's streams: (blocks, tokens, kv_dims)
STREAM_SHAPE = (8, 64, 256)
#: layer 2's timing on a GPU: launches timed per route, in turns, queued
#: behind a spin of HOLD_CYCLES (~25 ms) that holds the stream while the
#: host launches them, so the events time the card running them back to
#: back and not the host's launch rate
TIMED_ITERS, TIMED_ROUNDS = 50, 3
HOLD_CYCLES = 50_000_000


def layer0():
    print("=== layer 0: channel physics ===")
    rs = [0.0, 0.25, 0.5, 0.75, 1.0]
    for name in ("ddr5-local", "cxl-512gb"):
        bw = [float(ch.effective_bandwidth(ch.PRESETS[name], r))
              for r in rs]
        print(f"  {name:12s} " + "  ".join(
            f"r={r:.2f}:{b:6.1f}" for r, b in zip(rs, bw)))
    print()


def layer1(device: torch.device, steps: int = 1024) -> dict:
    """Returns {policy: (GB/s, share of steps with both directions
    busy)}."""
    print("=== layer 1: Algorithm 1 on a lockstep workload ===")
    specs = [StreamSpec(name=f"w{i}", pattern="phased", offered_gbps=8.0,
                        phase_steps=64) for i in range(8)]
    out = {}
    for policy in POLICIES:
        res = sched.simulate(ch.CXL_512, specs, policy,
                             sim=sched.SimConfig(steps=steps),
                             device=device)
        both = float(torch.mean(torch.logical_and(
            res.moved_read > 1, res.moved_write > 1).float()))
        gbps = float(res.achieved_gbps())
        out[policy] = (gbps, both)
        print(f"  {policy:12s} {gbps:6.1f} GB/s  "
              f"(both-directions-busy {both:.0%} of steps)")
    print()
    return out


def stream_inputs(device: torch.device, seed: int = 0):
    """Layer 2's streams: an int8 page-in stream with its per-row scales
    (quantized from normal draws) and a bf16 page-out stream."""
    g = torch.Generator().manual_seed(seed)
    in_x = torch.randn(STREAM_SHAPE, generator=g)
    out_x = torch.randn(STREAM_SHAPE, generator=g).to(torch.bfloat16)
    in_q, in_scale = ref.quantize_int8(in_x)
    return in_q.to(device), in_scale.to(device), out_x.to(device)


def route_ms(fn) -> float:
    """Device ms of one call of ``fn``: CUDA events around
    ``TIMED_ITERS`` calls queued behind a spin, after a warm-up,
    synchronised."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(TIMED_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_ITERS


def layer2(in_q, in_scale, out_x) -> dict:
    """The fused kernel against the phase-separated pair on the same
    streams; on a GPU both routes timed in turns (fused, split, split,
    fused, ...). Returns both routes' outputs and times."""
    print("=== layer 2: fused duplex kernel vs phase-separated ===")
    fused = ops.duplex_kv_stream(in_q, in_scale, out_x, fused=True)
    split = ops.duplex_kv_stream(in_q, in_scale, out_x, fused=False)
    same = all(bool(torch.equal(a, b)) for a, b in zip(fused, split))
    n_bytes = (in_q.numel() * in_q.element_size()
               + out_x.numel() * out_x.element_size())
    print(f"  {n_bytes / 1e6:.1f} MB migrated both ways; fused == "
          f"phase-separated: {same}")
    out = {"fused": fused, "split": split, "same": same, "bytes": n_bytes}
    if in_q.device.type != "cuda":
        print("  (device times: not measured on the CPU)")
        print()
        return out
    times = {"fused": [], "split": []}
    for turn in range(TIMED_ROUNDS):
        order = ("fused", "split") if turn % 2 == 0 else ("split", "fused")
        for route in order:
            times[route].append(route_ms(
                lambda f=route == "fused": ops.duplex_kv_stream(
                    in_q, in_scale, out_x, fused=f)))
    out.update({f"{r}_ms": sorted(t)[len(t) // 2] for r, t in times.items()})
    print(f"  device time a call: fused {out['fused_ms'] * 1e3:.2f} us "
          f"(one launch), phase-separated {out['split_ms'] * 1e3:.2f} us "
          f"(two launches)")
    print(f"  on {device_line(in_q.device)}")
    print()
    return out


def layer3():
    print("=== layer 3: optimizer moments through the host pool ===")
    eng = DuplexOffloadEngine()
    for gb in (1, 8, 64):
        d, s = eng.plan_state_stream(nbytes=gb * 1e9, chunk_bytes=64e6)
        print(f"  {gb:3d} GB of Adam moments: duplex "
              f"{d.modelled_time_us() / 1e3:8.1f} ms vs serial "
              f"{s.modelled_time_us() / 1e3:8.1f} ms "
              f"({eng.speedup(d, s):.2f}x)")


def main(argv=None) -> int:
    _, device = parse_device(__doc__, argv)
    layer0()
    layer1(device)
    layer2(*stream_inputs(device))
    layer3()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
