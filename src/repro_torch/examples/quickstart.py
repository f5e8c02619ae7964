"""Quickstart — the paper's result in three acts (port of
``examples/quickstart.py``).

  1. characterize the duplex channel (paper §3, Obs 1);
  2. A/B the duplex-aware scheduler against CFS on a phase-correlated
     workload (paper §6.2), on the simulator (CUDA graphs of its steps on
     a GPU);
  3. train a reduced LM with the full stack (data → model → optimizer →
     checkpoint) and serve it with batched decode (the engine replays
     CUDA graphs of its steps on a GPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      (add ``--device cpu`` to run on the CPU)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import channel as ch
from repro_torch.core import scheduler as sched
from repro_torch.core.requests import StreamSpec
from repro_torch.examples import device_line, parse_device
from repro_torch.models import registry as R
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train import TrainConfig, Trainer
from repro_torch.serve import EngineConfig, ServeEngine

ARCH = "smollm-135m"


def act1_characterize():
    print("=== Act 1: duplex characterization (paper §3) ===")
    for name in ("ddr5-local", "cxl-256gb", "cxl-512gb"):
        d = ch.duplex_benefit(ch.PRESETS[name])
        print(f"  {name:12s} peak {d['peak_gbps']:6.1f} GB/s at "
              f"r={d['peak_read_fraction']:.2f}  "
              f"duplex benefit {d['improvement_vs_write']:+.0%}")
    print("  -> CXL gains ~55-61% at balanced mixes; DDR5 is flat.\n")


def act2_schedule(device: torch.device, steps: int = 1024) -> dict:
    """Returns ``compare_policies``' results for cfs and timeseries."""
    print("=== Act 2: duplex-aware scheduling A/B (paper §6.2) ===")
    specs = [StreamSpec(name=f"worker{i}", pattern="phased",
                        offered_gbps=8.0, read_fraction=0.5,
                        phase_steps=64) for i in range(8)]
    res = sched.compare_policies(ch.CXL_512, specs, ("cfs", "timeseries"),
                                 sim=sched.SimConfig(steps=steps),
                                 device=device)
    imp = sched.improvement(res, "timeseries", "cfs")
    print(f"  8 phase-correlated workers, 4 cores, CXL-512 channel:")
    print(f"  CFS        {res['cfs']['gbps']:6.1f} GB/s "
          f"(lockstep: one direction idles)")
    print(f"  CXLAimPod  {res['timeseries']['gbps']:6.1f} GB/s "
          f"({imp:+.0%} — priming + quota dispatch)\n")
    return res


def act3_train_and_serve(api, params=None) -> dict:
    """Train ``api`` 30 steps (from ``params``, or from the trainer's
    seed-0 weights), then serve two greedy requests from the trained
    weights. Returns the loss history and the two requests' tokens."""
    print("=== Act 3: train + serve on the full stack ===")
    trainer = Trainer(api, TrainConfig(
        seq_len=64, global_batch=8, steps=30,
        optim=AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=30)))
    opt = None if params is None else adamw_init(params)
    params, _, hist = trainer.run(params, opt)
    print(f"  arch={api.arch_id} (reduced) params="
          f"{api.param_count / 1e6:.1f}M-family")
    print(f"  loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over {len(hist)} steps")
    engine = ServeEngine(api, params, EngineConfig(
        max_batch=2, cache_len=64, megastep=4, device=str(api.device)))
    rids = [engine.submit(np.ones(4, np.int32), 12).rid
            for _ in range(2)]
    outs = engine.run()
    st = engine.stats()
    print(f"  served {len(rids)}x{len(outs[rids[0]])} greedy tokens in "
          f"{st['steps']} steps / {st['host_dispatches']} host "
          f"dispatches: {outs[rids[0]][:8].tolist()}...")
    return {"history": hist, "outs": [outs[r] for r in rids]}


def main(argv=None) -> int:
    _, device = parse_device(__doc__, argv)
    print(f"device: {device_line(device)}\n")
    act1_characterize()
    act2_schedule(device)
    act3_train_and_serve(R.build(ARCH, smoke=True, device=device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
