"""Continuous-batching serving with a duplex-paged KV pool, end to end
(port of ``examples/serve_offload.py``).

Requests arrive mid-stream into the ``ServeEngine``: the admission policy
(the same ``core.policies`` stack the simulator A/Bs) picks which waiting
prefills join the running batch, freshly produced KV blocks write through
to the ``PagedKVPool``, and each step's whole-batch page traffic runs as
one ``DuplexOffloadEngine`` plan + one fused ``duplex_kv_stream`` kernel
launch (page-ins dequantizing while evictions quantize — both directions
busy). The modelled duplex-vs-serial link timing is the serving analogue
of the paper's +71.6% decode claim.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_offload
      (add ``--device cpu`` to run on the CPU)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.examples import parse_device
from repro_torch.models import registry as R
from repro_torch.serve import (EngineConfig, PagedKVPool, ServeEngine,
                               reference_decode)

ARCH = "llama3.2-3b"


def model(device: torch.device):
    """llama3.2-3b's SMOKE config with seed-0 weights on ``device``."""
    api = R.build(ARCH, smoke=True, device=device)
    return api, api.init(torch.Generator(device).manual_seed(0))


def prompts_for(api) -> np.ndarray:
    """Six prompts of six tokens (seed 1)."""
    return np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 6)).astype(np.int32)


def serve(api, params, prompts) -> dict:
    """Serve ``prompts`` (6 requests, one every 3 steps) through 2 slots
    and a 4-block HBM pool; print the schedule, the paging and the check
    against the static-batch reference. Returns the engine, its outputs
    and the check."""
    print("=== continuous-batching decode over the duplex-paged pool ===")
    # 2 decode slots, 6 requests arriving every 3 steps; the KV pool holds
    # 4 HBM blocks against a working set of up to 10 (the 671B-in-CXL
    # regime at miniature scale).
    eng = ServeEngine(api, params,
                      EngineConfig(max_batch=2, cache_len=64,
                                   block_tokens=4, hbm_blocks=4,
                                   prefill_chunk=2, max_queue=8,
                                   device=str(api.device)))
    rids = [eng.submit(np.asarray(prompts[i]), 12, arrival_step=3 * i).rid
            for i in range(6)]
    outs = eng.run()
    for i, rid in enumerate(rids):
        r = eng.completed[rid]
        print(f"req{i}: arrived {r.arrival_step:2d} admitted "
              f"{r.admitted_step:2d} done {r.done_step:2d} "
              f"tokens {outs[rid][:6].tolist()}...")

    s = eng.paging_stats()
    print(f"\npage-ins {s['page_ins']}, page-outs {s['page_outs']}, "
          f"{s['kernel_calls']} fused kernel calls over {eng.step_count} "
          f"engine steps (one per paging step, whole batch)")
    print(f"modelled link time: duplex {s['duplex_us']:.2f}us vs "
          f"phase-separated {s['serial_us']:.2f}us "
          f"-> {s['duplex_speedup']:.2f}x")

    # mid-stream arrivals decode exactly like a static batch
    ref = reference_decode(api, params, prompts[:2], 12,
                           cache_len=64).cpu().numpy()
    ok = all(np.array_equal(outs[rids[i]], ref[i]) for i in range(2))
    print(f"staggered == static-batch reference (first 2 reqs): {ok}")
    return {"engine": eng, "rids": rids, "outs": outs, "ok": ok}


def roundtrip_blocks(device: torch.device) -> dict[int, torch.Tensor]:
    """Eight (8, 128) bf16 blocks of normal draws, block b from seed b."""
    return {b: torch.randn((8, 128), generator=torch.Generator()
                           .manual_seed(b)).to(torch.bfloat16).to(device)
            for b in range(8)}


def roundtrip(blocks: dict, device: torch.device) -> float:
    """Spill ``blocks`` through a 4-slot pool's int8 host tier and page
    them back in; returns the largest error."""
    print("\n=== int8 round-trip through the pool's host tier ===")
    pool = PagedKVPool(n_blocks=16, hbm_blocks=4, block_shape=(8, 128),
                       device=device)
    for b, x in blocks.items():
        pool.step([b])
        pool.write([b], x[None])
    worst = 0.0
    for b, x in blocks.items():
        pool.step([b])                      # pages back in through int8
        back = pool.read([b])[0]
        worst = max(worst, float(torch.max(torch.abs(
            back.float() - x.float()))))
    print(f"max int8-roundtrip error across 8 blocks: {worst:.4f}")
    return worst


def main(argv=None) -> int:
    _, device = parse_device(__doc__, argv)
    api, params = model(device)
    serve(api, params, prompts_for(api))
    roundtrip(roundtrip_blocks(device), device)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
