"""Multi-tenant serving, end to end: LLM decode + a Redis-style KV store
+ a vector-search walk sharing ONE duplex-paged pool (port of
``examples/multi_tenant_serve.py``).

Three workloads — the paper's §6.3-6.5 span — run through the same
``ServeEngine``: LLM requests decode in the fused step loop (CUDA graphs
of its steps on a GPU) while a ``KVStoreTenant`` serves GET/SET block ops
and a ``VectorSearchTenant`` walks candidate blocks through the CUDA
``l2_distance`` kernel. One admission policy (hint-seeded ``hinted``)
ranks every tenant's waiting work; one paging transaction per step moves
every tenant's blocks, scoped by hint path — the read-heavy Redis pattern
withdraws from duplex intervention (`/serve/redis/read_heavy` resolves
duplex_opt_in=False) while the mixed-direction scopes ride the fused
duplex kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serve
      (add ``--device cpu`` to run on the CPU)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.examples import parse_device
from repro_torch.models import registry as R
from repro_torch.serve import (EngineConfig, KVStoreTenant, ServeEngine,
                               VectorSearchTenant, reference_decode)

ARCH = "smollm-135m"


def model(device: torch.device):
    """smollm-135m's SMOKE config with seed-0 weights on ``device``."""
    api = R.build(ARCH, smoke=True, device=device)
    return api, api.init(torch.Generator(device).manual_seed(0))


def prompts_for(api) -> np.ndarray:
    """Three prompts of six tokens (seed 1)."""
    return np.random.default_rng(1).integers(
        0, api.cfg.vocab, (3, 6)).astype(np.int32)


def serve(api, params, prompts) -> dict:
    """Serve ``prompts`` beside a KV store and a vector search on one
    pool; print each tenant's result, the paging per hint scope and the
    LLM's check against the static-batch reference."""
    eng = ServeEngine(api, params, EngineConfig(
        max_batch=2, cache_len=64, block_tokens=4, hbm_blocks=14,
        pool_blocks=128, prefill_chunk=2, max_queue=16,
        device=str(api.device)))

    kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                      store_blocks=16))
    kv.preload(16)
    vec = eng.add_tenant(VectorSearchTenant(n_slots=1, n_queries=4,
                                            visits_per_step=2,
                                            data_blocks=10))

    rids = [eng.submit(np.asarray(prompts[i]), 10,
                       arrival_step=2 * i).rid for i in range(3)]
    kv.submit("sequential", n_steps=32)          # read-first sweep
    kv.submit("sequential", n_steps=32)          # write-first sweep
    kv.submit("read_heavy", n_steps=32)          # withdrawal scope
    vec.submit(n_steps=24)

    outs = eng.run()

    print("=== one engine, three tenants ===")
    for i, rid in enumerate(rids):
        r = eng.completed[rid]
        print(f"llm req{i}: admitted {r.admitted_step:2d} done "
              f"{r.done_step:2d} tokens {outs[rid][:6].tolist()}...")
    print(f"redis: {kv.ops_done} block ops over {len(kv._store)} value "
          f"blocks, checksum {kv.result():.2f}")
    res = vec.result()
    best = next(iter(res["best"].values()))
    print(f"vectordb: {vec.queries_done} queries, best distances "
          f"{np.round(best, 2).tolist()}")

    st = eng.paging_stats()
    print(f"\npool: {st['page_ins']} ins / {st['page_outs']} outs, "
          f"overall duplex_speedup {st['duplex_speedup']:.2f}x")
    print("per hint scope:")
    withdrawn = []
    for path, s in sorted(st["by_path"].items()):
        opted_out = not eng.hints.resolve(path).resolved().duplex_opt_in
        tag = " (withdrawn)" if opted_out else ""
        if opted_out:
            withdrawn.append(path)
        print(f"  {path:28s} ins {s['page_ins']:3d} outs "
              f"{s['page_outs']:3d} speedup "
              f"{s['duplex_speedup']:.2f}x{tag}")

    # LLM generation is exact despite the tenant traffic
    ref = reference_decode(api, params, prompts, 10,
                           cache_len=64).cpu().numpy()
    ok = all(np.array_equal(outs[rids[i]], ref[i]) for i in range(3))
    print(f"\nstaggered multi-tenant == static-batch reference: {ok}")
    return {"engine": eng, "rids": rids, "outs": outs, "kv": kv,
            "vec": vec, "withdrawn": withdrawn, "ok": ok}


def main(argv=None) -> int:
    _, device = parse_device(__doc__, argv)
    api, params = model(device)
    serve(api, params, prompts_for(api))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
