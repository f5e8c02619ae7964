"""Multi-tenant continuous-batching serving over the duplex-paged KV pool
(port of ``repro.serve``: the flat and tiered pools, the fault layer, the
tracing plane, crash-consistent snapshots and sharded serving).

  RequestQueue — admission via the ``core.policies`` Policy protocol; LLM
                 prefills and tenant requests (declared ``TrafficProfile``)
                 wait here as hint-scoped streams;
  PagedKVPool  — block-table KV pool, host-numpy residency metadata, one
                 duplex-planned paging transaction per step, one
                 stream-kernel launch per hint scope;
  TieredHostPool — the pool's host side as DDR5 and CXL channels
                 (``EngineConfig.tiers="ddr5:2,cxl:2"``): hint-driven
                 weighted-interleave placement, per-channel billing,
                 ``tier_speedup`` against the all-DDR5 counterfactual, and
                 megastep-boundary migrations in the CXL links' idle
                 minor direction;
  FaultInjector — deterministic fault plans (channel degradation,
                 transient transfer errors, poisoned host blocks, channel
                 hot-unplug) serviced once per pool transaction; the
                 engine retries with billed backoff, quarantines and
                 fails only the owning request, evacuates, sheds, and
                 ``run()`` returns the survivors while ``engine.failed``
                 carries structured errors;
  WorkloadAPI  — the non-LLM tenant contract: ``KVStoreTenant`` (GET/SET
                 over pool-resident values) and ``VectorSearchTenant``
                 (gather + L2 distance walk with result write-back);
  ServeEngine  — the megastep loop: policy admission across tenants, the
                 fused token micro-steps with on-device argmax feedback,
                 one packed readback per megastep, one merged paging
                 transaction and tenant compute per step, depth-2
                 pipelined boundaries;
  StepGraphs   — on a CUDA device, the engine steps as CUDA graphs over the
                 engine's static cache and slot state, one per count of
                 active micro-steps, replayed once per inner step;
  Tracer       — the observability plane (``EngineConfig.trace``):
                 boundary spans on the host clock, per-channel duplex busy
                 timelines on the modelled clock, fault instants, Perfetto
                 export;
  SnapshotManager — crash consistency (``EngineConfig.snapshot_every``):
                 consistent cuts at megastep boundaries (pipeline drained,
                 dirty HBM flushed through the billed path), a crc-framed
                 write-ahead journal, and ``ServeEngine.restore()``, which
                 resumes a crashed run bit-exactly;
  ShardedServeEngine — the megastep loop over a ``data x model`` mesh
                 (``launch.mesh.make_debug_mesh``) from one controller:
                 batch rows and ``ShardedKVPool`` shards per data rank
                 (``ShardFaultView`` routes the fault plan per shard),
                 replicated decode per model rank, one packed readback
                 per megastep per mesh, modelled collective traffic
                 billed by ``IciMeter`` under ``/serve/ici/*``.
"""

from repro_torch.core.faults import (FaultEvent, FaultInjector,
                                     parse_fault_plan, random_plan)
from repro_torch.serve.engine import (EngineConfig, EngineStallError,
                                      ServeEngine, reference_decode)
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.queue import (FAILED, Request, RequestQueue,
                                     TrafficProfile)
from repro_torch.serve.shard import (IciMeter, ShardedKVPool,
                                     ShardedServeEngine, ShardFaultView)
from repro_torch.serve.snapshot import (SnapshotError, SnapshotManager,
                                        fresh_snapshot_stats)
from repro_torch.serve.tiers import TieredHostPool
from repro_torch.serve.trace import Tracer
from repro_torch.serve.workloads import (KVStoreTenant, VectorSearchTenant,
                                         WorkloadAPI)

__all__ = ["EngineConfig", "EngineStallError", "FAILED", "FaultEvent",
           "FaultInjector", "IciMeter", "KVStoreTenant", "PagedKVPool",
           "Request", "RequestQueue", "ServeEngine", "ShardFaultView",
           "ShardedKVPool", "ShardedServeEngine", "SnapshotError",
           "SnapshotManager", "StepGraphs", "TieredHostPool", "Tracer",
           "TrafficProfile", "VectorSearchTenant", "WorkloadAPI",
           "fresh_snapshot_stats", "parse_fault_plan", "random_plan",
           "reference_decode"]
