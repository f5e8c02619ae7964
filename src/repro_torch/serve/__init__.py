"""Multi-tenant continuous-batching serving over the duplex-paged KV pool
(port of ``repro.serve``: flat pool, no faults, snapshots or tracing).

  RequestQueue — admission via the ``core.policies`` Policy protocol; LLM
                 prefills and tenant requests (declared ``TrafficProfile``)
                 wait here as hint-scoped streams;
  PagedKVPool  — block-table KV pool, host-numpy residency metadata, one
                 duplex-planned paging transaction per step, one
                 stream-kernel launch per hint scope;
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
                 active micro-steps, replayed once per inner step.
"""

from repro_torch.serve.engine import (EngineConfig, EngineStallError,
                                      ServeEngine, reference_decode)
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.queue import Request, RequestQueue, TrafficProfile
from repro_torch.serve.workloads import (KVStoreTenant, VectorSearchTenant,
                                         WorkloadAPI)

__all__ = ["EngineConfig", "EngineStallError", "KVStoreTenant",
           "PagedKVPool", "Request", "RequestQueue", "ServeEngine",
           "StepGraphs", "TrafficProfile", "VectorSearchTenant", "WorkloadAPI",
           "reference_decode"]
