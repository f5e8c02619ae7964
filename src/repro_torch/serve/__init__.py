"""Continuous-batching serving over the duplex-paged KV pool (port of
``repro.serve``: flat pool, LLM requests only).

  RequestQueue — admission via the ``core.policies`` Policy protocol;
  PagedKVPool  — block-table KV pool, host-numpy residency metadata, one
                 duplex-planned paging transaction and one stream-kernel
                 launch per step;
  ServeEngine  — the megastep loop: policy admission, the fused token
                 micro-steps with on-device argmax feedback, one packed
                 readback per megastep, depth-2 pipelined boundaries.
"""

from repro_torch.serve.engine import (EngineConfig, EngineStallError,
                                      ServeEngine, reference_decode)
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.queue import Request, RequestQueue

__all__ = ["EngineConfig", "EngineStallError", "PagedKVPool", "Request",
           "RequestQueue", "ServeEngine", "reference_decode"]
