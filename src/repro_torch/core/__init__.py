"""CXLAimPod core of the port — duplex-aware memory scheduling in
PyTorch (port of ``repro.core``).

Layers:
  channel    — half/full-duplex channel models calibrated to the paper §3
  requests   — workload stream generators (the §3.1 microbenchmark)
  policies   — pluggable policy engine incl. Algorithm 1 (timeseries, hinted)
  scheduler  — the co-scheduling simulator (CUDA graphs of its steps on a
               GPU) + A/B harness
  hints      — cgroup-analogue hierarchical hint tree (§4.5)
  telemetry  — CAX bandwidth-attribution contexts (§4.3)
  offload    — duplex host↔HBM transfer planning/execution (§5.2 mechanism)
"""

from repro_torch.core.channel import (
    ChannelModel, PRESETS, DDR5_LOCAL, CXL_256, CXL_512, HBM_V5E, ICI_LINK,
    PCIE_HOST, effective_bandwidth, duplex_benefit,
)
from repro_torch.core.hints import HintTree, MemoryHint, \
    default_training_hints, default_serving_hints
from repro_torch.core.offload import (
    DuplexOffloadEngine, OffloadPlan, Transfer, PlanSlot, PAGE_IN, PAGE_OUT,
    plan_duplex, plan_serial, apply_kv_plan, validate_plan,
)
from repro_torch.core.policies import (
    Policy, PolicyParams, REGISTRY, get_policy,
)
from repro_torch.core.requests import StreamSpec, generate, \
    redis_pattern_specs
from repro_torch.core.scheduler import (
    SimConfig, SimResult, simulate, compare_policies, improvement,
)
from repro_torch.core.telemetry import CaxRegistry, CaxContext, \
    global_registry
