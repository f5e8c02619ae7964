"""Channel models for duplex-aware memory scheduling (CXLAimPod §2-§3).

Port of ``repro/core/channel.py``: the static ``ChannelModel`` (with
``degraded``, the fault layer's bandwidth cut), its calibrated presets,
the host-tier spec parser, the scalar effective-bandwidth curve the
serving path bills with, and the simulator's half — the float32 tensor
curve ``effective_bandwidth``, ``duplex_benefit`` and the step-wise
channel state machine (``channel_params`` / ``channel_step``) that
``core.scheduler`` runs. Link timing in the port is modelled, exactly as
in the reference, so these are plain arithmetic and reproduce the
reference's numbers bit for bit: the scalar curve in float64 Python
floats, the tensor ones operation for operation in float32.

Units: bandwidth in GB/s (1e9 bytes/s); latency/turnaround in
nanoseconds; the simulator's timestep is 1 microsecond, so
``bytes_per_step = GBps * 1e3``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

BYTES_PER_GB = 1.0e9
STEP_NS = 1_000.0  # one simulator step == 1 us
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Static description of one memory channel / link.

    Attributes:
      name: human-readable identifier.
      read_bw: peak read bandwidth, GB/s (random access, unloaded).
      write_bw: peak write bandwidth, GB/s (random access).
      duplex: True for full-duplex (separate TX/RX paths), False for a
        shared half-duplex bus.
      duplex_coupling: kappa in [0, 1] — fraction of minor-direction traffic
        that overlaps with the major direction on a full-duplex link.
      turnaround_ns: half-duplex bus direction-switch penalty.
      batch_bytes: controller batching granularity used to amortize
        turnaround on half-duplex buses.
      latency_ns: loaded access latency.
      seq_read_boost: sequential/random read bandwidth ratio.
      seq_write_boost: sequential/random write bandwidth ratio.
    """

    name: str
    read_bw: float
    write_bw: float
    duplex: bool
    duplex_coupling: float = 0.0
    turnaround_ns: float = 0.0
    batch_bytes: float = 4096.0
    latency_ns: float = 100.0
    seq_read_boost: float = 1.0
    seq_write_boost: float = 1.0

    def direction_bw(self, sequential: bool) -> tuple[float, float]:
        if sequential:
            return (self.read_bw * self.seq_read_boost,
                    self.write_bw * self.seq_write_boost)
        return (self.read_bw, self.write_bw)

    def bytes_per_step(self, sequential: bool = False) -> tuple[float, float]:
        r, w = self.direction_bw(sequential)
        scale = BYTES_PER_GB * STEP_NS * 1e-9
        return (r * scale, w * scale)

    def degraded(self, factor: float) -> "ChannelModel":
        """This channel at ``factor`` of nominal bandwidth (fault
        injection: link retraining / thermal throttle). Latency and
        duplex behaviour are unchanged — only both direction rates
        scale, so billing under degradation stays on the same
        effective-bandwidth curve."""
        if not 0.0 < factor <= 1.0:
            raise ValueError("degradation factor must be in (0, 1]")
        if factor == 1.0:
            return self
        return dataclasses.replace(
            self, name=f"{self.name}@{factor:g}x",
            read_bw=self.read_bw * factor, write_bw=self.write_bw * factor)


# ---------------------------------------------------------------------------
# Calibrated presets (constants and their sources: repro/core/channel.py).
# ---------------------------------------------------------------------------

DDR5_LOCAL = ChannelModel(
    name="ddr5-local",
    read_bw=189.0,
    write_bw=187.0,
    duplex=False,
    turnaround_ns=13.0,
    batch_bytes=20000.0,
    latency_ns=80.0,
    seq_read_boost=198.8 / 189.0,
    seq_write_boost=198.8 / 189.0,
)

CXL_256 = ChannelModel(
    name="cxl-256gb",
    read_bw=23.9,
    write_bw=22.2,
    duplex=True,
    duplex_coupling=0.66,
    latency_ns=170.0,
    seq_read_boost=3.0,
    seq_write_boost=1.4,
)

CXL_512 = ChannelModel(
    name="cxl-512gb",
    read_bw=48.8,
    write_bw=36.2,
    duplex=True,
    duplex_coupling=0.53,
    latency_ns=170.0,
    seq_read_boost=186.6 / 48.8,
    seq_write_boost=59.0 / 36.2,
)

HBM_V5E = ChannelModel(
    name="hbm-v5e",
    read_bw=819.0,
    write_bw=819.0,
    duplex=False,
    turnaround_ns=5.0,
    batch_bytes=512.0,
    latency_ns=400.0,
)

ICI_LINK = ChannelModel(
    name="ici-link",
    read_bw=50.0,
    write_bw=50.0,
    duplex=True,
    duplex_coupling=0.95,
    latency_ns=1_000.0,
)

PCIE_HOST = ChannelModel(
    # Host<->HBM DMA path; the "CXL pool" link of the serving KV pool.
    name="pcie-host",
    read_bw=60.0,
    write_bw=60.0,
    duplex=True,
    duplex_coupling=0.90,
    latency_ns=2_000.0,
)

PRESETS: dict[str, ChannelModel] = {
    c.name: c
    for c in (DDR5_LOCAL, CXL_256, CXL_512, HBM_V5E, ICI_LINK, PCIE_HOST)
}

DDR5_HOST = ChannelModel(
    name="ddr5-host",
    read_bw=64.0,
    write_bw=63.4,
    duplex=False,
    turnaround_ns=13.0,
    batch_bytes=8192.0,
    latency_ns=80.0,
)

CXL_HOST = ChannelModel(
    name="cxl-host",
    read_bw=64.0,
    write_bw=64.0,
    duplex=True,
    duplex_coupling=0.85,
    latency_ns=170.0,
)

#: Host-tier kinds (hint ``tier`` values name one of these).
TIER_PRESETS: dict[str, ChannelModel] = {
    "ddr5": DDR5_HOST,
    "cxl": CXL_HOST,
}

#: Cross-device interconnect kinds. Collective traffic between mesh shards
#: (``serve.shard.IciMeter``) is billed through these with the same
#: ``offload.channel_time_us`` arithmetic as the DDR5/CXL host channels.
INTERCONNECT_PRESETS: dict[str, ChannelModel] = {
    "ici": ICI_LINK,
}


def parse_tier_spec(spec: str) -> list[tuple[str, ChannelModel]]:
    """Parse a ``kind:count,...`` channel-set spec into (kind, model) pairs.

    ``"ddr5:2,cxl:2"`` -> two DDR5 channels followed by two CXL channels.
    Raises ``ValueError`` naming the known kinds on any malformed or
    unknown entry, so CLI frontends can validate at argparse time.
    """
    known = ",".join(sorted(TIER_PRESETS))
    entries = [e.strip() for e in spec.split(",") if e.strip()]
    if not entries:
        raise ValueError(
            f"empty tier spec {spec!r}; expected kind:count pairs like "
            f"'ddr5:2,cxl:2' (known kinds: {known})")
    channels: list[tuple[str, ChannelModel]] = []
    for entry in entries:
        kind, sep, count = entry.partition(":")
        if kind not in TIER_PRESETS:
            raise ValueError(
                f"unknown tier kind {kind!r} in {spec!r}; known kinds: "
                f"{known}")
        n = 1
        if sep:
            try:
                n = int(count)
            except ValueError:
                raise ValueError(
                    f"bad channel count {count!r} for tier {kind!r} in "
                    f"{spec!r}; expected kind:count pairs like "
                    f"'ddr5:2,cxl:2' (known kinds: {known})") from None
        if n < 1:
            raise ValueError(
                f"tier {kind!r} needs at least one channel, got {n} "
                f"(spec {spec!r}; known kinds: {known})")
        channels.extend((kind, TIER_PRESETS[kind]) for _ in range(n))
    return channels


def effective_bandwidth_scalar(channel: ChannelModel,
                               read_fraction: float,
                               sequential: bool = False) -> float:
    """Steady-state achievable bandwidth (GB/s) at a given read fraction.

    Full-duplex: t(r) = max(r/Br, w/Bw) + (1 - kappa) * min(r/Br, w/Bw).
    Half-duplex: t(r) = r/Br + w/Bw + 4 r w * (2 * turnaround / batch).
    """
    r = float(read_fraction)
    w = 1.0 - r
    br, bw = channel.direction_bw(sequential)
    tr = r / br
    tw = w / bw
    if channel.duplex:
        t = (max(tr, tw)
             + (1.0 - channel.duplex_coupling) * min(tr, tw))
    else:
        switch_cost = 2.0 * channel.turnaround_ns * 1e-9 / channel.batch_bytes
        t = tr + tw + 4.0 * r * w * switch_cost * BYTES_PER_GB
    return 1.0 / t


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 scalar tensor beside ``like``: the
    weak-typed scalar operand of the reference's ``jnp`` arithmetic."""
    return torch.full((), x, dtype=F32, device=like.device)


def effective_bandwidth(channel: ChannelModel, read_fraction,
                        sequential: bool = False) -> torch.Tensor:
    """Steady-state achievable bandwidth (GB/s) at a given read fraction,
    as a float32 tensor (``read_fraction``: a float or a tensor).

    Full-duplex: t(r) = max(r/Br, w/Bw) + (1 - kappa) * min(r/Br, w/Bw).
    Half-duplex: t(r) = r/Br + w/Bw + 4 r w * (2 * turnaround / batch).

    Every division is a tensor divide: PyTorch divides by a Python scalar
    as a multiply by its reciprocal, which is not the reference's IEEE
    divide.
    """
    r = torch.as_tensor(read_fraction, dtype=F32)
    w = 1.0 - r
    br, bw = channel.direction_bw(sequential)
    tr = r / _f32(br, r)
    tw = w / _f32(bw, r)
    if channel.duplex:
        t = (torch.maximum(tr, tw)
             + (1.0 - channel.duplex_coupling) * torch.minimum(tr, tw))
    else:
        switch_cost = 2.0 * channel.turnaround_ns * 1e-9 / channel.batch_bytes
        t = tr + tw + 4.0 * r * w * switch_cost * BYTES_PER_GB
    return torch.ones_like(t) / t


def duplex_benefit(channel: ChannelModel, sequential: bool = False,
                   grid: int = 101) -> dict[str, float]:
    """Peak-vs-pure-write improvement, reproducing Obs 1's 55-61% metric,
    over the reference's float32 grid (first maximum wins)."""
    rs = torch.linspace(0.0, 1.0, grid, dtype=F32)
    bws = effective_bandwidth(channel, rs, sequential)
    peak_idx = int(torch.argmax(bws))
    pure_write = float(effective_bandwidth(channel, 0.0, sequential))
    pure_read = float(effective_bandwidth(channel, 1.0, sequential))
    peak = float(bws[peak_idx])
    return {
        "peak_gbps": peak,
        "peak_read_fraction": float(rs[peak_idx]),
        "pure_write_gbps": pure_write,
        "pure_read_gbps": pure_read,
        "improvement_vs_write": peak / pure_write - 1.0,
        "improvement_vs_read": peak / pure_read - 1.0,
        "flatness": (float(torch.max(bws)) - float(torch.min(bws)))
                    / float(torch.min(bws)),
    }


def peak_read_fraction(channel: ChannelModel) -> float:
    """The read fraction at which the channel moves the most bytes: the
    ``peak_read_fraction`` of ``duplex_benefit``."""
    return duplex_benefit(channel)["peak_read_fraction"]


# ---------------------------------------------------------------------------
# Step-wise channel state machine (consumed by scheduler.simulate).
# ---------------------------------------------------------------------------

class ChannelState(NamedTuple):
    """Dynamic channel state carried through the simulation."""
    last_direction: torch.Tensor  # int32: 0=read, 1=write, 2=idle
    cooldown: torch.Tensor        # float32: residual turnaround, of a step
    total_read: torch.Tensor      # float32 bytes moved
    total_write: torch.Tensor
    switches: torch.Tensor        # int32 direction switches charged


def init_channel_state(device: torch.device | str = "cpu") -> ChannelState:
    def scalar(v, dtype):
        # filled on the device: a host scalar copied to the card would
        # wait for the stream
        return torch.full((), v, dtype=dtype, device=device)

    return ChannelState(
        last_direction=scalar(2, torch.int32),
        cooldown=scalar(0.0, F32),
        total_read=scalar(0.0, F32),
        total_write=scalar(0.0, F32),
        switches=scalar(0, torch.int32),
    )


class ChannelParams(NamedTuple):
    """ChannelModel lowered to float32 scalar tensors for the simulator;
    ``duplex`` stays a Python bool, so ``channel_step`` picks its branch
    on the host (the reference's ``lax.cond`` on a static value)."""
    read_cap: torch.Tensor    # bytes per step
    write_cap: torch.Tensor
    duplex: bool
    coupling: torch.Tensor    # float32
    turnaround_frac: torch.Tensor  # turnaround as fraction of one step


def channel_params(channel: ChannelModel, sequential: bool = False,
                   device: torch.device | str = "cpu") -> ChannelParams:
    rc, wc = channel.bytes_per_step(sequential)

    def scalar(v):
        return torch.full((), v, dtype=F32, device=device)

    return ChannelParams(
        read_cap=scalar(rc),
        write_cap=scalar(wc),
        duplex=bool(channel.duplex),
        coupling=scalar(channel.duplex_coupling),
        turnaround_frac=scalar(channel.turnaround_ns / STEP_NS),
    )


def channel_step(params: ChannelParams, state: ChannelState,
                 want_read: torch.Tensor, want_write: torch.Tensor):
    """Move up to (want_read, want_write) bytes in one step.

    Returns (new_state, moved_read, moved_write).

    Full-duplex: the demand is scaled by 1/T where serving (r, w) takes
    T = max(r/Br, w/Bw) + (1-kappa)·min(r/Br, w/Bw) steps (the analytic
    curve inverted, so the step simulation saturates on it).

    Half-duplex: the bus serves one direction per step — the one with more
    demand — charging ``turnaround_frac`` of the step when the direction
    differs from the previous step.

    Only the branch of ``params.duplex`` runs; nothing is read back.
    """
    want_read = torch.clamp(want_read, min=0.0)
    want_write = torch.clamp(want_write, min=0.0)
    zero_i = torch.zeros_like(state.switches)
    if params.duplex:
        r_occ = want_read / params.read_cap
        w_occ = want_write / params.write_cap
        leak = 1.0 - params.coupling
        T = (torch.maximum(r_occ, w_occ)
             + leak * torch.minimum(r_occ, w_occ))
        scale = torch.where(T > 1.0, torch.ones_like(T)
                            / torch.clamp(T, min=1e-9), 1.0)
        moved_r = want_read * scale
        moved_w = want_write * scale
        new_dir = torch.where(moved_r + moved_w > 0.0, zero_i, zero_i + 2)
        cooldown = torch.zeros_like(state.cooldown)
        switch = zero_i
    else:
        serve_read = want_read >= want_write
        new_dir = torch.where(serve_read, zero_i, zero_i + 1)
        switched = (state.last_direction != 2) & \
            (new_dir != state.last_direction)
        budget = torch.clamp(
            1.0 - state.cooldown
            - torch.where(switched, params.turnaround_frac, 0.0), 0.0, 1.0)
        moved_r = torch.where(
            serve_read, torch.minimum(want_read, params.read_cap * budget),
            0.0)
        moved_w = torch.where(
            serve_read, 0.0,
            torch.minimum(want_write, params.write_cap * budget))
        idle = (moved_r + moved_w) <= 0.0
        new_dir = torch.where(idle, state.last_direction, new_dir)
        cooldown = torch.zeros_like(state.cooldown)
        switch = (switched & ~idle).to(torch.int32)

    new_state = ChannelState(
        last_direction=new_dir,
        cooldown=cooldown,
        total_read=state.total_read + moved_r,
        total_write=state.total_write + moved_w,
        switches=state.switches + switch,
    )
    return new_state, moved_r, moved_w
