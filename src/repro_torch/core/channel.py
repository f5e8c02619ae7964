"""Channel models for duplex-aware memory scheduling (CXLAimPod §2-§3).

The pure-Python subset of ``repro/core/channel.py``: the static
``ChannelModel`` (with ``degraded``, the fault layer's bandwidth cut),
its calibrated presets, the host-tier spec parser, and the scalar
effective-bandwidth curve the serving path bills with. Link timing in the
port is modelled, exactly as in the reference, so these are plain float
arithmetic and reproduce the reference's numbers bit for bit. The
vectorized ``effective_bandwidth`` and the step-wise ``channel_step``
state machine (the scheduler simulator's) are not ported yet.

Units: bandwidth in GB/s (1e9 bytes/s); latency/turnaround in nanoseconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BYTES_PER_GB = 1.0e9


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


def peak_read_fraction(channel: ChannelModel) -> float:
    """The read fraction at which the channel moves the most bytes: the
    ``peak_read_fraction`` of the reference's ``duplex_benefit``, over the
    same 101-point float32 grid (first maximum wins)."""
    rs = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    bws = [effective_bandwidth_scalar(channel, float(r)) for r in rs]
    return float(rs[int(np.argmax(bws))])
