"""Workload request-stream generators (CXLAimPod §3.1 microbenchmark).

Port of ``repro/core/requests.py``. A *stream* is one logical traffic
source described statically by ``StreamSpec`` and realized as per-step
arrival arrays ``(T, n_streams, 2)`` of offered read/write bytes.

Generators cover the paper's evaluation patterns:
  * ``uniform``      — steady offered load at a fixed R/W ratio (§3.2 sweep).
  * ``phased``       — long alternating read phases / write phases
                       ("sequential Redis": unidirectional *per phase*,
                       balanced only if co-scheduled).
  * ``pipelined``    — short alternating bursts (Redis pipeline).
  * ``gaussian``     — random per-step ratio jitter (Redis gaussian).
  * ``llm_decode``   — attention phase (85% read) alternating with FFN phase
                       (60/40) per §6.4's layer traffic analysis.
  * ``hnsw``         — read-dominated graph walk with write bursts for
                       distance-cache/result aggregation (§6.5).

This is host data (the KV-store tenant turns it into float64 at once), so
it is numpy float32 with the reference's float32 roundings: ``uniform``,
``phased``, ``pipelined``, ``llm_decode`` and ``hnsw`` are bit-equal to the
reference. ``gaussian`` jitters with ``jax.random.normal`` there; here it
draws the same threefry bits from the same keys (``core/prng.py``:
``key(seed)``, ``fold_in(key, i)`` for stream ``i``, ``fold_in(.., 1)``
for the load), and its normals are within a few float32 ulps of JAX's
(the last bits of XLA's ``erf_inv``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import prng
from repro_torch.core.hints import MemoryHint

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of one traffic stream."""
    name: str
    pattern: str                  # generator key, see PATTERNS
    offered_gbps: float           # total offered load
    read_fraction: float = 0.5    # by bytes
    phase_steps: int = 64         # phase length for phased/pipelined/llm
    block_bytes: float = 4096.0
    sequential: bool = False
    hint: MemoryHint | None = None

    def resolved_hint(self) -> MemoryHint:
        if self.hint is not None:
            return self.hint
        return MemoryHint(read_fraction=self.read_fraction,
                          sequential=self.sequential)


def _offered_bytes_per_step(spec: StreamSpec) -> float:
    # 1 step == 1 us (channel.STEP_NS); GB/s -> bytes/us == 1e3 * GB/s.
    return spec.offered_gbps * 1.0e3


def _uniform(spec: StreamSpec, steps: int, key) -> np.ndarray:
    per = _offered_bytes_per_step(spec)
    reads = np.full((steps,), f32(per * spec.read_fraction))
    writes = np.full((steps,), f32(per * (1.0 - spec.read_fraction)))
    return np.stack([reads, writes], axis=-1)


def _phased(spec: StreamSpec, steps: int, key) -> np.ndarray:
    """Alternating unidirectional phases — sequential scan then writeback."""
    per = f32(_offered_bytes_per_step(spec))
    t = np.arange(steps)
    in_read_phase = (t // spec.phase_steps) % 2 == 0
    # read_fraction sets the duty cycle split between the two phases.
    reads = (np.where(in_read_phase, per, f32(0.0))
             * f32(2.0 * spec.read_fraction))
    writes = (np.where(in_read_phase, f32(0.0), per)
              * f32(2.0 * (1.0 - spec.read_fraction)))
    return np.stack([reads, writes], axis=-1).astype(np.float32)


def _pipelined(spec: StreamSpec, steps: int, key) -> np.ndarray:
    """Short alternating bursts (default 16-deep command pipeline)."""
    short = dataclasses.replace(spec, phase_steps=max(2, spec.phase_steps // 8))
    return _phased(short, steps, key)


def _gaussian(spec: StreamSpec, steps: int, key) -> np.ndarray:
    """Random per-step ratio and load jitter (threefry draws; see module
    docstring)."""
    per = f32(_offered_bytes_per_step(spec))
    jitter = f32(0.25) * prng.normal(key, (steps,))
    rf = np.clip(f32(spec.read_fraction) + jitter, f32(0.0), f32(1.0))
    load = per * np.clip(
        f32(1.0) + f32(0.25) * prng.normal(prng.fold_in(key, 1), (steps,)),
        f32(0.25), f32(2.0))
    return np.stack([load * rf, load * (f32(1.0) - rf)], axis=-1)


def _llm_decode(spec: StreamSpec, steps: int, key) -> np.ndarray:
    """§6.4: attention layers ~85% reads, FFN layers 60/40, alternating."""
    per = f32(_offered_bytes_per_step(spec))
    t = np.arange(steps)
    attn_phase = (t // spec.phase_steps) % 2 == 0
    rf = np.where(attn_phase, f32(0.85), f32(0.60))
    return np.stack([per * rf, per * (f32(1.0) - rf)], axis=-1)


def _hnsw(spec: StreamSpec, steps: int, key) -> np.ndarray:
    """Graph traversal reads with periodic result/cache write bursts."""
    per = f32(_offered_bytes_per_step(spec))
    t = np.arange(steps)
    burst = (t % spec.phase_steps) >= (spec.phase_steps * 3) // 4
    rf = np.where(burst, f32(0.45), f32(0.92))
    return np.stack([per * rf, per * (f32(1.0) - rf)], axis=-1)


PATTERNS: dict[str, Callable[[StreamSpec, int, np.ndarray],
                             np.ndarray]] = {
    "uniform": _uniform,
    "phased": _phased,
    "pipelined": _pipelined,
    "gaussian": _gaussian,
    "llm_decode": _llm_decode,
    "hnsw": _hnsw,
}


def generate(specs: list[StreamSpec], steps: int, seed: int = 0
             ) -> np.ndarray:
    """Arrival array of shape (steps, n_streams, 2) [read, write] bytes,
    float32."""
    key = prng.key(seed)
    cols = []
    for i, spec in enumerate(specs):
        gen = PATTERNS[spec.pattern]
        cols.append(gen(spec, steps, prng.fold_in(key, i)))
    return np.stack(cols, axis=1).astype(np.float32)


def hint_read_fractions(specs: list[StreamSpec]) -> np.ndarray:
    """Per-stream declared read fraction (the cgroup hint, Section 4.5)."""
    return np.asarray([s.resolved_hint().read_fraction for s in specs],
                      dtype=np.float32)


# Convenience mixes used by the tenants ------------------------------------

def redis_pattern_specs(pattern: str, offered_gbps: float = 60.0,
                        n_streams: int = 8) -> list[StreamSpec]:
    """The five Redis patterns of Fig. 5 as stream mixes."""
    table = {
        # name -> (generator, read_fraction)
        "read_heavy":  ("uniform", 10.0 / 11.0),   # 1:10 SET:GET
        "write_heavy": ("uniform", 1.0 / 11.0),    # 10:1
        "pipelined":   ("pipelined", 0.5),
        "sequential":  ("phased", 0.5),
        "gaussian":    ("gaussian", 0.5),
    }
    gen, rf = table[pattern]
    per = offered_gbps / n_streams
    # Phase-correlated patterns (all clients sweep/flush together, as in
    # memtier's sequential and pipelined modes) share one phase clock —
    # the lockstep case where fair scheduling keeps the aggregate
    # unidirectional. Random patterns get per-stream jitter.
    correlated = pattern in ("sequential", "pipelined")
    return [
        StreamSpec(name=f"{pattern}-{i}", pattern=gen, offered_gbps=per,
                   read_fraction=rf,
                   phase_steps=64 if correlated else 64 + 8 * (i % 4),
                   sequential=(pattern == "sequential"))
        for i in range(n_streams)
    ]
