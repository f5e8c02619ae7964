"""Typed metrics registry + THE unified serving-stats schema.

Port of ``repro/core/metrics.py`` (pure Python, copied: the port imports
nothing of the JAX package).

``MetricsRegistry`` is the typed face over the serving stack's ad-hoc
``stats()`` / ``paging_stats()`` dicts: counters (monotonic),
gauges (last value wins) and histograms (power-of-two buckets), each
addressed by a flat dotted name. ``ServeEngine.metrics()`` builds one
per call — counters and gauges from the stats dicts, histograms from
the tracer's boundary spans (when tracing is on), and the engine's
``CaxRegistry`` scope tree under ``"cax"`` — so every consumer (the
serve CLI's ``--telemetry`` report, the benchmarks' BENCH sections, a
future cluster router) reads ONE snapshot shape instead of key-guarding
three dict families.

Unified stats schema
--------------------
This is the single place the ``paging_stats()`` schema is documented;
flat and tiered pools emit the SAME keys (flat pools zero the tier
fields), so consumers never key-guard on the pool flavor:

==========================  =============================================
key                         meaning
==========================  =============================================
``paged``                   bool — False short-circuits to engine stats
``steps``                   engine steps run (engine clock)
``paging_steps``            pool paging transactions
``host_dispatches``         fused step-program launches (dispatch tax)
``megasteps``               boundary count
``host_blocked``            boundaries reconciled with nothing in flight
                            (pipeline bubbles)
``page_ins``/``page_outs``  real block transfers (billed traffic only)
``duplex_us``/``serial_us`` modelled link time, co-issued vs
                            phase-separated
``duplex_speedup``          serial_us / duplex_us (1.0 when no traffic)
``kernel_calls``            stream-kernel invocations
``migrations``              boundary tier moves (0 on flat pools)
``migrate_us``              half-duplex migration time (0.0 flat)
``tier_us``/``ddr5_us``     tiered billed time vs the all-DDR5 serial
                            counterfactual (0.0 flat)
``tiers``                   ``tier_stats()``: ``{"tiered": bool,
                            "channels": {name: per-channel totals},
                            "migrations", "migrate_us", "tier_us",
                            "ddr5_us", "tier_speedup"}`` — ALWAYS
                            present; flat pools report their single
                            channel with the tier fields zeroed
``tier_speedup``            ddr5_us / tier_us (1.0 flat / no traffic)
``by_path``                 per-hint-scope billing (page counts, duplex/
                            serial time, fused_calls, duplex_speedup)
``faults``/``snapshot``     the injector / snapshot counter dicts
``tenants``                 per-WorkloadAPI tenant stats (when attached)
``mesh``/``ici``            sharded engines only: mesh axis sizes + the
                            ``IciMeter`` summary
==========================  =============================================

Sections that land in ``BENCH_serve.json`` additionally carry
``phase_us`` (plan/dispatch/reconcile host-clock totals from the trace
plane) and ``duplex_util.<channel>`` (per-channel busy fraction of the
modelled transaction clock) — see README "Observability".
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Counter:
    """Monotonic count — resets only with the registry."""
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += v


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value."""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Power-of-two-bucketed distribution (for span durations etc.).

    Buckets are ``[0, 1), [1, 2), [2, 4), ... [2^(n-1), inf)`` in the
    observed unit; ``snapshot()`` reports count/sum/min/max plus the
    non-empty buckets keyed by their inclusive upper bound (``"inf"``
    for the overflow bucket) — enough to eyeball a latency shape
    without a full reservoir.
    """

    N_BUCKETS = 32

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * self.N_BUCKETS

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        i = 0 if v < 1.0 else min(self.N_BUCKETS - 1,
                                  1 + int(math.log2(v)))
        self.buckets[i] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "buckets": {}}
        out = {}
        for i, n in enumerate(self.buckets):
            if n:
                le = "inf" if i == self.N_BUCKETS - 1 else str(2 ** i)
                out[le] = n
        return {"count": self.count, "sum": round(self.sum, 3),
                "min": round(self.min, 3), "max": round(self.max, 3),
                "mean": round(self.mean, 3), "buckets": out}


class MetricsRegistry:
    """Create-or-get registry of named Counters/Gauges/Histograms.

    A name owns its first-registered type forever (re-registering under
    another type raises — the schema is the contract). ``snapshot()``
    renders plain JSON-able dicts; ``reset()`` drops every instrument.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not a "
                f"{cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- convenience ---------------------------------------------------------
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counter(name).inc(v)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def ingest(self, prefix: str, stats: dict) -> None:
        """Flatten one ad-hoc stats dict into typed instruments:
        ints become counters, floats gauges, nested dicts recurse under
        ``prefix.key``. Non-numeric leaves are skipped — the registry
        carries measurements, not labels."""
        for k, v in stats.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, bool):
                continue
            if isinstance(v, int):
                c = self.counter(name)
                c.value = float(v)          # absolute, not incremental
            elif isinstance(v, float):
                self.set(name, v)
            elif isinstance(v, dict):
                self.ingest(name, v)

    def snapshot(self) -> dict:
        """One JSON-able view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}``, names sorted."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                v = m.value
                out["counters"][name] = (int(v) if float(v).is_integer()
                                         else round(v, 3))
            elif isinstance(m, Gauge):
                out["gauges"][name] = round(m.value, 6)
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def reset(self) -> None:
        self._metrics.clear()
