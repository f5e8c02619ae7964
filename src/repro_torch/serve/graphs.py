"""CUDA graphs of the engine step — the port of ``_fused_megastep_program``
(``repro/serve/engine.py``).

The reference jits ``_megastep_math`` into one buffer-donated XLA program
per (api, prefill_chunk, K, block_tokens) and shares it across engines
with an ``lru_cache``. Here the unit is one engine step: ``StepGraphs``
captures one ``torch.cuda.CUDAGraph`` per count m of active micro-steps
(0 .. prefill_chunk; the host knows m for every inner step), each holding
m micro-steps — a ``decode_step`` and the argmax feedback — and, when the
engine pages, the extraction of the blocks the step filled. A K-step
megastep is K replays. The graphs are bound to one engine's buffers, so
each engine holds its own: at most prefill_chunk + 1, sharing one memory
pool, all captured when the engine is built. ``decode_step`` runs only
then: once on copies of the state (the warm-up, on a side stream), once
under capture.

The engine's cache and slot-state tensors are the graphs' static inputs
and are updated in place, the counterpart of the reference's donation: a
captured step ends by copying its new slot state into the static
tensors. A replay overwrites the graph's outputs, and the graphs share a
pool (one graph's temporaries may lie under another's outputs), so
``step`` copies the step's sampled tokens and staged blocks out, in
stream order, before any other replay. A capture or a replay that fails
raises; nothing falls back to the eager megastep.

Without ``capture`` (the CPU) a "replay" calls the step function directly
on the same static tensors, so the bookkeeping runs where the tests do.
"""

from __future__ import annotations

import gc
import time

import torch

from repro_torch.models import layers as nn

# the slot-state leaves an engine step changes; the rest are read-only
STEP_LEAVES = ("state", "tok", "consumed", "n_gen")


class StepGraphs:
    """The engine steps of one engine, captured per active micro-step
    count. ``step_fn(params, cache, dev, m) -> (new dev, staged or
    None)`` is the step's math; ``cache`` and ``dev`` are the engine's
    static tensors."""

    def __init__(self, step_fn, params, cache: dict, dev: dict,
                 n_micro: int, extract: bool, capture: bool):
        self._step_fn = step_fn
        self._params, self._cache, self._dev = params, cache, dev
        # a step with no active micro-step and nothing to extract does no
        # work: it gets no graph (CUDA refuses to replay an empty one)
        self.keys = tuple(range(0 if extract else 1, n_micro + 1))
        self.captured = capture
        self._graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self._staged: dict[int, torch.Tensor | None] = {}
        self.capture_s = 0.0
        if capture:
            t0 = time.perf_counter()
            self._capture_all()
            self.capture_s = time.perf_counter() - t0

    def __len__(self) -> int:
        return len(self._graphs)

    def _run(self, m: int, cache: dict, dev: dict):
        new, staged = self._step_fn(self._params, cache, dev, m)
        for key in STEP_LEAVES:
            dev[key].copy_(new[key])
        return staged

    def _capture_all(self) -> None:
        # the warm-up is a real step, so it runs on copies of the state
        cache = nn.tree_map(torch.clone, self._cache)
        dev = {k: v.clone() for k, v in self._dev.items()}
        pool = torch.cuda.graph_pool_handle()
        # a dead engine's graphs freed by the cycle collector in the middle
        # of a capture would be destroyed while the stream captures, which
        # CUDA refuses (torch.cuda.graph no longer collects first): collect
        # now and keep the collector off until the captures are done
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for m in self.keys:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._run(m, cache, dev)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    self._staged[m] = self._run(m, self._cache, self._dev)
                self._graphs[m] = graph
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()

    def step(self, m: int):
        """One engine step of ``m`` active micro-steps on the static
        state: copies of its sampled tokens (B,) and of its staged blocks
        (None when the engine does not page)."""
        if m not in self.keys:
            if m != 0:
                raise ValueError(f"no engine step of {m} micro-steps: "
                                 f"the steps are {self.keys}")
            staged = None
        elif self.captured:
            self._graphs[m].replay()
            staged = self._staged[m]
        else:
            staged = self._run(m, self._cache, self._dev)
        return (self._dev["tok"].clone(),
                None if staged is None else staged.clone())
