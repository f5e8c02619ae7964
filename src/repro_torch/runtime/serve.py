"""Deprecation shims over the ``repro_torch.serve`` subsystem (port of
``repro/runtime/serve.py``).

The serving stack lives in ``repro_torch.serve``: ``ServeEngine`` is the
continuous-batching step-loop engine and ``PagedKVPool`` the duplex-paged
block pool. This module keeps the older import surface working:

  * ``DecodeServer.generate`` — a thin wrapper that runs a fresh
    ``ServeEngine`` with every prompt arriving at step 0 (the static-batch
    special case of continuous batching);
  * ``OffloadedKVCache`` — adapter exposing the old per-block
    ``touch``/``write_block``/``read_block`` API on top of ``PagedKVPool``
    (batched planning, one fused kernel per transaction).

Both warn with ``DeprecationWarning`` at the caller's line. New code
should import from ``repro_torch.serve`` directly.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.hints import HintTree
from repro_torch.models.registry import ModelAPI
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.kv_pool import PagedKVPool, _fresh_stats

__all__ = ["DecodeServer", "OffloadedKVCache", "ServeConfig"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Legacy serving config (mapped onto ``serve.EngineConfig``)."""
    max_batch: int = 8
    cache_len: int = 256
    block_tokens: int = 16          # KV page granularity
    hbm_blocks: int = 8             # resident working set (per sequence)
    greedy: bool = True
    seed: int = 0


class OffloadedKVCache:
    """Deprecated per-block adapter over ``serve.PagedKVPool``.

    HBM working set, int8 host pool, duplex-planned paging: residency,
    the slot map and LRU clocks are the pool's block table, and each
    ``touch`` is one batched pool transaction (single plan, single fused
    kernel). Runs on the GPU unless given ``device="cpu"``.
    """

    def __init__(self, n_blocks: int, hbm_blocks: int, block_shape,
                 hints: HintTree | None = None,
                 device: torch.device | str = "cuda"):
        warnings.warn(
            "repro_torch.runtime.serve.OffloadedKVCache is deprecated; use "
            "repro_torch.serve.PagedKVPool (batched step()/write()/read()) "
            "directly", DeprecationWarning, stacklevel=2)
        self.pool = PagedKVPool(n_blocks, hbm_blocks, block_shape,
                                hints=hints, device=device)
        self.n_blocks = n_blocks
        self.hbm_capacity = hbm_blocks
        self.block_shape = tuple(block_shape)
        self.engine = self.pool.engine

    # -- legacy views ------------------------------------------------------
    @property
    def resident(self) -> dict[int, int]:
        """logical block -> HBM slot, as the old dict view (the pool's
        block table is host numpy — no device round-trip here)."""
        slot_of = self.pool.slot_of
        return {int(b): int(slot_of[b])
                for b in np.flatnonzero(slot_of >= 0)}

    @property
    def lru(self) -> list[int]:
        """Resident blocks, least-recently-used first."""
        res = self.pool.resident_blocks()
        clocks = self.pool.last_use[res]
        return res[np.argsort(clocks, kind="stable")].tolist()

    @property
    def hbm(self) -> torch.Tensor:
        return self.pool.hbm

    @property
    def stats(self) -> dict:
        return self.pool.stats

    @stats.setter
    def stats(self, value: dict) -> None:
        fresh = _fresh_stats()
        fresh.update(value)
        self.pool.stats = fresh

    # -- legacy operations -------------------------------------------------
    def touch(self, needed) -> None:
        self.pool.step(needed)

    def write_block(self, logical: int, data) -> None:
        self.pool.step([logical])
        self.pool.write([logical], torch.as_tensor(
            data, device=self.pool.device)[None])

    def read_block(self, logical: int) -> torch.Tensor:
        self.pool.step([logical])
        return self.pool.read([logical])[0]

    def duplex_speedup(self) -> float:
        return self.pool.duplex_speedup()


class DecodeServer:
    """Deprecated static-batch front end over ``serve.ServeEngine``, on
    the model's device."""

    def __init__(self, api: ModelAPI, params, cfg: ServeConfig):
        warnings.warn(
            "repro_torch.runtime.serve.DecodeServer is deprecated; drive "
            "repro_torch.serve.ServeEngine (submit()/run()) directly",
            DeprecationWarning, stacklevel=2)
        self.api = api
        self.params = params
        self.cfg = cfg
        self.last_stats: dict | None = None

    def generate(self, prompts, num_tokens: int,
                 extras: dict | None = None) -> torch.Tensor:
        """prompts: (B, P) ints. Returns (B, num_tokens) generated ids on
        the model's device."""
        if not self.cfg.greedy or self.cfg.seed != 0 or extras:
            raise NotImplementedError(
                "the DecodeServer shim only supports greedy decoding "
                "(greedy=True, seed=0) with no extras; drive "
                "repro_torch.serve.ServeEngine directly for anything else")
        prompts = np.asarray(torch.as_tensor(prompts).cpu())
        B, P = prompts.shape
        per_seq = -(-self.cfg.cache_len // self.cfg.block_tokens)
        ecfg = EngineConfig(
            max_batch=B,
            cache_len=self.cfg.cache_len,
            block_tokens=self.cfg.block_tokens,
            hbm_blocks=min(self.cfg.hbm_blocks * B, per_seq * B),
            prefill_chunk=4,
            max_queue=B,
            device=str(self.api.device),
        )
        engine = ServeEngine(self.api, self.params, ecfg)
        rids = [engine.submit(prompts[i], num_tokens).rid
                for i in range(B)]
        outs = engine.run()
        self.last_stats = engine.paging_stats()
        return torch.as_tensor(np.stack([outs[r] for r in rids]),
                               device=self.api.device)
