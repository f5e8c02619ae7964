"""Deterministic, shard-aware synthetic LM data pipeline.

Copy of ``repro/data/pipeline.py``'s numpy code (the port keeps its own,
so it never imports the JAX package): batch ``step`` for data-parallel
rank ``(r, n)`` is a pure function of (seed, step, r, n), so restarts
and elastic resharding never lose or duplicate data, ranks derive
disjoint slices of the global batch by construction, and the token
streams are Zipf-ish over the vocab with EOS-terminated documents packed
back to back, labels the next token. The batches are bit-equal to the
reference's. ``device_batch`` hands them to the model as torch tensors
on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import to_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 256
    eos_id: int = 0


def _fold(*ints: int) -> np.random.Generator:
    """Deterministic generator from a tuple of ints (splitmix-style)."""
    h = np.uint64(0x9E3779B97F4A7C15)
    acc = np.uint64(0)
    for x in ints:
        acc = (acc ^ np.uint64(x & 0xFFFFFFFFFFFFFFFF)) * h
        acc ^= acc >> np.uint64(31)
    return np.random.default_rng(int(acc))


def _sample_sequence(cfg: DataConfig, rng: np.random.Generator) -> np.ndarray:
    """One packed row of seq_len+1 tokens (docs separated by EOS)."""
    out = np.empty(cfg.seq_len + 1, np.int32)
    pos = 0
    while pos < cfg.seq_len + 1:
        doc_len = max(1, int(rng.geometric(1.0 / cfg.mean_doc_len)))
        doc_len = min(doc_len, cfg.seq_len + 1 - pos)
        # Zipf-ish marginal over the vocab (heavy head like natural text)
        toks = rng.zipf(1.3, size=doc_len).astype(np.int64)
        toks = (toks % (cfg.vocab - 1)) + 1          # reserve 0 for EOS
        out[pos: pos + doc_len] = toks
        pos += doc_len
        if pos < cfg.seq_len + 1:
            out[pos] = cfg.eos_id
            pos += 1
    return out


def make_batch(cfg: DataConfig, step: int, dp_rank: int = 0,
               dp_size: int = 1) -> dict[str, np.ndarray]:
    """The dp_rank-th slice of global batch ``step`` (pure function)."""
    if cfg.global_batch % dp_size:
        raise ValueError(f"global_batch {cfg.global_batch} not divisible by "
                         f"dp_size {dp_size}")
    per = cfg.global_batch // dp_size
    rows = []
    for i in range(per):
        global_row = dp_rank * per + i
        rng = _fold(cfg.seed, step, global_row)
        rows.append(_sample_sequence(cfg, rng))
    packed = np.stack(rows)                           # (per, S+1)
    return {"tokens": packed[:, :-1].astype(np.int32),
            "labels": packed[:, 1:].astype(np.int32)}


class SyntheticLMData:
    """Iterator facade with explicit step addressing (for resume)."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.step, self.dp_rank, self.dp_size)
        self.step += 1
        return batch

    def peek(self, step: int) -> dict[str, np.ndarray]:
        return make_batch(self.cfg, step, self.dp_rank, self.dp_size)


def device_batch(batch: dict[str, np.ndarray], extras: dict | None,
                 device: torch.device | str) -> dict:
    """The numpy batch as tensors on ``device`` (a CUDA copy goes through
    pinned memory, ``device.to_device``), with ``extras`` (tensors already
    on the device: the audio frames, the VLM prefix) added."""
    dev = torch.device(device)
    out = {k: to_device(np.ascontiguousarray(v), dev)
           for k, v in batch.items()}
    if extras:
        out.update(extras)
    return out
