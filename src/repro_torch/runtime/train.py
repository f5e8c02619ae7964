"""Training runtime: the step, checkpoint/restart, fault and straggler
handling, the host-offloaded optimizer (port of
``repro/runtime/train.py``).

  * **checkpoint/restart** — async sharded checkpoints every
    ``ckpt_every`` steps (``checkpoint.CheckpointManager``, the
    reference's layout); ``Trainer.restore()`` resumes params, optimizer
    and the *data cursor* (stateless pipeline addressing);
  * **step retry** — a transient fault raises ``RuntimeError`` from the
    step; the loop retries the same step with the same batch
    (deterministic data makes this loss-free), then falls back to the
    last checkpoint after ``max_retries``;
  * **straggler detection** — each step's wall time, taken after the
    device has finished it (a sync where the reference blocks until
    ready, so the step and not its dispatch is timed), feeds a sliding
    median; steps slower than ``straggler_factor`` times it are counted;
  * **elastic resume** — a restart with another ``dp_size`` re-addresses
    the batch stream with no loss or duplication.

Gradients are cast to ``grad_dtype`` (bf16 by default) as the reference
casts them before its all-reduce; the optimizer can live in the host
pool (``HostOffloadAdamW``) with duplex-planned moment streaming.

Kept as the reference has it (ROADMAP Queue 3): ``_save`` stores no host
moments, and ``restore`` evaluates ``self.host_opt._m`` eagerly as the
default of ``.get``. So with the host optimizer a rollback keeps the
current moments, and a restore before any step (``--host-optimizer
--resume`` in a fresh process) raises ``AttributeError``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMData, device_batch
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.layers import tree_map
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import (AdamWConfig, HostOffloadAdamW, adamw_init,
                               adamw_update)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 20
    seed: int = 0
    ckpt_every: int = 10
    ckpt_dir: str | None = None
    max_retries: int = 2
    straggler_factor: float = 3.0
    optimizer_placement: str = "device"    # "device" | "host"
    optim: AdamWConfig = AdamWConfig()
    dp_rank: int = 0
    dp_size: int = 1


class FaultInjector:
    """Deterministic fault/straggler injection for tests and drills."""

    def __init__(self, fail_steps: tuple[int, ...] = (),
                 slow_steps: tuple[int, ...] = (), slow_s: float = 0.05,
                 max_failures_per_step: int = 1):
        self.fail_steps = set(fail_steps)
        self.slow_steps = set(slow_steps)
        self.slow_s = slow_s
        self.max_failures = max_failures_per_step
        self.failures: dict[int, int] = {}

    def before_step(self, step: int):
        if step in self.slow_steps:
            time.sleep(self.slow_s)
        count = self.failures.get(step, 0)
        if step in self.fail_steps and count < self.max_failures:
            self.failures[step] = count + 1
            raise RuntimeError(f"injected transient fault at step {step}")


def _on_device(leaf, device: torch.device) -> torch.Tensor:
    """A checkpointed leaf (numpy, or a CPU tensor for bf16) on
    ``device``."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf))
    return t.to(device)


class Trainer:
    def __init__(self, api: ModelAPI, cfg: TrainConfig,
                 extras_fn: Callable[[], dict] | None = None,
                 fault_injector: FaultInjector | None = None):
        self.api = api
        self.cfg = cfg
        self.extras_fn = extras_fn or (lambda: {})
        self.faults = fault_injector
        self.data_cfg = DataConfig(vocab=api.cfg.vocab, seq_len=cfg.seq_len,
                                   global_batch=cfg.global_batch,
                                   seed=cfg.seed)
        self.ckpt = (CheckpointManager(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)
        self.host_opt = (HostOffloadAdamW(cfg.optim)
                         if cfg.optimizer_placement == "host" else None)
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.retried_steps: list[int] = []

    # -- step functions -------------------------------------------------------
    def _grads(self, params, batch):
        return value_and_grad(self.api.loss_fn, params, batch,
                              self.cfg.optim.grad_dtype)

    def init_state(self, generator: torch.Generator | None = None):
        """Random weights from ``generator`` (default: one on the model's
        device seeded with ``cfg.seed``) and a fresh optimizer state."""
        if generator is None:
            generator = torch.Generator(self.api.device).manual_seed(
                self.cfg.seed)
        params = self.api.init(generator)
        if self.host_opt is not None:
            opt_state = self.host_opt.init(params)
        else:
            opt_state = adamw_init(params)
        return params, opt_state

    def _one_step(self, params, opt_state, batch):
        loss, metrics, grads = self._grads(params, batch)
        if self.host_opt is None:
            params, opt_state, om = adamw_update(self.cfg.optim, params,
                                                 grads, opt_state)
        else:
            params, opt_state, om = self.host_opt.update(params, grads,
                                                         opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    def _sync(self):
        if self.api.device.type == "cuda":
            torch.cuda.synchronize(self.api.device)

    # -- checkpoint glue -------------------------------------------------------
    def _save(self, step, params, opt_state, block=False):
        if self.ckpt is None:
            return
        tree = {"params": params, "opt": opt_state}
        self.ckpt.save(step, tree,
                       metadata={"data_step": step,
                                 "dp_size": self.cfg.dp_size},
                       block=block)

    def restore(self):
        """Resume from the newest valid checkpoint; returns (state, step)."""
        tree, manifest = self.ckpt.restore()
        dev = self.api.device
        params = tree_map(lambda x: _on_device(x, dev), tree["params"])
        opt = tree_map(lambda x: _on_device(x, dev), tree["opt"])
        if self.host_opt is not None:
            # the reference's re-pinning of the host moments, with its
            # eager default (no moments are ever checkpointed)
            self.host_opt._m = tree_map(torch.as_tensor, tree["opt"].get(
                "host_m", self.host_opt._m))
            self.host_opt._v = tree_map(torch.as_tensor, tree["opt"].get(
                "host_v", self.host_opt._v))
        return (params, opt), manifest["metadata"]["data_step"]

    # -- the loop --------------------------------------------------------------
    def run(self, params=None, opt_state=None, start_step: int = 0):
        if params is None:
            params, opt_state = self.init_state()
        data = SyntheticLMData(self.data_cfg, self.cfg.dp_rank,
                               self.cfg.dp_size, start_step)
        history = []
        step = start_step
        while step < self.cfg.steps:
            raw = data.peek(step)
            batch = device_batch(raw, self.extras_fn(), self.api.device)
            attempts = 0
            while True:
                t0 = time.monotonic()
                try:
                    if self.faults is not None:
                        self.faults.before_step(step)
                    params, opt_state, metrics = self._one_step(
                        params, opt_state, batch)
                    self._sync()
                    break
                except RuntimeError:
                    attempts += 1
                    self.retried_steps.append(step)
                    if attempts > self.cfg.max_retries:
                        # unrecoverable: roll back to last checkpoint
                        (params, opt_state), step = self.restore()
                        data.step = step
                        break
            dt = time.monotonic() - t0
            self._track_straggler(step, dt)
            history.append({"step": step,
                            "loss": float(metrics["loss"]),
                            "sec": dt})
            step += 1
            if self.ckpt and step % self.cfg.ckpt_every == 0:
                self._save(step, params, opt_state)
        if self.ckpt:
            self._save(self.cfg.steps, params, opt_state, block=True)
        return params, opt_state, history

    def _track_straggler(self, step: int, dt: float):
        """Sliding-window median straggler detector (Alg 1 phase 2 shape).

        The median is robust to a slow first step (the reference's
        compile, the port's first kernel builds and allocations) that
        would poison an EWMA baseline."""
        window = self.step_times[-8:]
        self.step_times.append(dt)
        if len(window) >= 3:
            med = statistics.median(window)
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(step)
