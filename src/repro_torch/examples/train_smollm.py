"""End-to-end training driver: a ~10M-param smollm-family model for a few
hundred steps with checkpoint/restart and a mid-run injected fault (port
of ``examples/train_smollm.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_smollm \
          [--steps 300] [--device cpu]
(the same Trainer runs the full 135M config unchanged through
``python -m repro_torch.launch.train --full``.)
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.examples import parse_device
from repro_torch.models.registry import _lm_api
from repro_torch.models.transformer import LMConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train import FaultInjector, TrainConfig, Trainer

# a mid-size smollm-family config (~10M params) that trains visibly on CPU
MID = LMConfig(name="smollm-10m", num_layers=4, d_model=192, num_heads=6,
               num_kv_heads=2, d_ff=512, vocab=4096, tie_embeddings=True)


def train(api, steps: int, seq_len: int, global_batch: int,
          params=None) -> tuple[Trainer, list]:
    """``steps`` steps from ``params`` (or the trainer's seed-0 weights),
    checkpoints every 100 steps into a temporary directory, a transient
    fault injected at ``steps // 2``. Returns the trainer and its
    history."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = TrainConfig(
            seq_len=seq_len, global_batch=global_batch,
            steps=steps, ckpt_every=100, ckpt_dir=ckpt_dir,
            optim=AdamWConfig(peak_lr=1e-3, warmup_steps=20,
                              total_steps=steps))
        trainer = Trainer(api, cfg, fault_injector=FaultInjector(
            fail_steps=(steps // 2,)))     # mid-run transient fault
        opt = None if params is None else adamw_init(params)
        _, _, hist = trainer.run(params, opt)
    return trainer, hist


def report(trainer: Trainer, hist: list) -> tuple[float, float]:
    """Print the mean loss of the first and last 10 steps, the retries
    and the stragglers; returns the two means."""
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    print(f"loss: first10={first:.3f}  last10={last:.3f}  "
          f"(delta {last - first:+.3f})")
    print(f"fault retries: {trainer.retried_steps}  "
          f"stragglers: {trainer.straggler_steps}")
    return first, last


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    args, device = parse_device(__doc__, argv, p)

    # build the uniform ModelAPI around the mid config
    api = _lm_api("smollm-135m", MID, device)
    print(f"model: {MID.name}  params={api.param_count / 1e6:.2f}M")
    trainer, hist = train(api, args.steps, args.seq_len, args.global_batch)
    first, last = report(trainer, hist)
    if not last < first:
        raise SystemExit("loss should decrease")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
