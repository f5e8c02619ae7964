"""Training CLI (port of ``repro/launch/train.py``, flag for flag,
plus ``--device``).

Runs the SMOKE config of any arch end to end by default (data pipeline,
optimizer, checkpointing, fault handling), ``--full`` the published
widths. Runs on the GPU; ``--device cpu`` is the only way onto the CPU.
Weights are random, from ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --seq-len 128 --global-batch 8 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import TrainConfig, Trainer


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=configs_lib.ARCH_IDS,
                   default="smollm-135m")
    p.add_argument("--full", action="store_true",
                   help="full config (default: smoke)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--host-optimizer", action="store_true",
                   help="Adam moments in the host pool (duplex-streamed)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args()

    device = resolve_device(args.device)
    api = R.build(args.arch, smoke=not args.full, device=device)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={args.arch} params={api.param_count/1e6:.2f}M "
          f"(active {api.active_param_count/1e6:.2f}M) "
          f"devices={devices}")

    extras = {}
    if api.family == "audio":
        extras = {"frames": torch.zeros(
            (args.global_batch, args.seq_len, api.cfg.d_model),
            dtype=torch.bfloat16, device=device)}
    if api.family == "vlm":
        extras = {"prefix_embeds": torch.zeros(
            (args.global_batch, api.cfg.prefix_len, api.cfg.d_model),
            dtype=torch.bfloat16, device=device)}

    cfg = TrainConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        steps=args.steps, seed=args.seed, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        optimizer_placement="host" if args.host_optimizer else "device",
        optim=AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps),
    )
    trainer = Trainer(api, cfg, extras_fn=lambda: extras)

    params = opt_state = None
    start = 0
    if args.resume and args.ckpt_dir:
        (params, opt_state), start = trainer.restore()
        print(f"resumed from step {start}")

    params, opt_state, history = trainer.run(params, opt_state, start)
    for h in history[:3] + history[-3:]:
        print(json.dumps(h))
    if trainer.host_opt is not None:
        print("host-optimizer link report:",
              json.dumps(trainer.host_opt.last_transfer_report))
    print(f"final loss {history[-1]['loss']:.4f} "
          f"({len(trainer.retried_steps)} retries, "
          f"{len(trainer.straggler_steps)} straggler steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
