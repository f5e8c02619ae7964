"""The port's examples (ports of the reference's ``examples/``), each run
as ``python -m repro_torch.examples.<name>``:

  quickstart         — the paper's result in three acts: the channel's
                       duplex benefit, the scheduler A/B, train + serve
  duplex_tour        — every layer of the idea, from the channel physics
                       to the CUDA duplex kernel and the moment stream
  serve_offload      — continuous batching over the duplex-paged pool
  multi_tenant_serve — LLM decode, a KV store and a vector search on one
                       pool
  train_smollm       — a ~10M-parameter model through ``Trainer`` with
                       checkpoints and an injected fault

Each takes ``--device`` (default ``cuda``, which raises without a GPU, as
the CLIs do; ``--device cpu`` runs it on the CPU). Their bodies are
functions of the model API and its weights, so a caller can hand them
any weights.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from repro_torch.device import resolve_device


def parse_device(doc: str, argv=None, parser=None):
    """Parse ``argv`` with ``--device`` added to ``parser``; returns
    (args, device). Raises without a GPU unless told ``--device cpu``."""
    p = parser or argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return args, resolve_device(args.device)


def device_line(device: torch.device) -> str:
    """The device, and on a GPU the card's name and power limit as
    ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    card = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return f"{device} ({card})"
