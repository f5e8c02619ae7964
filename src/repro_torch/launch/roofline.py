"""Roofline analysis of the dry-run records: the dry-run half of
``benchmarks/roofline.py`` (``analyse``, ``load_all``) for an H100.

Three terms per (arch x shape x mesh), from a record of
``launch/dryrun.py`` (``experiments/dryrun_torch/*.json``):

    compute term    = FLOPs_per_device / PEAK_FLOPS              [s]
    memory term     = bytes_accessed_per_device / HBM_BW         [s]
    collective term = collective_bytes_per_device / LINK_BW      [s]

plus MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N_active·B
(decode), the useful-compute ratio MODEL_FLOPS / counted FLOPs, the
dominant term, the bound-MFU (useful compute time / dominant term) and a
rule-based note on what would move it.

The peaks are an NVIDIA H100 SXM's (H100 80GB HBM3 at its 700 W limit),
published: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM, 450e9 B/s of
NVLink each way. The dry-run's FLOPs already include the time
recurrences (the ``wkv6`` and ``ssd_scan`` ops' formulas), so unlike the
reference's ``analyse`` nothing adds ``recurrence_flops``; ``bytes
accessed`` counts every local op's operands and results (an upper bound
on HBM traffic: eager PyTorch fuses nothing, but L2 hits are not
subtracted).
"""

from __future__ import annotations

import glob
import json
import os

DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # bytes/s, NVLink, each way

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def analyse(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    rolled = not rec.get("unroll", True)
    n = rec["n_devices"]
    flops_dev = rec["cost_analysis"].get("flops", 0.0)
    bytes_dev = rec["cost_analysis"].get("bytes accessed", 0.0)
    coll_dev = rec["collectives"]["total_bytes"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    coll_s = coll_dev / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    useful_s = rec["model_flops"] / n / PEAK_FLOPS
    bound = max(terms.values())
    mfu_bound = useful_s / bound if bound > 0 else 0.0
    flops_ratio = rec["model_flops"] / max(flops_dev * n, 1.0)

    note = {
        "compute": ("reduce non-useful FLOPs (masked attention blocks, "
                    "remat recompute) or shard compute further"),
        "memory": ("fuse elementwise chains, keep activations on chip, "
                   "shrink dtype, or re-tile to raise arithmetic "
                   "intensity"),
        "collective": ("re-shard to cut resharding, overlap collectives "
                       "with compute, or compress (bf16/int8) payloads"),
    }[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "devices": n, "rolled": rolled,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops": rec["model_flops"],
        "useful_ratio": flops_ratio, "mfu_bound": mfu_bound,
        "note": note,
    }


def load_all(mesh: str | None = None, path: str = DRYRUN_DIR) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if mesh and rec.get("mesh") != mesh:
            continue
        row = analyse(rec)
        if row:
            out.append(row)
    return out
