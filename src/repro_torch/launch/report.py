"""The dry-run and roofline tables (the dry-run half of
``benchmarks/report.py``), printed to stdout from the records under
``experiments/dryrun_torch/``:

  python -m repro_torch.launch.report
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch import configs as configs_lib
from repro_torch.launch.roofline import DEVICE, DRYRUN_DIR, analyse
from repro_torch.models import registry as R


def _fmt_bytes(b):
    if b >= 1e12:
        return f"{b / 1e12:.2f}TB"
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b:.0f}B"


def _records(path: str = DRYRUN_DIR) -> dict:
    recs = {}
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def dryrun_table(path: str = DRYRUN_DIR) -> str:
    recs = _records(path)
    lines = [
        "| arch | shape | mesh | status | GFLOPs/dev | peak bytes/dev | "
        "collective bytes/dev (AR/AG/RS/A2A/CP) | trace s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in configs_lib.ARCH_IDS:
        for shape in R.SHAPES:
            if not R.runnable(arch, shape):
                lines.append(
                    f"| {arch} | {shape} | — | SKIP | — | — | "
                    f"{R.skip_reason(arch, shape)[:60]}… | — |")
                continue
            for mesh in ("pod", "multipod"):
                r = recs.get((arch, shape, mesh))
                if r is None:
                    lines.append(f"| {arch} | {shape} | {mesh} | pending "
                                 f"| — | — | — | — |")
                    continue
                if r["status"] != "ok":
                    lines.append(f"| {arch} | {shape} | {mesh} | "
                                 f"{r['status']} | — | — | "
                                 f"{r.get('error', '')[:60]} | — |")
                    continue
                c = r["cost_analysis"]
                co = r["collectives"]["bytes_by_op"]
                coll = "/".join(_fmt_bytes(co[k]) for k in (
                    "all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute"))
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{c.get('flops', 0) / 1e9:.1f} | "
                    f"{_fmt_bytes(r['memory_analysis']['peak_bytes'])} | "
                    f"{coll} | {r.get('trace_s', '-')} |")
    return "\n".join(lines)


def roofline_table(path: str = DRYRUN_DIR) -> str:
    lines = [
        f"Terms for an {DEVICE} (published peaks).",
        "",
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | useful ratio | bound-MFU |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    recs = _records(path)
    for key in sorted(recs):
        a = analyse(recs[key])
        if a is None:
            continue
        lines.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} | "
            f"{a['compute_s']:.3e} | {a['memory_s']:.3e} | "
            f"{a['collective_s']:.3e} | {a['dominant']} | "
            f"{a['useful_ratio']:.3f} | {a['mfu_bound']:.3f} |")
    return "\n".join(lines)


def main() -> int:
    print(dryrun_table())
    print()
    print(roofline_table())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
