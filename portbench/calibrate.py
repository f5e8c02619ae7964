"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--out FILE]

For each seed, one run of the cell as ``run.py`` makes it (the same
weights from the seed, engine, closed loop and window), judged by the
reference, and then the control: the reference computed in fp8 at the
same positions of the same sequences (and, where the cell judges paged
blocks, its keys and values in their place). Prints one JSON line per
seed: the program's numbers and the control's. The limits in
``workloads/<cell>.json`` lie between the largest program reading and
the smallest control reading (PERF.md gives both).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench.setup_paths()
    import torch

    from portbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        bench.log("calibrate runs on the card")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = bench.run_cell(cell, seed, args.seconds, False, "cuda", t,
                             control=True)
        line = {"workload": cell.name, "seed": seed,
                "card": card.strip(), "correct": out["correct"],
                "program": {k: c["value"] for k, c in out["checks"].items()},
                "control": out["control"], "metrics": out["metrics"],
                "peak_bytes": out["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
