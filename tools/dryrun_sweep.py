"""Every runnable dry-run cell on both production meshes, one process of
the dry-run CLI a cell (``python -m repro_torch.launch.dryrun --arch A
--shape S --mesh both``), several at a time: the records land in
``experiments/dryrun_torch/`` as ``--all --mesh both`` writes them, in a
fraction of its wall time. Host only (no device).

    python tools/dryrun_sweep.py [WORKERS]     # default 6

Prints each cell's status lines and exit code, then the count of cells
whose CLI failed; exits 1 if any did. ``SWEEP_OUT=DIR`` also copies the
records to DIR.
"""

import glob
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import registry as R  # noqa: E402


def one(cell):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "both"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    lines = [x for x in p.stdout.splitlines() if x.startswith("[")]
    return cell, p.returncode, time.monotonic() - t0, lines


def main() -> int:
    workers = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    t0 = time.monotonic()
    # the train cells take longest: start them first
    cells = sorted(R.cells(), key=lambda c: (c[1] != "train_4k", c))
    with ThreadPoolExecutor(workers) as ex:
        results = list(ex.map(one, cells))
    failed = 0
    for cell, rc, secs, lines in results:
        print(f"{cell[0]} x {cell[1]}: rc={rc} {secs:.1f}s")
        for line in lines:
            print("  " + line)
        failed += rc != 0
    out = os.environ.get("SWEEP_OUT")
    if out:
        os.makedirs(out, exist_ok=True)
        for f in glob.glob(str(ROOT / "experiments" / "dryrun_torch" /
                               "*.json")):
            shutil.copy(f, out)
    print(f"cells {len(results)} failed {failed} wall "
          f"{time.monotonic() - t0:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
