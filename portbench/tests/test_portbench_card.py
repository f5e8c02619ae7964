"""On the card: each cell's control fails the limits that the program
passes, at the cell's own size and load.

For each cell and each of three seeds, one run of the cell as ``run.py``
makes it (weights, engine, the closed loop with its ramp, a window of the
benchmark's ``run_seconds``, which judges as many tokens as a run does),
judged by the reference, then the control in the program's place: the
reference in fp8. The program has to be correct and the control has to exceed one of
the cell's limits. Skips where there is no card (decided inside the
test)::

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SECONDS = float(BENCH["run_seconds"])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, card):
    from portbench.run import run_cell

    c = spec.load_cell(cell)
    limits = c.workload["judge"]["limits"]
    for seed in SEEDS:
        out = run_cell(c, seed, SECONDS, False, "cuda", time.perf_counter(),
                       control=True)
        assert out["correct"], out["checks"]
        assert any(out["control"][k] > limits[k] for k in limits), \
            (out["control"], limits)
        card.cuda.empty_cache()
