"""What a run of one cell needs, found by name under ``portbench/``.

``BENCHMARK.json`` at the checkout's root lists the cells, the
configurations and the metrics. Everything that belongs to one of them
sits in a file of its own, found by its name, so a later change adds a
cell, a configuration, a traffic mix or a metric by adding files:

  configs/<config>.json     the model as it is run (sizes, cuts, source)
  traffic/<traffic>.json    the parameters of the closed-loop generator
  workloads/<cell>.json     the cell's engine settings, judge and limits
  metrics/<metric>.py       ``read(ctx)``: the metric's number or None
  families/<family>.py      weights, the program's model and FLOP count
  reference/<family>.py     the plain reference of that family
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: tuple       # Metric
    per_layer: tuple        # Metric


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: an
    end-to-end metric in every cell its ``workloads`` lists (every cell
    without the key); a per-layer one likewise, and without the key in
    every cell that reports the metric it ``moves``."""
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m.name for m in e2e}
    per = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files.
    Raises KeyError for a cell the benchmark does not list."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    base = root / "portbench"
    config = load_json(root / conf_entry["file"])
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    if config["name"] != entry["config"]:
        raise ValueError(f"{conf_entry['file']} is named {config['name']!r}")
    e2e, per = metrics_of(bench, name)
    return Cell(name, int(entry["chips"]), config, traffic, workload,
                tuple(e2e), tuple(per))


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    return _module(path, f"portbench.metrics.{name.replace('.', '_')}").read


def family(name: str):
    """``portbench.families.<name>``: weights, the program's model, FLOPs."""
    return importlib.import_module(f"portbench.families.{name}")


def reference(name: str):
    """``portbench.reference.<name>``: the family's plain reference."""
    return importlib.import_module(f"portbench.reference.{name}")
