"""The port's packages export every name the reference's packages
export: each name that a reference package ``__init__`` imports or lists
in ``__all__`` is an attribute of the port's package of the same path.
The reference is read by its syntax tree (no ``import repro``, so no
JAX), the port by importing it. Names whose values are plain data (the
channel presets, the model registry's tables, the policy registry) are
also held equal in content."""

import ast
import dataclasses
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PACKAGES = sorted(p.parent.name for p in REF.glob("*/__init__.py"))


def _exported(init: Path) -> set[str]:
    """The names a package ``__init__`` binds by import or lists in
    ``__all__``, public ones only."""
    tree = ast.parse(init.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names.update(ast.literal_eval(node.value))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_reference_package_is_scanned():
    assert {"core", "models", "kernels", "runtime", "serve", "optim",
            "data", "checkpoint", "configs"} <= set(PACKAGES)


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_exports_the_reference_names(package):
    want = _exported(REF / package / "__init__.py")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = sorted(n for n in want if not hasattr(port, n))
    assert missing == [], f"repro_torch.{package} lacks {missing}"


@pytest.mark.parametrize("package,expected", [
    ("core", {"ChannelModel", "PRESETS", "HBM_V5E", "HintTree",
              "DuplexOffloadEngine", "REGISTRY", "StreamSpec",
              "simulate", "CaxRegistry"}),
    ("models", {"ModelAPI", "SHAPES", "LONG_CONTEXT_OK", "FAMILY", "build",
                "input_specs", "runnable", "skip_reason", "cells"}),
    ("kernels", {"ops", "ref"}),
    ("runtime", {"Trainer", "TrainConfig", "FaultInjector", "DecodeServer",
                 "OffloadedKVCache", "ServeConfig"}),
])
def test_the_packages_this_port_fills_are_read_whole(package, expected):
    """The AST reading finds the names these packages export (a reading
    that found none would pass the test above vacuously)."""
    assert expected <= _exported(REF / package / "__init__.py")


def test_data_names_equal_the_reference():
    """The names that carry tables, not code, hold the same content."""
    from repro import core as jcore
    from repro import models as jmodels
    from repro_torch import core, models
    assert set(core.PRESETS) == set(jcore.PRESETS)
    for name in ("DDR5_LOCAL", "CXL_256", "CXL_512", "HBM_V5E", "ICI_LINK",
                 "PCIE_HOST"):
        assert dataclasses.asdict(getattr(core, name)) == \
            dataclasses.asdict(getattr(jcore, name)), name
    assert list(core.REGISTRY) == list(jcore.REGISTRY)
    assert (core.PAGE_IN, core.PAGE_OUT) == (jcore.PAGE_IN, jcore.PAGE_OUT)
    assert models.FAMILY == jmodels.FAMILY
    assert models.LONG_CONTEXT_OK == jmodels.LONG_CONTEXT_OK
    assert {k: tuple(v) for k, v in models.SHAPES.items()} == \
        {k: tuple(v) for k, v in jmodels.SHAPES.items()}
    assert models.cells() == jmodels.cells()
