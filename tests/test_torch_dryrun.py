"""The port's dry-run (``launch/dryrun.py``, ``launch/roofline.py``,
``launch/report.py``) and the custom ops it traces.

* ``roofline.analyse`` with the H100's published peaks, as
  ``tests/test_dryrun_tools.py`` holds the reference's: the three terms,
  the bound-MFU, and ``recurrence_flops`` never added (the counter sees
  the recurrences through their ops).
* The ``wkv6`` / ``wkv6_backward`` and ``ssd_scan`` ops: real results
  equal the plain versions (the SSD op's gradient too), fake shapes equal
  real ones, ``FlopCounterMode`` counts their formulas, and on DTensors
  over a (2, 2) fake mesh their sharding rules keep the batch sharded
  (rank 0's shard equals the plain version on its slice of the batch).
* One SMOKE cell, smollm-135m ``train_4k`` on a (2, 2) fake mesh, ends
  ``ok``; its analytic fields equal the reference's exactly (the
  reference's ``build_cell`` and ``cost_analysis`` in a subprocess with
  four host devices), and its FLOPs per device are within the tolerance
  stated at ``FLOPS_RTOL``.
* On a (1, 1) mesh the trace is the port's own step (no shard env): its
  FLOPs and argument bytes equal those of the real step on the CPU.
* The CLI: ``--lower-only`` on a production cell, the skip message, and
  the report's tables.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# The reference's per-device FLOPs come from XLA's cost analysis, which
# also counts elementwise work (norms, softmax, the optimizer, casts) and
# the rolled q-block loop's body once; ``FlopCounterMode``'s formulas count
# matmuls and the custom ops only. On this SMOKE cell the elementwise
# share is large: the port's count read 0.856 of XLA's.
FLOPS_RTOL = 0.2


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class TestRooflineAnalyse:
    def _rec(self, **kw):
        base = {
            "status": "ok", "arch": "x", "shape": "train_4k",
            "mesh": "pod", "n_devices": 256, "unroll": True,
            "model_flops": 1e15, "recurrence_flops": 0.0,
            "cost_analysis": {"flops": 1e13, "bytes accessed": 1e12},
            "collectives": {"total_bytes": 5e10},
        }
        base.update(kw)
        return base

    def test_terms(self):
        a = roofline.analyse(self._rec())
        assert a["compute_s"] == pytest.approx(1e13 / 989e12)
        assert a["memory_s"] == pytest.approx(1e12 / 3.35e12)
        assert a["collective_s"] == pytest.approx(5e10 / 450e9)
        assert a["dominant"] == "memory"

    def test_bound_mfu(self):
        a = roofline.analyse(self._rec(collectives={"total_bytes": 5e12}))
        useful = 1e15 / 256 / 989e12
        assert a["dominant"] == "collective"
        assert a["mfu_bound"] == pytest.approx(useful / (5e12 / 450e9))

    def test_recurrence_never_added(self):
        a = roofline.analyse(self._rec(recurrence_flops=2.56e15))
        assert a["compute_s"] == pytest.approx(1e13 / 989e12)

    def test_rolled_flagged_and_errors_skipped(self):
        assert roofline.analyse(self._rec(unroll=False))["rolled"] is True
        assert roofline.analyse({"status": "error"}) is None


def _wkv_inputs(B=2, S=12, H=4, hs=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hs)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.99, (B, S, H, hs)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((H, hs)).astype(np.float32))
    return r, k, v, w, u


def test_wkv6_ops_real_fake_and_counted():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    r, k, v, w, u = _wkv_inputs()
    dout = torch.ones_like(r)
    out = torch.ops.repro_torch.wkv6(r, k, v, w, u)
    assert torch.equal(out, ref.wkv6(r, k, v, w, u)[0])
    grads = torch.ops.repro_torch.wkv6_backward(r, k, v, w, u, dout)
    for a, b in zip(grads, ref.wkv6_backward(r, k, v, w, u, dout)):
        assert torch.equal(a, b)
    with FakeTensorMode() as mode:
        fr, fk, fv, fw, fu = (mode.from_tensor(t) for t in (r, k, v, w, u))
        with FlopCounterMode(display=False) as fc:
            fo = ops.wkv6(fr, fk, fv, fw, fu, chunk=12)
            fg = torch.ops.repro_torch.wkv6_backward(fr, fk, fv, fw, fu,
                                                     fo)
    assert fo.shape == out.shape and fo.dtype == out.dtype
    assert [g.shape for g in fg] == [g.shape for g in grads]
    assert fc.get_total_flops() == (ops.wkv6_flops(2, 12, 4, 8)
                                    + ops.wkv6_backward_flops(2, 12, 4, 8))


def test_ssd_op_equals_the_loop_with_its_gradient():
    rng = np.random.default_rng(1)
    Bsz, S, H, P, N = 2, 7, 4, 3, 5
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    args = [f(Bsz, S, H, P), f(Bsz, S, 1, N), f(Bsz, S, 1, N),
            torch.from_numpy(rng.uniform(0.1, 1, (Bsz, S, H)).astype(
                np.float32)), f(H), f(H), f(Bsz, H, P, N)]
    args = [a.requires_grad_(True) for a in args]
    y1, h1 = ssm._ssd_loop(*args)
    y2, h2 = torch.ops.repro_torch.ssd_scan(*args)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    g1 = torch.autograd.grad(y1.sum() + h1.square().sum(), args)
    g2 = torch.autograd.grad(y2.sum() + h2.square().sum(), args)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wkv6_rule_keeps_the_batch_sharded():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    ops.register_sharding_rules()
    mesh = device_mesh((2, 2), ("data", "model"))
    r, k, v, w, u = _wkv_inputs(B=4, H=4)
    pl = [Shard(0), Shard(2)]
    d = [distribute_tensor(t, mesh, pl, src_data_rank=None)
         for t in (r, k, v, w)]
    du = distribute_tensor(u, mesh, [Replicate(), Shard(0)],
                           src_data_rank=None)
    out = torch.ops.repro_torch.wkv6(*d, du)
    assert list(out.placements) == pl
    want = ref.wkv6(r[:2, :, :2], k[:2, :, :2], v[:2, :, :2], w[:2, :, :2],
                    u[:2])[0]
    assert torch.equal(out.to_local(), want)


def _reference_cell(arch: str, shape: str) -> dict:
    code = f"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
jax.devices()          # four host devices, before the dry-run's import
from jax.sharding import Mesh
from repro.launch import dryrun as D
from repro.models import registry as R
from repro.models import runconfig
from repro.launch import sharding as sh
api = R.build({arch!r}, smoke=True)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
fn, args, info = D.build_cell(api, {shape!r}, mesh)
_f, tp, dp = sh.parallelism(api, mesh)
kind = R.SHAPES[{shape!r}].kind
with runconfig.options(remat=kind == "train", scan_unroll=True,
                       shard_env=(mesh, dp, tp)):
    compiled = fn.lower(*args).compile()
cost = compiled.cost_analysis()
cost = cost[0] if isinstance(cost, list) else cost
print(json.dumps(dict(
    model_flops=D._model_flops(api, {shape!r}),
    recurrence_flops=D._recurrence_flops(api, {shape!r}),
    param_count=api.param_count, active_param_count=api.active_param_count,
    n_devices=4, mesh_shape={{"data": 2, "model": 2}},
    unmatched_params=info["unmatched_params"], flops=cost["flops"])))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_smoke_cell_on_a_fake_mesh_equals_reference():
    arch, shape = "smollm-135m", "train_4k"
    want = _reference_cell(arch, shape)
    mesh = device_mesh((2, 2), ("data", "model"))
    api = TR.build(arch, smoke=True, device="cpu")
    rec = dryrun.run_cell(arch, shape, "2x2", mesh=mesh, api=api,
                          save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("model_flops", "recurrence_flops", "param_count",
                "active_param_count", "n_devices", "mesh_shape",
                "unmatched_params"):
        assert rec[key] == want[key], key
    got = rec["cost_analysis"]["flops"]
    assert abs(got - want["flops"]) <= FLOPS_RTOL * want["flops"], (
        got, want["flops"])
    ma = rec["memory_analysis"]
    assert 0 < ma["argument_size_in_bytes"] <= ma["peak_bytes"]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert set(rec["collectives"]["bytes_by_op"]) == set(dryrun.COLLECTIVES)


def _real_cell_args(api, shape: str, B: int) -> tuple:
    """Real CPU arguments of the shapes ``build_cell`` fakes."""
    from repro_torch.optim import adamw_init

    cell = TR.SHAPES[shape]
    S = cell.seq_len
    g = torch.Generator().manual_seed(0)
    params = api.init(g)
    ints = lambda *s: torch.randint(  # noqa: E731
        0, api.cfg.vocab, s, generator=g, dtype=torch.int32)
    if cell.kind == "decode":
        return (params, api.init_cache(B, S), ints(B),
                torch.full((B,), S - 1, dtype=torch.int32))
    batch = {"tokens": ints(B, S), "labels": ints(B, S)}
    if cell.kind == "prefill":
        return (params, batch)
    return (params, adamw_init(params), batch)


@pytest.mark.parametrize("arch,shape,B", [("smollm-135m", "train_4k", 1),
                                          ("llama3.2-3b", "decode_32k", 2)])
def test_one_device_trace_is_the_ports_own_step(arch, shape, B):
    """On a (1, 1) mesh the dry-run traces the step a card runs, outside
    any shard env and without the unroll knob: its FLOPs equal
    ``FlopCounterMode`` on the real step, its argument bytes the real
    arguments' bytes, and no collective runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import runconfig
    from repro_torch.models.layers import tree_leaves

    api = TR.build(arch, smoke=True, device="cpu")
    mesh = device_mesh((1, 1), ("data", "model"))
    rec = dryrun.trace_cell(api, shape, mesh, remat=True, unroll=False,
                            batch_override=B)
    kind = TR.SHAPES[shape].kind
    args = _real_cell_args(api, shape, B)
    step = {"train": steps_lib.make_train_step,
            "decode": steps_lib.make_serve_step}[kind](api)
    with FlopCounterMode(display=False) as fc, \
            runconfig.options(remat=kind == "train"):
        step(*args)
    assert rec["cost_analysis"]["global_flops"] == fc.get_total_flops() > 0
    assert rec["cost_analysis"]["flops"] == fc.get_total_flops()
    want = sum(t.numel() * t.element_size() for a in args
               for t in (tree_leaves(a) if isinstance(a, dict) else [a]))
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["memory_analysis"]["peak_bytes"] > want
    assert rec["collectives"]["total_bytes"] == 0


def test_cli_lower_only_and_skip(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a], env=env,
        capture_output=True, text=True, timeout=300)
    out = run("--arch", "kimi-k2-1t-a32b", "--shape", "train_4k", "--mesh",
              "both", "--lower-only")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("[lowered]") == 2
    out = run("--arch", "qwen2.5-14b", "--shape", "long_500k")
    assert out.returncode == 0 and out.stdout.startswith("SKIP")


def test_report_tables(tmp_path):
    rec = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "pod",
           "status": "ok", "n_devices": 256, "unroll": True,
           "model_flops": 1e15, "recurrence_flops": 0.0,
           "cost_analysis": {"flops": 1e13, "bytes accessed": 1e12},
           "collectives": {"total_bytes": 5e10, "bytes_by_op": {
               c: 1e10 for c in dryrun.COLLECTIVES}},
           "memory_analysis": {"peak_bytes": 4e9}, "trace_s": 1.0}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    table = report.dryrun_table(str(tmp_path))
    assert "| smollm-135m | train_4k | pod | ok | 10000.0 | 4.00GB |" in table
    assert "| smollm-135m | train_4k | multipod | pending" in table
    assert "SKIP" in table
    assert "| smollm-135m | train_4k | pod | 1.011e-02 |" in \
        report.roofline_table(str(tmp_path))
