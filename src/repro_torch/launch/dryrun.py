"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on DTensors
over a fake process group (the port of ``repro/launch/dryrun.py``).

For each cell the dry-run:
  1. builds the production mesh (16 x 16 pod / 2 x 16 x 16 multi-pod), a
     ``DeviceMesh`` on a fake process group of 512 ranks
     (``launch.mesh``): this process is rank 0, and collectives return at
     once;
  2. resolves param/optimizer/batch/cache specs from ``launch/sharding.py``
     and distributes fake parameters, optimizer state and inputs as
     DTensors with those placements (``FakeTensorMode``: nothing is
     allocated; kimi-k2 is 2 TB of bf16 params);
  3. runs the cell's step from ``launch/steps.py`` (train, grads for
     ``HOST_OPTIMIZER``, prefill or serve) under ``runconfig.options(
     remat=train, scan_unroll=, shard_env=(mesh, dp_axes, tp_axis))``,
     with ``DeviceCounter`` watching;
  4. writes a record with the reference's keys to
     ``experiments/dryrun_torch/``.

What the record holds, and how each number is taken:
  * ``cost_analysis.flops``: FLOPs per device, the global count divided
    by ``n_devices``. The global count is ``torch.utils.flop_counter``'s
    formulas applied to every DTensor op at its global shapes (what
    ``FlopCounterMode`` counts for the same step on one device; the
    ``wkv6`` and ``ssd_scan`` ops through their own formulas).
    ``flops_rank0`` is the work rank 0's local ops do (replicated work
    included), ``bytes accessed`` the operand and result bytes of rank
    0's local ops (views and allocations excluded: an upper bound on
    memory traffic, as the reference's pre-fusion count is).
    ``recurrence_flops`` keeps the reference's analytic formula for
    parity; the counter already sees the recurrences, so ``roofline.
    analyse`` does not add it.
  * ``collectives``: result bytes on rank 0 of every functional
    collective DTensor runs, under the reference's five op names.
  * ``memory_analysis``: ``argument_size_in_bytes`` (rank 0's shards of
    params, optimizer state and inputs) and ``peak_bytes``, the most
    bytes of fake storage live at once on rank 0 during the step
    (``source`` names the counter).
  * ``model_flops``, ``recurrence_flops``, ``param_count``,
    ``active_param_count``, ``n_devices``, ``mesh_shape``,
    ``unmatched_params``: as the reference computes them.

DTensor's sharding rules are PyTorch's, plus the port's for its custom
ops (``kernels.ops.register_sharding_rules``). A view that would split a
dim sharded unevenly (24 heads of 128 over a 16-wide tensor axis) is
taken as a reshape: DTensor gathers that dim first (GSPMD pads it and
exchanges halos instead). On a mesh of one device (1 x 1) nothing is
sharded: the step runs on the local fake tensors outside any shard env,
so it is the port's own step as it runs on one card, and its counts can
be held against that run. The layer loop is always unrolled
(``runconfig.scan``); ``--no-unroll`` only sets the knob.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as configs_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.models import registry as R
from repro_torch.models import runconfig
from repro_torch.models.layers import tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (namespace _c10d_functional, and DTensor's own
# all-to-all) -> the reference's op names
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "wait_tensor", "device", "detach",
               "lift_fresh", "_to_copy_meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class DeviceCounter(TorchDispatchMode):
    """Rank 0's view of a step on DTensors. A DTensor op adds its FLOPs
    at global shapes (``global_flops``) and is handed back to DTensor
    (``NotImplemented``), which runs it as local ops that come back here:
    those add rank 0's FLOPs, operand and result bytes, collective result
    bytes and the storages they allocate (live bytes and their peak).
    Ops DTensor runs only to infer an output's shape are not counted
    (``quiet``)."""

    def __init__(self):
        super().__init__()
        self.global_flops = 0
        self.global_by_op: dict[str, int] = {}
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.quiet = 0
        self._held: dict[int, int] = {}

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages (DTensors: their local shards) as
        live; returns the bytes added."""
        before = self.live
        for t in tensors:
            self._track(getattr(t, "_local_tensor", t))
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        packet = func._overloadpacket
        if any(issubclass(t, DTensor) for t in types):
            if packet in flop_registry:
                self._add_global(packet, flop_registry[packet](
                    *args, **kwargs, out_val=None))
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._opname
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            scale = runconfig.local_scale()
            if scale:             # a local_map region: every rank's share
                self._add_global(packet, f * scale)
        outs = _tensors(out)
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_dtensor") and name in _FUNCOL:
            op = _FUNCOL[name]
            self.coll_bytes[op] += sum(_nbytes(t) for t in outs)
            self.coll_counts[op] += 1
        elif name not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            in_st = {t.untyped_storage()._cdata for t in ins}
            written = [t for t in outs
                       if t.untyped_storage()._cdata not in in_st]
            if written or not outs:
                self.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                        + sum(_nbytes(t) for t in written))
        for t in outs:
            self._track(t)
        return out

    def _add_global(self, packet, flops) -> None:
        self.global_flops += flops
        key = str(packet)
        self.global_by_op[key] = self.global_by_op.get(key, 0) + flops

    def collectives(self) -> dict:
        return {"bytes_by_op": dict(self.coll_bytes),
                "counts": dict(self.coll_counts),
                "total_bytes": sum(self.coll_bytes.values())}


@contextlib.contextmanager
def _quiet_propagation(counter: DeviceCounter):
    """Mark the ops DTensor runs on global fake tensors to infer an
    output's shape, so ``counter`` skips them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    real = getattr(ShardingPropagator, name, None)
    if real is None:
        yield
        return

    def quiet(self, *a, **kw):
        counter.quiet += 1
        try:
            return real(self, *a, **kw)
        finally:
            counter.quiet -= 1

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, real)


_VIEWS_AS_RESHAPE = []


def _reshape_views() -> None:
    """Let DTensor redistribute a view it cannot split evenly, as it does
    for ``reshape``, instead of raising (the models' ``.reshape`` of a
    contiguous tensor arrives as ``aten.view``). Set once for the
    process, before the first cell."""
    if _VIEWS_AS_RESHAPE:
        return
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops

    aten = torch.ops.aten
    for op in (aten.view.default, aten._unsafe_view.default):
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1),
            strict_view=False)
    _VIEWS_AS_RESHAPE.append(True)


# ---------------------------------------------------------------------------
# cell building
# ---------------------------------------------------------------------------

def _opt_specs(param_spec_tree):
    return {"m": param_spec_tree, "v": param_spec_tree,
            "step": sh.P()}


def _distribute(tree, spec_tree, mesh):
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        pl = runconfig.placements(spec, mesh)
        try:
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        except TypeError:                # an older distribute_tensor
            return distribute_tensor(t, mesh, pl)

    return tree_map(one, tree, spec_tree)


def build_cell(api, shape_name: str, mesh, *, batch_override=None,
               mode=None):
    """(step_fn, args, info) of one cell: fake DTensor args on ``mesh``
    in ``mode`` (a ``FakeTensorMode``; a new one if None). ``api`` must
    be built on the CPU (its fake tensors are CPU tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernel_ops.register_sharding_rules()
    _reshape_views()
    mode = mode or FakeTensorMode()
    cell = R.SHAPES[shape_name]
    pshapes = R.param_shapes(api)
    pspecs, unmatched = sh.param_specs(api, pshapes, mesh)
    params = _distribute(R.fake_like(pshapes, mode), pspecs, mesh)
    inputs = R.input_specs(api, shape_name, batch_override, mode)
    specs = {"params": pspecs}

    if cell.kind in ("train", "prefill"):
        bspecs = sh.batch_specs(inputs, mesh, api)
        batch = _distribute(inputs, bspecs, mesh)
        specs["batch"] = bspecs
        if cell.kind == "prefill":
            step = steps_lib.make_prefill_step(api)
            args = (params, batch)
        elif api.arch_id in steps_lib.HOST_OPTIMIZER:
            step = steps_lib.make_grads_step(api)
            args = (params, batch)
        else:
            f32 = tree_map(lambda s: R.TensorSpec(s.shape, torch.float32),
                           pshapes)
            opt_shape = {"m": f32, "v": f32,
                         "step": R.TensorSpec((), torch.int32)}
            ospecs = _opt_specs(pspecs)
            opt = _distribute(R.fake_like(opt_shape, mode), ospecs, mesh)
            specs["opt"] = ospecs
            step = steps_lib.make_train_step(api)
            args = (params, opt, batch)
    else:  # decode
        dspecs = sh.decode_input_specs(inputs, api, mesh)
        dist = _distribute(inputs, dspecs, mesh)
        specs["decode"] = dspecs
        step = steps_lib.make_serve_step(api)
        args = (params, dist["cache"], dist["tokens"], dist["pos"])
    return step, args, {"unmatched_params": unmatched, "specs": specs,
                        "mode": mode}


def arg_bytes(args) -> tuple[int, int]:
    """(rank 0's bytes of ``args``' local shards, their global bytes)."""
    local = glob = 0
    for t in _tensors(args):
        glob += _nbytes(t)
        local += _nbytes(getattr(t, "_local_tensor", t))
    return local, glob


def _recurrence_flops(api, shape_name: str) -> float:
    """The reference's analytic FLOPs of the rolled time scans (wkv /
    ssd), kept for parity. The port's counter sees the recurrences
    through their ops' formulas, so nothing adds this to its count."""
    cell = R.SHAPES[shape_name]
    if cell.kind == "decode":
        return 0.0
    mult = 4.0 if cell.kind == "train" else 1.0   # bwd~2x fwd, remat +1x
    tokens = cell.global_batch * cell.seq_len
    cfg = api.cfg
    if api.family == "ssm":
        return mult * 6.0 * tokens * cfg.num_layers * cfg.d_model \
            * cfg.head_size
    if api.family == "hybrid":
        ms = cfg.mamba_spec()
        return mult * 8.0 * tokens * cfg.num_layers * ms.d_inner \
            * ms.d_state
    return 0.0


def _model_flops(api, shape_name: str) -> float:
    """Analytic 'useful' FLOPs: 6·N·D train, 2·N·D forward (MoE:
    N_active)."""
    cell = R.SHAPES[shape_name]
    n = api.active_param_count
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch           # decode: one token


def trace_cell(api, shape_name: str, mesh, *, remat: bool = True,
               unroll: bool = True, batch_override=None) -> dict:
    """Build one cell on ``mesh`` and run its step under the counter;
    returns the measured part of the record.

    On a mesh of one device the step runs on the DTensors' local (whole)
    fake tensors with no shard env: the port's own step, the one that
    runs on a card (ring written by index, grouped attention, the plain
    embedding and cross-entropy), every op counted as the device's."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._pytree import tree_map as pytree_map

    kind = R.SHAPES[shape_name].kind
    step, args, info = build_cell(api, shape_name, mesh,
                                  batch_override=batch_override)
    n_dev = int(np.prod(list(mesh_shape(mesh).values())))
    if n_dev == 1:
        args = pytree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                          else t, args)
        env, region = None, runconfig.local_region(1)
    else:
        _f, tp_axis, dp_axes = sh.parallelism(api, mesh)
        env, region = (mesh, dp_axes, tp_axis), contextlib.nullcontext()
    counter = DeviceCounter()
    local_args, global_args = arg_bytes(args)
    counter.hold(_tensors(args))
    with info["mode"], _quiet_propagation(counter), \
            implicit_replication(), counter, region, \
            runconfig.options(remat=(remat and kind == "train"),
                              scan_unroll=unroll, shard_env=env):
        out = step(*args)
    out_local, _ = arg_bytes(out)
    del out
    return {
        "unmatched_params": info["unmatched_params"],
        "cost_analysis": {
            "flops": counter.global_flops / n_dev,
            "global_flops": float(counter.global_flops),
            "global_flops_by_op": counter.global_by_op,
            "flops_rank0": float(counter.flops),
            "bytes accessed": float(counter.bytes_accessed)},
        "memory_analysis": {
            "argument_size_in_bytes": local_args,
            "output_size_in_bytes": out_local,
            "peak_bytes": counter.peak,
            "temp_size_in_bytes": counter.peak - local_args,
            "source": "repro_torch.launch.dryrun.DeviceCounter: fake "
                      "storages live on rank 0"},
        "collectives": counter.collectives(),
        "global_arg_bytes": float(global_args),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             unroll: bool = True, remat: bool = True,
             save: bool = True, lower_only: bool = False,
             api=None, mesh=None) -> dict:
    """One cell's record. ``mesh_kind`` is "pod" or "multipod" (the
    production meshes), or a label for an explicit ``mesh``; ``api``
    (default: the arch's full config on the CPU) may be a SMOKE one."""
    t0 = time.monotonic()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    api = api or R.build(arch, device="cpu")
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": int(np.prod(list(mesh_shape(mesh).values()))),
        "mesh_shape": mesh_shape(mesh),
        "param_count": api.param_count,
        "active_param_count": api.active_param_count,
        "model_flops": _model_flops(api, shape_name),
        "recurrence_flops": _recurrence_flops(api, shape_name),
        "unroll": unroll, "remat": remat,
        "status": "error",
    }
    try:
        if lower_only:
            _step, args, info = build_cell(api, shape_name, mesh)
            rec["unmatched_params"] = info["unmatched_params"]
            rec["status"] = "lowered"
            rec["lower_s"] = rec["total_s"] = round(time.monotonic() - t0,
                                                    2)
            return rec
        rec.update(trace_cell(api, shape_name, mesh, remat=remat,
                              unroll=unroll))
        rec["trace_s"] = round(time.monotonic() - t0, 2)
        rec["status"] = "ok"
    except Exception as e:                       # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"[:4000]
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.monotonic() - t0, 2)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_kind}.json".replace("/", "-")
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=configs_lib.ARCH_IDS)
    p.add_argument("--shape", choices=tuple(R.SHAPES))
    p.add_argument("--mesh", choices=("pod", "multipod", "both"),
                   default="both")
    p.add_argument("--all", action="store_true",
                   help="run every runnable (arch x shape) cell")
    p.add_argument("--no-unroll", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--lower-only", action="store_true",
                   help="stop after distributing the cell's arguments "
                        "(fast sharding validation)")
    args = p.parse_args(argv)

    if args.all:
        todo = R.cells()
    elif args.arch and args.shape:
        if not R.runnable(args.arch, args.shape):
            print(f"SKIP {args.arch} x {args.shape}: "
                  f"{R.skip_reason(args.arch, args.shape)}")
            return 0
        todo = [(args.arch, args.shape)]
    else:
        p.error("--all or both --arch and --shape required")

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    failures = 0
    apis = {}
    for arch, shape_name in todo:
        api = apis.setdefault(arch, R.build(arch, device="cpu"))
        for mk in meshes:
            rec = run_cell(arch, shape_name, mk,
                           unroll=not args.no_unroll,
                           remat=not args.no_remat,
                           lower_only=args.lower_only,
                           save=not args.lower_only, api=api)
            flops = rec.get("cost_analysis", {}).get("flops", float("nan"))
            coll = rec.get("collectives", {}).get("total_bytes",
                                                  float("nan"))
            peak = rec.get("memory_analysis", {}).get("peak_bytes",
                                                      float("nan"))
            print(f"[{rec['status']:7s}] {arch} x {shape_name} x {mk}: "
                  f"flops/dev={flops:.3e} coll_bytes={coll:.3e} "
                  f"peak={peak:.3e} total={rec['total_s']}s", flush=True)
            if rec["status"] not in ("ok", "lowered"):
                failures += 1
                print(rec.get("error", ""))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
