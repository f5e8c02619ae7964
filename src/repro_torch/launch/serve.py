"""Serving driver: multi-tenant continuous batching with duplex-paged KV
(port of ``repro/launch/serve.py``; ``--tiers`` backs the pool's host
side with DDR5/CXL channels, ``--faults`` injects a fault plan,
``--trace OUT.JSON`` exports a Perfetto trace of the measured run,
``--snapshot-dir`` / ``--snapshot-every`` take crash-consistent snapshots,
``--restore`` resumes a crashed run from them, ``--mesh data,model``
serves sharded over a device mesh and ``--offload-demo`` then drives the
deprecated ``runtime.serve.OffloadedKVCache`` shim).

Requests arrive staggered into the ``ServeEngine`` megastep loop; the
admission policy picks which waiting work joins the running set — LLM
prefills into decode slots, and (with ``--tenants``) KV-store op streams
and vector-search query walks into tenant slots — and every step's block
traffic pages through the ``DuplexOffloadEngine`` in one grouped
transaction, with the CUDA kernels moving and searching the data. The
run report (JSON, last line) carries throughput plus the paging stats,
per-hint-scope billing and the modelled duplex-vs-serial speedup, in the
reference's schema.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --requests 8 --prompt-len 8 --gen 16 --arrival-every 2 \
      --tenants redis,vectordb

``--mesh`` needs ``data * model`` devices: the CUDA devices torch sees
(``--devices N`` keeps the first N), one on the CPU. The port's tests
build meshes of logical ranks that share a device with
``launch.mesh.make_debug_mesh(model, devices=[...])``.

A run killed by ``--faults crash:@S`` with ``--snapshot-dir D
--snapshot-every N`` exits 3 when a snapshot survived (1 when none did);
the same flags plus ``--restore`` resume it from ``D``.

Runs on the GPU; ``--device cpu`` is the only way onto the CPU. Weights
and prompts are random, from fixed seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import configs as configs_lib
from repro_torch.core import channel as channel_lib
from repro_torch.core import faults as faults_lib
from repro_torch.models import registry as R
from repro_torch.serve import (EngineConfig, EngineStallError, KVStoreTenant,
                               ServeEngine, VectorSearchTenant)
from repro_torch.serve.snapshot import journal_length, newest_valid_snapshot

KNOWN_TENANTS = ("redis", "vectordb")


def _mesh_arg(value: str) -> tuple[int, int] | None:
    """argparse type for --mesh: 'data,model' axis sizes (e.g. '2,2')."""
    if not value:
        return None
    parts = value.split(",")
    try:
        data, model = (int(x) for x in parts)
        if data < 1 or model < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh wants two positive axis sizes 'data,model' "
            f"(e.g. 2,2), got {value!r}") from None
    return data, model


def _tenants_arg(value: str) -> list[str]:
    """argparse type for --tenants: fail at parse time with the known
    names instead of deep in engine setup."""
    names = [t for t in value.split(",") if t]
    unknown = [t for t in names if t not in KNOWN_TENANTS]
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown tenants {unknown}; known tenants: "
            f"{','.join(KNOWN_TENANTS)}")
    return names


def _tiers_arg(value: str) -> str | None:
    """argparse type for --tiers: validate the channel-set spec against
    the tier-preset registry at parse time (the error names the known
    kinds)."""
    if not value:
        return None
    try:
        channel_lib.parse_tier_spec(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


def _faults_arg(value: str) -> str | None:
    """argparse type for --faults: validate the fault-plan grammar at
    parse time (the error spells out the event syntax)."""
    if not value:
        return None
    try:
        faults_lib.parse_fault_plan(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=configs_lib.ARCH_IDS,
                   default="smollm-135m")
    p.add_argument("--full", action="store_true",
                   help="the published widths (default: the smoke config)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=4,
                   help="running decode slots (continuous batch width)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--block-tokens", type=int, default=4,
                   help="KV page granularity")
    p.add_argument("--hbm-blocks", type=int, default=6,
                   help="KV pool HBM slots shared by the whole batch")
    p.add_argument("--pool-blocks", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=4)
    p.add_argument("--megastep", type=int, default=8,
                   help="engine steps fused per host dispatch (K): the "
                        "run loop adapts K between admission events and "
                        "syncs the host once per megastep. 1 = classic "
                        "per-step loop")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="megastep boundaries in flight: 2 (default) "
                        "plans and dispatches megastep t+1 before "
                        "consuming t's deferred readback; 1 = classic "
                        "blocking boundary. Bit-exact either way")
    p.add_argument("--policy", default="hinted",
                   help="admission policy (core.policies registry)")
    p.add_argument("--tiers", type=_tiers_arg, default=None,
                   help="host-memory channel set for the KV pool, as "
                        "kind:count pairs (e.g. ddr5:2,cxl:2; kinds: "
                        f"{','.join(sorted(channel_lib.TIER_PRESETS))}). "
                        "Default: flat single-channel host pool")
    p.add_argument("--no-tier-migrate", action="store_true",
                   help="disable megastep-boundary host-tier "
                        "migrations (tiered pools only)")
    p.add_argument("--tenants", type=_tenants_arg, default=[],
                   help="comma-separated non-LLM tenants to co-serve: "
                        f"{','.join(KNOWN_TENANTS)} (each adds "
                        "hint-scoped op streams through the shared "
                        "pool)")
    p.add_argument("--tenant-steps", type=int, default=32,
                   help="op-stream length for each tenant request")
    p.add_argument("--arrival-every", type=int, default=2,
                   help="steps between request arrivals (0 = all at once)")
    p.add_argument("--faults", type=_faults_arg, default=None,
                   help="deterministic fault plan, comma-separated "
                        "events: offline:C@S (channel C hot-unplugs at "
                        "pool transaction S), poison:B@S (host copy of "
                        "block B corrupts), degrade:C@S+D=F (bandwidth "
                        "x F for D transactions), transient:C@S+D=P "
                        "(transfer error probability P), crash:@S "
                        "(process death at transaction S; --restore "
                        "resumes from the last snapshot). Requires "
                        "paging; offline events require --tiers")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the injector's transient-retry draws")
    p.add_argument("--snapshot-dir", default=None,
                   help="directory for crash-consistent engine snapshots "
                        "+ the write-ahead journal (enables --restore "
                        "after a crash)")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="take a consistent cut every N megasteps "
                        "(0 = snapshots off; requires --snapshot-dir "
                        "and paging)")
    p.add_argument("--restore", action="store_true",
                   help="resume from the newest valid snapshot in "
                        "--snapshot-dir instead of submitting a fresh "
                        "workload: journaled submits are replayed and "
                        "the run continues bit-exactly")
    p.add_argument("--stall-boundaries", type=int, default=64,
                   help="consecutive zero-progress megastep boundaries "
                        "before run() raises EngineStallError")
    p.add_argument("--mesh", type=_mesh_arg, default=None,
                   help="serve sharded over a data,model device mesh "
                        "(axis sizes, e.g. 2,2): batch rows and KV pool "
                        "shards split over data ranks, decode replicated "
                        "over model ranks with modelled ICI collective "
                        "billing. Needs data*model devices (the CUDA "
                        "devices torch sees; one on the CPU)")
    p.add_argument("--devices", type=int, default=0,
                   help="use only the first N devices for --mesh "
                        "(0 = however many the mesh needs)")
    p.add_argument("--trace", default=None, metavar="OUT.JSON",
                   help="enable the serve.trace observability plane on "
                        "the measured engine and export a Chrome/"
                        "Perfetto trace (boundary spans on the host "
                        "clock, per-channel duplex busy timelines on "
                        "the modelled clock, fault instants) to this "
                        "path; open at https://ui.perfetto.dev")
    p.add_argument("--telemetry", action="store_true",
                   help="include the CAX scope tree in the JSON report")
    p.add_argument("--no-paging", action="store_true",
                   help="disable the duplex KV pool (dense cache only)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup pass (the reported tok/s then "
                        "includes the kernels' build and first launches)")
    p.add_argument("--offload-demo", action="store_true",
                   help="also run the legacy synthetic tiered-KV demo")
    args = p.parse_args()
    tenant_names = args.tenants            # validated at argparse time
    if tenant_names and args.no_paging:
        p.error("tenants serve from the paged pool; drop --no-paging")
    if tenant_names and args.snapshot_every > 0:
        p.error("snapshots cover the LLM serving state only; tenant op "
                "streams are not crash-consistent — drop --tenants or "
                "--snapshot-every")
    if args.tiers and args.no_paging:
        p.error("--tiers configures the paged pool's host side; drop "
                "--no-paging")
    if args.faults and args.no_paging:
        p.error("--faults targets the paged memory hierarchy; drop "
                "--no-paging")
    if args.snapshot_every > 0 and not args.snapshot_dir:
        p.error("--snapshot-every needs --snapshot-dir")
    if args.snapshot_every > 0 and args.no_paging:
        p.error("snapshots cover the paged memory hierarchy; drop "
                "--no-paging")
    if args.restore and not (args.snapshot_every > 0 and
                             args.snapshot_dir):
        p.error("--restore needs --snapshot-dir and --snapshot-every "
                "matching the crashed run")

    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_debug_mesh
        data, model = args.mesh
        device = torch.device(args.device)
        avail = ([torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]
                 if device.type == "cuda" else [device])
        if args.devices:
            avail = avail[:args.devices]
        if data * model > len(avail):
            p.error(f"--mesh {data},{model} needs {data * model} devices "
                    f"but only {len(avail)} are available; a mesh of "
                    f"ranks that share a device is built with "
                    f"launch.mesh.make_debug_mesh(model, devices=[...])")
        mesh = make_debug_mesh(model, devices=avail[:data * model])

    api = R.build(args.arch, smoke=not args.full, device=args.device)
    params = api.init(torch.Generator().manual_seed(0))
    # tenants reserve per-step HBM headroom; grow the pool's working set
    # so LLM decode keeps its share (redis: 2 blocks/step, vectordb: 4).
    reserve = {"redis": 2, "vectordb": 4}
    tenant_reserve = sum(reserve.get(t, 0) for t in tenant_names)
    cfg = EngineConfig(
        max_batch=args.batch, cache_len=args.cache_len,
        block_tokens=args.block_tokens,
        hbm_blocks=max(args.hbm_blocks, tenant_reserve + 4),
        pool_blocks=args.pool_blocks, prefill_chunk=args.prefill_chunk,
        max_queue=max(args.requests, args.batch) + 8, policy=args.policy,
        paging=not args.no_paging, megastep=args.megastep,
        tiers=args.tiers, tier_migrate=not args.no_tier_migrate,
        pipeline_depth=args.pipeline_depth,
        stall_boundaries=args.stall_boundaries,
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir, device=args.device)
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)

    def build_and_submit(*, snapshots=True, submit=True, trace=True):
        # a FaultInjector is stateful (clock + retry RNG): each engine
        # build gets a fresh one so warmup and the measured run replay
        # the identical fault schedule.
        run_cfg = cfg
        if not snapshots and cfg.snapshot_every > 0:
            # the warmup engine must never write into the measured run's
            # snapshot directory
            run_cfg = dataclasses.replace(run_cfg, snapshot_every=0,
                                          snapshot_dir=None)
        if args.trace and trace:
            # measured engine only: the warmup run's spans and channel
            # intervals would pollute the exported timeline.
            run_cfg = dataclasses.replace(run_cfg, trace=args.trace)
        if args.faults:
            run_cfg = dataclasses.replace(
                run_cfg, faults=faults_lib.FaultInjector(
                    faults_lib.parse_fault_plan(args.faults),
                    seed=args.fault_seed))
        elif args.restore:
            # the snapshot may carry injector state (degraded or offline
            # channels, armed poisons, the transaction clock): resume it
            # into a fresh injector with no new events scheduled
            run_cfg = dataclasses.replace(
                run_cfg, faults=faults_lib.FaultInjector(
                    [], seed=args.fault_seed))
        if mesh is not None:
            from repro_torch.serve.shard import ShardedServeEngine
            engine = ShardedServeEngine(api, params, run_cfg, mesh=mesh)
        else:
            engine = ServeEngine(api, params, run_cfg)
        if not submit:
            # --restore: the workload comes from the snapshot + journal
            return engine, []
        if "redis" in tenant_names:
            kv = engine.add_tenant(KVStoreTenant(
                n_slots=2, ops_per_step=1, store_blocks=16))
            kv.preload(16)
            kv.submit("sequential", n_steps=args.tenant_steps)
            kv.submit("sequential", n_steps=args.tenant_steps)
        if "vectordb" in tenant_names:
            vec = engine.add_tenant(VectorSearchTenant(
                n_slots=1, visits_per_step=2, data_blocks=12))
            vec.submit(n_steps=args.tenant_steps)
        rids = [engine.submit(prompts[i], args.gen,
                              arrival_step=i * args.arrival_every).rid
                for i in range(args.requests)]
        return engine, rids

    def _snapshot_report() -> dict | None:
        """What recovery has to work with: the newest cut that passes its
        checksums and how much journal lies past it. ``resumable`` is the
        exit-code-3 contract: a later ``--restore`` with this directory
        resumes from ``newest_valid``."""
        if args.snapshot_every <= 0:
            return None
        newest = newest_valid_snapshot(args.snapshot_dir)
        return {
            "dir": args.snapshot_dir,
            "snapshot_every": args.snapshot_every,
            "newest_valid": newest,
            "journal_entries": (
                journal_length(args.snapshot_dir, from_step=newest)
                if newest is not None else 0),
            "resumable": newest is not None,
        }

    def _crash_report(engine, exc) -> dict:
        """The reference's operator report for a run the engine could not
        finish: exception identity, fault counters, every failed
        request's structured error and (with snapshots) the recovery
        prospects."""
        err = {"error": {"type": type(exc).__name__, "message": str(exc)},
               "arch": args.arch, "requests": args.requests,
               "faults_plan": args.faults,
               "steps": int(engine.step_count),
               "faults": engine.stats()["faults"],
               "failed_requests": {int(r.rid): r.error
                                   for r in engine.failed.values()},
               "snapshot": _snapshot_report()}
        if isinstance(exc, EngineStallError):
            err["error"]["stuck_rids"] = exc.rids
        return err

    def _crash_exit(report: dict) -> int:
        """3 = crashed but resumable (--restore will recover); 1 =
        unrecoverable (no snapshots, or no cut survived intact)."""
        snap = report.get("snapshot")
        return 3 if snap and snap["resumable"] else 1

    if not args.no_warmup:
        # the same workload once first: builds the CUDA kernels and warms
        # the libraries, so the measured run is steady-state serving.
        warm, _ = build_and_submit(snapshots=False, trace=False)
        if warm._fx is not None:
            # the warmup must not die: the crash events belong to the
            # measured run's injector
            warm._fx.disarm_crashes()
        try:
            warm.run()
        except (RuntimeError, ValueError) as e:
            print(json.dumps(_crash_report(warm, e)))
            return 1
    restore_info = None
    if args.restore:
        engine, rids = build_and_submit(submit=False)
        try:
            restore_info = engine.restore()
        except (OSError, ValueError, RuntimeError) as e:
            print(json.dumps({
                "error": {"type": type(e).__name__, "message": str(e)},
                "snapshot": _snapshot_report(),
            }))
            return 1
    else:
        engine, rids = build_and_submit()

    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        outs = engine.run()
    except (RuntimeError, ValueError) as e:
        report = _crash_report(engine, e)
        print(json.dumps(report))
        return _crash_exit(report)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.monotonic() - t0
    total_tokens = (sum(len(outs[r]) for r in rids if r in outs)
                    if not args.restore
                    else sum(len(v) for v in outs.values()))

    est = engine.stats()
    print(f"served {args.requests} requests / {total_tokens} tokens in "
          f"{engine.step_count} steps / {est['host_dispatches']} host "
          f"dispatches / {est['host_blocked']} blocked boundaries "
          f"(megastep={args.megastep}, "
          f"pipeline={args.pipeline_depth}), {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s) on {engine.device}")
    done_rids = [r for r in rids if r in engine.completed]
    if done_rids:
        first = engine.completed[done_rids[0]]
        print(f"first request: admitted step {first.admitted_step}, "
              f"done step {first.done_step}, tokens "
              f"{outs[done_rids[0]][:8].tolist()}...")
    if args.faults:
        f = est["faults"]
        print(f"faults: {f['injected']} injected, {f['recovered']} "
              f"recovered, {f['quarantined']} quarantined, "
              f"{f['evacuated']} evacuated, {f['shed']} shed, "
              f"{len(engine.failed)} failed requests")
    if args.snapshot_every > 0:
        s = est["snapshot"]
        mode = (f"restored from cut {restore_info['restored_step']}, "
                f"{restore_info['pending_resubmits']} journaled submits "
                f"replayed, {restore_info['casualties']} casualties"
                if restore_info is not None else
                f"{s['snapshots_taken']} cuts taken")
        print(f"snapshots (every {args.snapshot_every} megasteps -> "
              f"{args.snapshot_dir}): {mode}, "
              f"{s['journal_entries']} journal entries")
    if engine.paged and engine.pool.tiered:
        ts = engine.pool.tier_stats()
        print(f"tiered host pool ({args.tiers}): "
              f"tier_speedup={ts['tier_speedup']:.2f}x vs all-DDR5 "
              f"serial, {ts['migrations']} boundary migrations")
    if mesh is not None:
        ici = engine.paging_stats().get("ici", {})
        print(f"mesh {args.mesh[0]}x{args.mesh[1]} (data x model): "
              f"{ici.get('bytes', 0) / 1e6:.2f} MB over ICI in "
              f"{ici.get('collectives', 0)} collectives "
              f"({ici.get('duplex_us', 0):.1f} us modelled)")
    trace_info = None
    if args.trace:
        trace_path = engine.export_trace()
        summary = engine.tracer.summary()
        trace_info = {"path": trace_path, **summary}
        ph = summary["phase_us"]
        print(f"trace -> {trace_path}: "
              f"plan {ph.get('plan_us', 0.0):.0f}us / dispatch "
              f"{ph.get('dispatch_us', 0.0):.0f}us / reconcile "
              f"{ph.get('reconcile_us', 0.0):.0f}us host-clock, "
              f"{summary['events']} events over "
              f"{len(summary['duplex_util'])} channel tracks "
              f"({summary['model_us']:.1f}us modelled)")

    def _round(v):
        if isinstance(v, float):
            return round(v, 3)
        if isinstance(v, dict):
            return {k: _round(x) for k, x in v.items()}
        return v

    device_name = (torch.cuda.get_device_name(engine.device)
                   if engine.device.type == "cuda" else "cpu")
    report = {
        "arch": args.arch,
        "device": device_name,
        "policy": args.policy,
        "requests": args.requests,
        "tenants": tenant_names,
        "tiers": args.tiers,
        "slots": args.batch,
        "generated_tokens": int(total_tokens),
        "steps": int(engine.step_count),
        "megastep": args.megastep,
        "pipeline_depth": args.pipeline_depth,
        "mesh": ({"data": args.mesh[0], "model": args.mesh[1]}
                 if args.mesh else None),
        "host_dispatches": int(est["host_dispatches"]),
        "host_blocked": int(est["host_blocked"]),
        "wall_s": round(dt, 3),
        "tok_s": round(total_tokens / dt, 2),
        "faults_plan": args.faults,
        "faults": _round(est["faults"]),
        "failed_requests": {int(r.rid): r.error
                            for r in engine.failed.values()},
        "snapshot": _round(est["snapshot"]),
        "restore": restore_info,
        "paging": _round(engine.paging_stats()),
        "trace": _round(trace_info) if trace_info else None,
    }
    if args.telemetry:
        report["telemetry"] = _round(engine.telemetry.to_dict())
    print(json.dumps(report))

    if args.offload_demo:
        from repro_torch.runtime.serve import OffloadedKVCache
        kv = OffloadedKVCache(n_blocks=64, hbm_blocks=16,
                              block_shape=(16, 64), device=args.device)
        for b in range(64):                 # fill + spill real data to host
            kv.write_block(b, torch.ones((16, 64)) * b)
        for start in range(0, 48, 8):       # real ins co-issued with outs
            kv.touch(list(range(start, start + 8)))
        print("offload demo stats:", json.dumps(
            {k: round(v, 2) if isinstance(v, float) else v
             for k, v in kv.stats.items()}))
        print(f"duplex vs phase-separated paging: "
              f"{kv.duplex_speedup():.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
