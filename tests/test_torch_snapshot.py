"""Port's crash-consistency layer against ``repro.serve.snapshot``: the
reference's scenarios (``tests/test_snapshot.py`` without the sharded
engine) served by both packages with smollm-135m SMOKE in float32 on the
same arguments. A run killed by ``crash:@S`` and restored into a fresh
engine gives the signature of its uncrashed twin — tokens, admission and
done steps, failed records, per-channel billing, fault stats — and the
port's signature equals the reference's, at K × depth 1×1, 4×1, 4×2 and
8×2, on a tiered pool, across segmented runs, after a torn snapshot and
under a short chaos soak; a truncated journal gives the reference's
casualties, an unrecoverable directory raises in both, and the crash
report helpers agree. Rids are process-wide counters in both packages,
so engines are joined by submission order, never by rid value. Also: a
restore writes the engine's slot state, cache and pool tensors in place
(the same tensor objects and storage before and after, which a captured
CUDA graph needs), a port snapshot has the reference's tree layout, and
each package restores a snapshot the other wrote, journal replay
included."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import snapshot as jsnap  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve import snapshot as tsnap  # noqa: E402

ARCH = "smollm-135m"
N_REQ, PROMPT_LEN, GEN = 4, 6, 10

PROMPTS = np.random.default_rng(77).integers(
    0, 256, (6, PROMPT_LEN)).astype(np.int32)


@pytest.fixture(scope="module")
def sides():
    """(reference side, port side): each (engine class, config class,
    faults module, snapshot module, api, params), the same f32 weights."""
    japi0 = R.build(ARCH, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(0))
    japi = R._lm_api(ARCH, dataclasses.replace(japi0.cfg,
                                               dtype=jnp.float32))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(ARCH, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    return ((JaxServeEngine, JaxEngineConfig, jfaults, jsnap, japi, jp32),
            (ServeEngine, EngineConfig, tfaults, tsnap, tapi, tp))


def _engine(side, plan=None, seed=0, _graphs=None, **kw):
    """The reference test's engine (``_cfg``), with an injector on
    ``plan`` (a spec string or events) when given."""
    engine_cls, cfg_cls, fmod, _, api, params = side
    base = dict(max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
                prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=2)
    base.update(kw)
    if plan is not None:
        events = fmod.parse_fault_plan(plan) if isinstance(plan, str) \
            else plan
        base["faults"] = fmod.FaultInjector(events, seed=seed)
    if cfg_cls is EngineConfig:
        base["device"] = "cpu"
        return engine_cls(api, params, cfg_cls(**base), _graphs=_graphs)
    return engine_cls(api, params, cfg_cls(**base))


def _submit_all(eng, n=N_REQ):
    return [eng.submit(PROMPTS[i], GEN, arrival_step=2 * i)
            for i in range(n)]


def _segmented(eng):
    """Two run() calls, the second batch submitted between them."""
    [eng.submit(PROMPTS[i], GEN, arrival_step=2 * i) for i in range(4)]
    eng.run(max_steps=600)
    [eng.submit(PROMPTS[i], 8, arrival_step=eng.step_count) for i in (4, 5)]
    eng.run(max_steps=600)


_BILLING_KEYS = ("duplex_us", "serial_us", "page_ins", "page_outs",
                 "kernel_calls")


def _signature(eng):
    """The reference test's ``_signature``: everything a bit-exact resume
    must reproduce, keyed by submission order; per-channel billing."""
    toks = [list(eng.completed[rid].generated)
            for rid in sorted(eng.completed)]
    timing = [(eng.completed[rid].admitted_step,
               eng.completed[rid].done_step)
              for rid in sorted(eng.completed)]
    errors = sorted((r.error["kind"], r.error.get("block", -1))
                    for r in eng.failed.values())
    ps = eng.paging_stats()
    billing = {k: ps.get(k) for k in _BILLING_KEYS}
    billing["by_path"] = {
        path: {k: st[k] for k in ("duplex_us", "serial_us")}
        for path, st in ps["by_path"].items()}
    if ps.get("tiers"):
        billing["tiers"] = {
            name: {k: ch[k] for k in ("busy_us", "read_bytes",
                                      "write_bytes")}
            for name, ch in ps["tiers"]["channels"].items()}
    return toks, timing, errors, billing, dict(eng.stats()["faults"])


def _crash(side, d, crash_at, drive=_submit_all, **kw):
    """Drive until ``crash:@crash_at`` kills the engine."""
    eng = _engine(side, f"crash:@{crash_at}", snapshot_dir=str(d), **kw)
    with pytest.raises(side[2].CrashFault):
        drive(eng)
        eng.run(max_steps=600)
    return str(d)


def _steps(d):
    return sorted(int(p.rsplit("_", 1)[1]) for p in glob.glob(d + "/step_*"))


def _tear(d, step, shard, at, data):
    with open(os.path.join(d, f"step_{step:09d}", f"shard_{shard:03d}.npz"),
              "r+b") as f:
        f.seek(at)
        f.write(data)


# -- the crash grammar and the injector -----------------------------------------

def test_disarm_crashes_equals_reference():
    spec = "crash:@2,crash:@9,poison:0@4,crash:@5"
    fx = {m: m.FaultInjector(m.parse_fault_plan(spec))
          for m in (jfaults, tfaults)}
    for m, f in fx.items():
        f.tick(), f.tick()
    got = [fx[tfaults].disarm_crashes(after=5), fx[tfaults].disarm_crashes()]
    want = [fx[jfaults].disarm_crashes(after=5), fx[jfaults].disarm_crashes()]
    assert got == want == [2, 1]
    assert [dataclasses.asdict(e) for e in fx[tfaults].events] == \
        [dataclasses.asdict(e) for e in fx[jfaults].events]
    assert fx[tfaults]._cursor == fx[jfaults]._cursor
    for f in fx.values():
        for _ in range(12):
            f.tick()                      # no crash left to fire
    assert fx[tfaults].stats == fx[jfaults].stats


def test_rid_counter_peeks_and_only_seeks_forward():
    from repro_torch.serve.queue import _RidCounter
    c = _RidCounter(5)
    assert [next(c), next(c), c.peek()] == [5, 6, 7]
    c.seek(3)
    assert c.peek() == 7
    c.seek(20)
    assert next(c) == 20


# -- a disabled engine ------------------------------------------------------------

def test_disabled_engine_has_no_hooks(sides):
    eng = _engine(sides[1])
    assert eng._snap is None
    assert eng.stats()["snapshot"] == tsnap.fresh_snapshot_stats() == \
        jsnap.fresh_snapshot_stats()
    with pytest.raises(ValueError, match="snapshot"):
        eng.restore()


@pytest.mark.parametrize("kw", [dict(snapshot_every=2),
                                dict(snapshot_every=2, snapshot_dir="D",
                                     paging=False)])
def test_construction_errors_equal_reference(sides, kw, tmp_path):
    if "snapshot_dir" in kw:
        kw = dict(kw, snapshot_dir=str(tmp_path))
    errs = []
    for side in sides:
        with pytest.raises(ValueError) as e:
            _engine(side, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_snapshots_change_billing_but_not_tokens(sides, tmp_path):
    """The flush is billed, so snapshots change the billing and never the
    served tokens or the admission timing; both packages bill the same."""
    sig = {}
    for name, side in zip("jt", sides):
        e0 = _engine(side)
        _submit_all(e0)
        e0.run(max_steps=600)
        e1 = _engine(side, snapshot_every=2,
                     snapshot_dir=str(tmp_path / name))
        _submit_all(e1)
        e1.run(max_steps=600)
        assert e1.stats()["snapshot"]["snapshots_taken"] > 0
        s0, s1 = _signature(e0), _signature(e1)
        assert s0[:2] == s1[:2]
        assert s1[3]["page_outs"] > s0[3]["page_outs"]
        sig[name] = (s0, s1, e1.stats()["snapshot"])
    assert sig["t"] == sig["j"]


# -- bit-exact restore --------------------------------------------------------------

def _crash_restore(side, tmp, crash_at, every=2, disarm=True, **kw):
    """(uncrashed signature, restored signature, restore report, snapshot
    stats of the restored run, restored engine)."""
    ref = _engine(side, [], snapshot_every=every,
                  snapshot_dir=str(tmp / "ref"), **kw)
    _submit_all(ref)
    ref.run(max_steps=600)
    d = _crash(side, tmp / "crash", crash_at, snapshot_every=every, **kw)
    eng = _engine(side, f"crash:@{crash_at}", snapshot_every=every,
                  snapshot_dir=d, **kw)
    info = eng.restore()
    eng.run(max_steps=600)
    eng.pool.check_invariants()
    return _signature(ref), _signature(eng), info, eng.stats()["snapshot"], \
        eng


@pytest.mark.parametrize("k,depth", [(1, 1), (4, 1), (4, 2), (8, 2)])
def test_crash_restore_bit_exact(sides, tmp_path, k, depth):
    out = {}
    for name, side in zip("jt", sides):
        out[name] = _crash_restore(side, tmp_path / name, 9, megastep=k,
                                   pipeline_depth=depth)[:4]
    ref_sig, sig, info, stats = out["t"]
    assert sig == ref_sig
    assert info["restored_step"] >= 0
    assert out["t"] == out["j"]


def test_tiered_restore_bills_identically(sides, tmp_path):
    out = {}
    for name, side in zip("jt", sides):
        out[name] = _crash_restore(side, tmp_path / name, 7,
                                   tiers="ddr5:1,cxl:2")[:4]
    assert out["t"][1] == out["t"][0]
    assert out["t"][1][3]["tiers"]
    assert out["t"] == out["j"]


def test_restore_writes_the_engines_tensors_in_place(sides, tmp_path):
    """A restore copies into ``_dev``, ``cache`` and the pool's tensors:
    the same objects with the same storage before and after, as the step
    graphs captured over them on a CUDA device need; the graphs' CPU
    bookkeeping (direct calls in place of replays) serves the restored
    run bit-exactly."""
    side = sides[1]
    ref = _engine(side, [], snapshot_every=2, snapshot_dir=str(tmp_path / "r"))
    _submit_all(ref)
    ref.run(max_steps=600)
    d = _crash(side, tmp_path / "c", 9, snapshot_every=2)
    eng = _engine(side, "crash:@9", snapshot_every=2, snapshot_dir=d,
                  _graphs=True)

    def tensors():
        return [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
                eng.pool.host_q, eng.pool.host_scale]

    before = [(t, t.data_ptr()) for t in tensors()]
    eng.restore()
    assert all(a is t and p == t.data_ptr()
               for (a, p), t in zip(before, tensors()))
    assert eng.graphs._cache is eng.cache and eng.graphs._dev is eng._dev
    assert int(eng._dev["state"].abs().sum()) > 0   # the cut's rows landed
    eng.run(max_steps=600)
    assert all(a is t and p == t.data_ptr()
               for (a, p), t in zip(before, tensors()))
    assert _signature(eng) == _signature(ref)


def test_segmented_runs_replay_journaled_submits(sides, tmp_path):
    out = {}
    for name, side in zip("jt", sides):
        ref = _engine(side, [], snapshot_every=4,
                      snapshot_dir=str(tmp_path / name / "ref"))
        _segmented(ref)
        d = _crash(side, tmp_path / name / "crash", 24, drive=_segmented,
                   snapshot_every=4)
        steps = _steps(d)
        _tear(d, steps[-1], 1, 100, b"\x00" * 64)
        eng = _engine(side, "crash:@24", snapshot_every=4, snapshot_dir=d)
        info = eng.restore()
        assert info["restored_step"] < steps[-1]
        eng.run(max_steps=600)
        assert eng.stats()["snapshot"]["resubmitted"] > 0
        assert _signature(eng) == _signature(ref)
        out[name] = (_signature(eng), info, eng.stats()["snapshot"])
    assert out["t"] == out["j"]


def test_replay_is_verified_against_the_journal(sides, tmp_path):
    out = {}
    for name, side in zip("jt", sides):
        d = _crash(side, tmp_path / name, 15, snapshot_every=4)
        _tear(d, _steps(d)[-1], 0, 80, b"\xff" * 32)
        eng = _engine(side, "crash:@15", snapshot_every=4, snapshot_dir=d)
        info = eng.restore()
        assert info["journal_entries"] > 0
        eng.run(max_steps=600)
        assert eng.stats()["snapshot"]["restore_replayed"] > 0
        out[name] = (info, eng.stats()["snapshot"], _signature(eng))
    assert out["t"] == out["j"]


def test_a_doctored_journal_digest_fails_the_replay(sides, tmp_path):
    """A boundary record whose token digest was changed (and re-framed,
    so its crc holds) makes the port's replay raise ``SnapshotError``."""
    side = sides[1]
    d = _crash(side, tmp_path, 15, snapshot_every=4)
    _tear(d, _steps(d)[-1], 0, 80, b"\xff" * 32)
    m = _steps(d)[-1 if len(_steps(d)) == 1 else -2]
    path = os.path.join(d, "journal-%09d.jsonl" % m)
    lines = open(path).read().splitlines()
    i = next(i for i, ln in enumerate(lines)
             if json.loads(ln[9:])["t"] == "b")
    rec = json.loads(lines[i][9:])
    rec["tok"] = "%08x" % (int(rec["tok"], 16) ^ 1)
    lines[i] = tsnap._frame(tsnap._canon(rec))
    open(path, "w").write("\n".join(lines) + "\n")
    eng = _engine(side, "crash:@15", snapshot_every=4, snapshot_dir=d)
    eng.restore()
    with pytest.raises(tsnap.SnapshotError, match="replay diverged"):
        eng.run(max_steps=600)


# -- corruption ------------------------------------------------------------------

def test_torn_snapshot_falls_back_to_previous_cut(sides, tmp_path):
    out = {}
    for name, side in zip("jt", sides):
        ref = _engine(side, [], snapshot_every=2,
                      snapshot_dir=str(tmp_path / name / "ref"))
        _submit_all(ref)
        ref.run(max_steps=600)
        d = _crash(side, tmp_path / name / "crash", 9, snapshot_every=2)
        newest = _steps(d)[-1]
        _tear(d, newest, 1, 64, b"\x00" * 64)
        assert side[3].newest_valid_snapshot(d) < newest
        eng = _engine(side, "crash:@9", snapshot_every=2, snapshot_dir=d)
        info = eng.restore()
        assert info["restored_step"] < newest
        eng.run(max_steps=600)
        assert _signature(eng) == _signature(ref)
        out[name] = (info, _signature(eng))
    assert out["t"] == out["j"]


def test_truncated_journal_fails_requests_past_the_tear(sides, tmp_path):
    out = {}
    for name, side in zip("jt", sides):
        ref = _engine(side, [], snapshot_every=4,
                      snapshot_dir=str(tmp_path / name / "ref"))
        _segmented(ref)
        ref_sig = _signature(ref)
        d = _crash(side, tmp_path / name / "crash", 24, drive=_segmented,
                   snapshot_every=4)
        # corrupt the line right before the second batch's first submit
        # record and tear the snapshots after that generation
        tgt = idx = None
        for j in sorted(glob.glob(d + "/journal-*.jsonl")):
            lines = open(j).read().splitlines()
            for i, line in enumerate(lines):
                if json.loads(line[9:])["t"] == "s":
                    tgt, idx = j, i
                    break
            if tgt:
                break
        assert tgt is not None and idx > 0
        lines = open(tgt).read().splitlines()
        lines[idx - 1] = lines[idx - 1][:-4] + "XXXX"
        with open(tgt, "w") as f:
            f.write("\n".join(lines) + "\n")
        gen = int(os.path.basename(tgt)[len("journal-"):-len(".jsonl")])
        for st in _steps(d):
            if st > gen:
                _tear(d, st, 0, 50, b"\xff" * 32)
        eng = _engine(side, "crash:@24", snapshot_every=4, snapshot_dir=d)
        info = eng.restore()
        assert info["casualties"] == 2
        eng.run(max_steps=600)
        cas = [r for r in eng.failed.values() if r.error["kind"] == "crash"]
        assert len(cas) == 2
        for r in cas:
            assert r.error["step"] == info["restored_step"]
            assert r.prompt.size > 0
        toks = [list(eng.completed[rid].generated)
                for rid in sorted(eng.completed)]
        assert toks == ref_sig[0][:len(toks)]
        out[name] = (info, [(r.error, r.done_step, r.prompt.tolist())
                            for r in sorted(cas, key=lambda r: r.rid)],
                     toks, eng.stats()["snapshot"])
    assert out["t"] == out["j"]


def test_unrecoverable_directory_raises(sides, tmp_path):
    for name, side in zip("jt", sides):
        d = _crash(side, tmp_path / name, 9, snapshot_every=2)
        for p in glob.glob(d + "/step_*/shard_*.npz"):
            with open(p, "r+b") as f:
                f.seek(10)
                f.write(b"\x00" * 32)
        assert side[3].newest_valid_snapshot(d) is None
        eng = _engine(side, "crash:@9", snapshot_every=2, snapshot_dir=d)
        with pytest.raises(IOError):
            eng.restore()


def test_crash_report_helpers(sides, tmp_path):
    got = []
    for name, side in zip("jt", sides):
        d = _crash(side, tmp_path / name, 9, snapshot_every=2)
        snap = side[3]
        step = snap.newest_valid_snapshot(d)
        assert step is not None and step % 2 == 0
        got.append((step, snap.journal_length(d),
                    snap.journal_length(d, from_step=step)))
        assert snap.newest_valid_snapshot(str(tmp_path / "nope")) is None
        assert snap.journal_length(str(tmp_path / "nope")) == 0
    assert got[0] == got[1]
    assert got[1][1] >= got[1][2] >= 0


def test_snapshot_tree_layout_equals_reference(sides, tmp_path):
    """The first cut of the same run, written by each package: the same
    leaf paths (requests joined by submission order), shapes and dtypes,
    and equal json leaves but for rids and the pool's float billing."""
    manifests = []
    for name, side in zip("jt", sides):
        eng = _engine(side, [], snapshot_every=2,
                      snapshot_dir=str(tmp_path / name))
        _submit_all(eng)
        eng.run(max_steps=600)
        d = str(tmp_path / name)
        with open(os.path.join(d, "step_%09d" % _steps(d)[0],
                               "manifest.json")) as f:
            m = json.load(f)["leaves"]
        rids = sorted({int(p.split("/")[1][1:]) for p in m
                       if p.startswith("requests/")})
        order = {f"r{rid}": f"r#{i}" for i, rid in enumerate(rids)}
        manifests.append({
            "/".join(order.get(x, x) for x in p.split("/")):
                (v["shape"] if not p.endswith("meta") else None, v["dtype"])
            for p, v in m.items()})
    assert manifests[0] == manifests[1]
    assert manifests[1]["pool/hbm"][1] == "bfloat16"


# -- chaos -------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1347])
def test_soak_crash_restore_cycles(sides, tmp_path, seed):
    """The reference's chaos soak: a random plan mixing crashes
    with the recoverable kinds on a tiered pool; every restore keeps the
    pool's invariants, and the survivors equal the same plan without its
    crashes — in both packages, with equal signatures."""
    out = {}
    for name, side in zip("jt", sides):
        fmod = side[2]
        plan = fmod.random_plan(seed, n_channels=3, n_blocks=24, horizon=20,
                                n_events=8, kinds=fmod.ALL_FAULT_KINDS)
        calm = [e for e in plan if e.kind != "crash"]
        kw = dict(tiers="ddr5:1,cxl:2", snapshot_every=2, seed=seed)
        ref = _engine(side, calm, snapshot_dir=str(tmp_path / name / "r"),
                      **kw)
        _submit_all(ref)
        ref.run(max_steps=600)
        d = str(tmp_path / name / "soak")
        eng = _engine(side, plan, snapshot_dir=d, **kw)
        _submit_all(eng)
        restores = 0
        while True:
            try:
                eng.run(max_steps=600)
                break
            except fmod.CrashFault as e:
                restores += 1
                assert restores <= len(plan) + 1
                eng = _engine(side, plan, snapshot_dir=d, **kw)
                eng.restore(disarm_crashes=False)
                eng._fx.disarm_crashes(after=e.at_step)
                eng.pool.check_invariants()
        assert restores > 0
        assert _signature(eng) == _signature(ref)
        eng.pool.check_invariants()
        out[name] = (restores, _signature(eng))
    assert out["t"] == out["j"]


# -- across the packages ---------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("k,depth,tiers", [(1, 1, None), (4, 2, None),
                                           (4, 2, "ddr5:1,cxl:2")])
def test_each_package_restores_the_others_snapshot(sides, tmp_path, writer,
                                                   k, depth, tiers):
    """A run killed by ``crash:@9`` under one package resumes under the
    other from the dead run's directory (the same weights and config),
    bit-exactly: the restoring package's signature equals its own
    uncrashed run's."""
    kw = dict(megastep=k, pipeline_depth=depth, tiers=tiers,
              snapshot_every=2)
    dead, live = sides if writer == "reference" else sides[::-1]
    ref = _engine(live, [], snapshot_dir=str(tmp_path / "ref"), **kw)
    _submit_all(ref)
    ref.run(max_steps=600)
    d = _crash(dead, tmp_path / "crash", 9, **kw)
    eng = _engine(live, "crash:@9", snapshot_dir=d, **kw)
    assert eng.restore()["restored_step"] > 0
    eng.run(max_steps=600)
    assert _signature(eng) == _signature(ref)
    eng.pool.check_invariants()


def test_port_replays_the_references_journal(sides, tmp_path):
    """The reference's journal drives the port's replay: with the newest
    reference snapshot torn, the port restores the cut before it and
    verifies every journaled boundary (digests keyed by the reference's
    rids, which the restored requests keep)."""
    j, t = sides
    d = _crash(j, tmp_path / "crash", 15, snapshot_every=4)
    _tear(d, _steps(d)[-1], 0, 80, b"\xff" * 32)
    ref = _engine(t, [], snapshot_every=4, snapshot_dir=str(tmp_path / "r"))
    _submit_all(ref)
    ref.run(max_steps=600)
    eng = _engine(t, "crash:@15", snapshot_every=4, snapshot_dir=d)
    assert eng.restore()["journal_entries"] > 0
    eng.run(max_steps=600)
    assert eng.stats()["snapshot"]["restore_replayed"] > 0
    assert _signature(eng) == _signature(ref)
