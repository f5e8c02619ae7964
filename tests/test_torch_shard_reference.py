"""Port's ``ShardedServeEngine`` against the reference's own sharded engine
on a real (2, 2) mesh: the reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (four JAX host
devices, the reference's CI lane for ``tests/test_shard_serve.py``), under
a timeout of its own, and prints its runs as JSON; the port runs the same
workloads on a (2, 2) mesh of logical CPU ranks, on the same float32
weights and prompts. This is where the reference's ICI billing runs in
tier-1 (its multi-device tests skip on one device).

Cells: ring K = 4 depth 2, the mixed KV-store tenant, and a
``crash:@9`` run restored from its snapshot. Equal exactly: tokens,
admission/done steps and states, and the whole ``paging_stats()``
(``page_ins``, ``page_outs``, ``by_path`` with ``/serve/ici/model`` and
``/serve/ici/data``: bytes, collectives, duplex and serial µs; ``ici``,
``mesh``, tier stats per shard)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.models import registry as R  # noqa: E402
from repro_torch.core.faults import (CrashFault, FaultInjector,  # noqa: E402
                                     parse_fault_plan)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (EngineConfig, KVStoreTenant,  # noqa: E402
                               ShardedServeEngine)

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT_S = 300
ARCH = "smollm-135m"
BASE = dict(max_batch=4, cache_len=64, block_tokens=4, hbm_blocks=6,
            prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=2)
CELLS = {
    "ring": {},
    "mixed": dict(pool_blocks=96, hbm_blocks=14),
    "crash": dict(snapshot_every=2, tiers="ddr5:1,cxl:1"),
}
CRASH_AT = 9

# the cells' shared runner, run by both sides on their own mesh, with
# their package's ``engine_cls``/``cfg_cls``/``kv_cls``/``fx_mod``;
# ``run_cell`` returns the JSON-ready outcome
RUNNER = r'''
def prompts(vocab, n=5, prompt_len=6):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, prompt_len).astype(np.int32)
            for _ in range(n)]


def drive(eng, vocab, n):
    rids = [eng.submit(p, 8, arrival_step=2 * i).rid
            for i, p in enumerate(prompts(vocab, n))]
    eng.run(max_steps=600)
    return rids


def outcome(eng, rids):
    done = [eng.completed[r] for r in rids]
    return {"tokens": [[int(t) for t in r.generated] for r in done],
            "steps": [[r.admitted_step, r.done_step] for r in done],
            "states": [r.state for r in done],
            "paging": eng.paging_stats()}


def run_cell(cell, api, params, mesh, engine_cls, cfg_cls, kv_cls, fx_mod,
             base, cells, crash_at, snap_dir, **extra):
    vocab = api.cfg.vocab
    kw = {**base, **cells[cell], **extra}
    if cell == "crash":
        kw["snapshot_dir"] = snap_dir
        kw["faults"] = fx_mod.FaultInjector(
            fx_mod.parse_fault_plan(f"crash:@{crash_at}"))
        eng = engine_cls(api, params, cfg_cls(**kw), mesh=mesh)
        try:
            drive(eng, vocab, 4)
        except fx_mod.CrashFault:
            pass
        else:
            raise AssertionError("the crash did not fire")
        kw["faults"] = fx_mod.FaultInjector(
            fx_mod.parse_fault_plan(f"crash:@{crash_at}"))
        eng = engine_cls(api, params, cfg_cls(**kw), mesh=mesh)
        eng.restore()
        eng.run(max_steps=600)
        rids = sorted(eng.completed)
        return outcome(eng, rids)
    eng = engine_cls(api, params, cfg_cls(**kw), mesh=mesh)
    if cell == "mixed":
        kv = eng.add_tenant(kv_cls(n_slots=2, ops_per_step=2,
                                   store_blocks=16))
        kv.preload(8)
        kv.submit("sequential", n_steps=12)
    rids = drive(eng, vocab, 5 if cell == "ring" else 4)
    out = outcome(eng, rids)
    if cell == "mixed":
        out["ops_done"] = kv.ops_done
    return out
'''

REFERENCE = RUNNER + r'''
if __name__ == "__main__":
    import dataclasses, json, sys, tempfile
    import jax, jax.numpy as jnp
    from repro.core import faults as fx_mod
    from repro.launch.mesh import make_debug_mesh
    from repro.models import registry as R
    from repro.serve import EngineConfig, KVStoreTenant, ShardedServeEngine
    arch, base, cells, crash_at = json.loads(sys.argv[1])
    assert jax.device_count() >= 4, jax.devices()
    api0 = R.build(arch, smoke=True)
    api = R._lm_api(arch, dataclasses.replace(api0.cfg, dtype=jnp.float32))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          api0.init(jax.random.PRNGKey(0)))
    mesh = make_debug_mesh(2, devices=jax.devices()[:4])
    out = {}
    for cell in cells:
        with tempfile.TemporaryDirectory() as d:
            out[cell] = run_cell(cell, api, params, mesh,
                                 ShardedServeEngine, EngineConfig,
                                 KVStoreTenant, fx_mod, base, cells,
                                 crash_at, d)
    print(json.dumps(out, default=lambda o: o.item()))
'''

namespace = {"np": np}
exec(RUNNER, namespace)
run_cell = namespace["run_cell"]


class _Reference:
    """The reference's runs, started in a subprocess when first asked for
    and read back when the first test needs them."""

    def __init__(self, tmp: Path):
        script = tmp / "reference_shard_runs.py"
        script.write_text("import numpy as np\n" + REFERENCE)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(SRC), os.environ.get("PYTHONPATH", "")]))
        self._proc = subprocess.Popen(
            [sys.executable, str(script),
             json.dumps([ARCH, BASE, CELLS, CRASH_AT])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(tmp))
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            try:
                out, err = self._proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.communicate()
                raise AssertionError(
                    f"the reference's sharded runs took over {TIMEOUT_S} s")
            assert self._proc.returncode == 0, err[-4000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("reference_shard"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def port_model():
    """The reference's weights (``PRNGKey(0)``) in float32 on the port."""
    japi = R.build(ARCH, smoke=True)
    jp = japi.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(ARCH, tcfg, "cpu")
    return tapi, TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)


class _PortFaults:
    FaultInjector = FaultInjector
    parse_fault_plan = staticmethod(parse_fault_plan)
    CrashFault = CrashFault


def _json(obj):
    return json.loads(json.dumps(obj, default=lambda o: o.item()))


@pytest.mark.parametrize("cell", list(CELLS))
def test_2x2_equals_the_reference_sharded_engine(cell, reference,
                                                 port_model, tmp_path):
    api, params = port_model
    mesh = make_debug_mesh(2, devices=[torch.device("cpu")] * 4)
    got = _json(run_cell(cell, api, params, mesh, ShardedServeEngine,
                         EngineConfig, KVStoreTenant, _PortFaults, BASE,
                         CELLS, CRASH_AT, str(tmp_path), device="cpu"))
    want = reference.result()[cell]
    assert got["tokens"] == want["tokens"]
    assert got["steps"] == want["steps"]
    assert got["states"] == want["states"]
    gp, wp = got["paging"], want["paging"]
    for key in ("page_ins", "page_outs", "mesh", "ici"):
        assert gp[key] == wp[key], key
    assert gp["by_path"] == wp["by_path"]
    assert gp["by_path"]["/serve/ici/model"]["bytes"] > 0
    assert gp["by_path"]["/serve/ici/data"]["bytes"] > 0
    assert gp == wp
    assert got.get("ops_done") == want.get("ops_done")
