"""``python -m repro_torch.examples.multi_tenant_serve`` against the
reference's ``examples/multi_tenant_serve.py``, imported by its file path
and run on the CPU beside it, both on smollm-135m's SMOKE config in
float32 with the same weights (the reference's seed-0 init, converted by
``params_from_jax``) and the same prompts (its ``jax.random`` draws).

Held exactly, as the printed lines: the LLM requests' admission and done
steps and tokens, the KV store's block-op and value-block counts, the
vector search's query count, the pool's page-ins and page-outs and
speedup, every hint scope's paging and speedup with the withdrawn
``/serve/redis/read_heavy`` scope marked, and the static-batch check.
The tenants' values are ``sin`` of float32 iotas in bf16, one bf16 ulp
apart in rare places across frameworks (ROADMAP Queue 3): the store's
checksum and the best distances within rtol 1e-4 (plus the printed
rounding). Then the port's example runs whole with ``--device cpu`` in a
subprocess."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as R  # noqa: E402
from repro_torch.examples import multi_tenant_serve as ex  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEAR = ("redis: ", "vectordb: ")


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_multi_tenant_serve",
        ROOT / "examples" / "multi_tenant_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    japi0 = R.build(ex.ARCH, smoke=True)
    japi = R._lm_api(ex.ARCH, dataclasses.replace(japi0.cfg,
                                                  dtype=jnp.float32))
    mod = _reference_example()
    mod.R = types.SimpleNamespace(build=lambda arch, smoke: japi)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    want = out.getvalue().splitlines()

    jp = japi.init(jax.random.PRNGKey(0))       # as the example draws it
    tcfg = dataclasses.replace(TR.build(ex.ARCH, smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tapi = TR._lm_api(ex.ARCH, tcfg, "cpu")
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 6), 0, japi.cfg.vocab))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        served = ex.serve(tapi, tp, prompts)
    return want, out.getvalue().splitlines(), served


def test_every_exact_line_equals_the_reference(runs):
    want, got, served = runs
    assert len(got) == len(want)
    exact = [(g, w) for g, w in zip(got, want) if not w.startswith(NEAR)]
    assert [g for g, _ in exact] == [w for _, w in exact]
    assert len(exact) == len(want) - 2
    assert served["ok"]
    assert served["withdrawn"] == ["/serve/redis/read_heavy"]
    assert any(x.endswith("(withdrawn)") for x in got)


def _numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", line)]


def test_tenant_results_near_the_reference(runs):
    want, got, served = runs
    for prefix in NEAR:
        w = next(x for x in want if x.startswith(prefix))
        g = next(x for x in got if x.startswith(prefix))
        # counts exact; values within rtol 1e-4 plus the printed rounding
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-4,
                                   atol=0.011)
    assert served["kv"].ops_done > 0 and served["vec"].queries_done == 4


def test_every_scope_pages_as_the_reference(runs):
    """The per-scope table: the withdrawn scope has page traffic, no
    fused call and a speedup of exactly 1."""
    _, _, served = runs
    st = served["engine"].paging_stats()
    rh = st["by_path"]["/serve/redis/read_heavy"]
    assert rh["page_ins"] + rh["page_outs"] > 0
    assert rh["fused_calls"] == 0 and rh["duplex_us"] == rh["serial_us"]
    json.dumps(st)                     # host numbers only


def test_runs_whole_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")   # one thread beside the workers
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.multi_tenant_serve",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "staggered multi-tenant == static-batch reference: True"
