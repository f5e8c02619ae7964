"""Port's request-stream generators against ``repro.core.requests``: the
five deterministic patterns bit-equal as float32, the Redis pattern mixes
equal; ``gaussian`` draws the reference's threefry bits and uniforms bit
for bit (``core/prng.py`` against ``jax.random``), its normals within 3
float32 ulps, and ``generate``'s arrays within 4 ulps of the stream's
per-step load; a ``gaussian`` KV-store request gets the reference's op
schedule and ``/serve/redis/gaussian`` billing exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import requests as jreq  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import requests as treq  # noqa: E402

DETERMINISTIC = ("uniform", "phased", "pipelined", "llm_decode", "hnsw")


def _specs(mod, pattern):
    return [mod.StreamSpec(name=f"s{i}", pattern=pattern, offered_gbps=gb,
                           read_fraction=rf, phase_steps=ps)
            for i, (gb, rf, ps) in enumerate([(8.0, 0.5, 64),
                                              (4.0, 10 / 11, 8),
                                              (2.5, 1 / 11, 5),
                                              (16 / 3, 0.3, 2)])]


@pytest.mark.parametrize("pattern", DETERMINISTIC)
def test_generate_bit_equal_to_the_reference(pattern):
    want = np.asarray(jreq.generate(_specs(jreq, pattern), 100, seed=3))
    got = treq.generate(_specs(treq, pattern), 100, seed=3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("pattern", ["read_heavy", "write_heavy",
                                     "pipelined", "sequential", "gaussian"])
def test_redis_pattern_specs_equal(pattern):
    fields = ("name", "pattern", "offered_gbps", "read_fraction",
              "phase_steps", "block_bytes", "sequential", "hint")
    for kw in ({}, {"offered_gbps": 16.0, "n_streams": 4}):
        want = jreq.redis_pattern_specs(pattern, **kw)
        got = treq.redis_pattern_specs(pattern, **kw)
        assert [[getattr(s, f) for f in fields] for s in got] == \
            [[getattr(s, f) for f in fields] for s in want]


def test_hint_read_fractions_equal():
    specs = treq.redis_pattern_specs("read_heavy") \
        + treq.redis_pattern_specs("sequential")
    jspecs = jreq.redis_pattern_specs("read_heavy") \
        + jreq.redis_pattern_specs("sequential")
    np.testing.assert_array_equal(treq.hint_read_fractions(specs),
                                  np.asarray(jreq.hint_read_fractions(jspecs)))


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("draw", ["key", "bits", "uniform", "normal"])
@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_threefry_equals_jax_random(draw, seed):
    """``PRNGKey`` / ``fold_in`` keys, ``bits`` and ``uniform`` bit-equal
    to ``jax.random``; ``normal`` within 3 float32 ulps (XLA's ``log1p``
    and FMA contraction set its last bits) and equal on most draws."""
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    for i in (0, 1, 7):
        jki, tki = jax.random.fold_in(jk, i), prng.fold_in(tk, i)
        if draw == "key":
            assert np.asarray(jk).tolist() == tk.tolist()
            assert np.asarray(jki).tolist() == tki.tolist()
        elif draw == "bits":
            np.testing.assert_array_equal(
                prng.bits(tki, (5, 400)),
                np.asarray(jax.random.bits(jki, (5, 400), jnp.uint32)))
        elif draw == "uniform":
            lo = np.nextafter(np.float32(-1), np.float32(0))
            for a, b in ((0.0, 1.0), (lo, 1.0)):
                want = np.asarray(jax.random.uniform(jki, (20000,),
                                                     minval=a, maxval=b))
                got = prng.uniform(tki, (20000,), a, b)
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))
        else:
            want = np.asarray(jax.random.normal(jki, (20000,)))
            d = _ulps(prng.normal(tki, (20000,)), want)
            assert d.max() <= 3 and (d == 0).mean() > 0.9


@pytest.mark.parametrize("seed", [0, 4, 5, 11])
@pytest.mark.parametrize("kw", [{}, {"offered_gbps": 16.0, "n_streams": 4}])
def test_gaussian_generate_within_ulps_of_the_reference(seed, kw):
    """``gaussian`` arrays within 4 float32 ulps of the stream's per-step
    load (``rf`` near 0 or 1 cancels, so a relative ulp count of the
    output says nothing there); deterministic in the seed."""
    specs = treq.redis_pattern_specs("gaussian", **kw)
    want = np.asarray(jreq.generate(jreq.redis_pattern_specs(
        "gaussian", **kw), 200, seed=seed))
    got = treq.generate(specs, 200, seed=seed)
    assert got.dtype == np.float32 and got.shape == want.shape
    per = np.float32(specs[0].offered_gbps * 1e3)
    assert np.abs(got - want).max() <= 4 * np.spacing(per)
    np.testing.assert_array_equal(got, treq.generate(specs, 200, seed=seed))


def test_gaussian_kv_request_equals_the_reference():
    """A ``gaussian`` KV-store request: the reference's per-step (gets,
    sets) schedule, traffic profile, and ``/serve/redis/gaussian``
    billing."""
    from repro.models import registry as R
    from repro.serve import EngineConfig as JCfg
    from repro.serve import KVStoreTenant as JKV
    from repro.serve import ServeEngine as JEngine
    from repro_torch.models import registry as TR
    from repro_torch.models import transformer as TT
    from repro_torch.serve import EngineConfig, KVStoreTenant, ServeEngine

    japi0 = R.build("smollm-135m", smoke=True)
    jp = japi0.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(TR.build("smollm-135m", smoke=True,
                                        device="cpu").cfg,
                               dtype=torch.float32)
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    kw = dict(max_batch=2, cache_len=64, block_tokens=4, hbm_blocks=10,
              pool_blocks=64, prefill_chunk=2, max_queue=16)
    je = JEngine(japi0, jp, JCfg(**kw))
    te = ServeEngine(TR._lm_api("smollm-135m", tcfg, "cpu"), tp,
                     EngineConfig(**kw, device="cpu"))
    jkv = je.add_tenant(JKV(n_slots=2, ops_per_step=2, store_blocks=16))
    tkv = te.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                      store_blocks=16))
    for i in range(3):
        jr = jkv.submit("gaussian", n_steps=40, arrival_step=2 * i)
        tr = tkv.submit("gaussian", n_steps=40, arrival_step=2 * i)
        np.testing.assert_array_equal(tr.work.schedule, jr.work.schedule)
        for f in ("backlog_read", "backlog_write", "head_read",
                  "head_write"):
            np.testing.assert_allclose(getattr(tr.profile, f),
                                       getattr(jr.profile, f), rtol=1e-6)
    je.run(max_steps=300)
    te.run(max_steps=300)
    assert tkv.ops_done == jkv.ops_done > 0
    want = je.paging_stats()["by_path"]["/serve/redis/gaussian"]
    assert te.paging_stats()["by_path"]["/serve/redis/gaussian"] == want
    assert want["page_ins"] > 0 and want["page_outs"] > 0
