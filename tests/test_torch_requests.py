"""Port's request-stream generators against ``repro.core.requests``: the
five deterministic patterns bit-equal as float32, the Redis pattern mixes
equal; ``gaussian`` draws from numpy instead of ``jax.random`` (the port
cannot reproduce JAX's bits), so only its shape, type, bounds and
determinism are checked."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import requests as jreq  # noqa: E402
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


def test_gaussian_shape_bounds_and_determinism():
    """``gaussian`` cannot be bit-equal (its jitter comes from
    ``jax.random`` in the reference), so: float32 (steps, streams, 2),
    non-negative, load within [0.25, 2] x offered, and the same numbers
    for the same seed."""
    specs = treq.redis_pattern_specs("gaussian", offered_gbps=16.0,
                                     n_streams=4)
    a = treq.generate(specs, 200, seed=5)
    assert a.dtype == np.float32 and a.shape == (200, 4, 2)
    per = specs[0].offered_gbps * 1e3
    load = a.sum(axis=-1)
    assert (a >= 0).all()
    assert (load >= 0.25 * per * (1 - 1e-6)).all()
    assert (load <= 2.0 * per * (1 + 1e-6)).all()
    np.testing.assert_array_equal(a, treq.generate(specs, 200, seed=5))
    assert not np.array_equal(a, treq.generate(specs, 200, seed=6))
