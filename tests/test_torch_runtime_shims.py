"""The port's deprecated serving shims (``repro_torch.runtime.serve``:
``ServeConfig``, ``DecodeServer``, ``OffloadedKVCache``) against the
reference's (``repro.runtime.serve``) on ``tests/test_runtime.py``'s
cases: the same ``DeprecationWarning``s at the caller's line (their text
with the package renamed), ``DecodeServer.generate`` token-equal to the
reference's on the same float32 weights, the per-block adapter's int8
round trip within the quantization bound and its paging stats equal to
the reference's, exactly, and the same LRU order. Then the serve CLI's
``--offload-demo``: its JSON report and the demo's stats and speedup
lines equal the reference CLI's, field for field (wall clock and
``device`` left out, as ``test_torch_cli.py`` does)."""

import contextlib
import dataclasses
import io
import json
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.runtime import serve as jshim  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as tshim  # noqa: E402

ARCH = "smollm-135m"
UNCOMPARED = {"wall_s", "tok_s", "device"}


def _f32_pair():
    """The SMOKE model in float32 in both packages, on the reference's
    seed-0 weights."""
    japi0 = R.build(ARCH, smoke=True)
    jp = japi0.init(jax.random.PRNGKey(0))
    japi = R._lm_api(ARCH, dataclasses.replace(japi0.cfg,
                                               dtype=jnp.float32))
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True, device="cpu").cfg,
                               dtype=torch.float32)
    tp = TT.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg)
    return (japi, jax.tree.map(lambda a: a.astype(jnp.float32), jp),
            TR._lm_api(ARCH, tcfg, "cpu"), tp)


def _warned(make) -> warnings.WarningMessage:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        make()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1
    return dep[0]


def test_shims_warn_as_the_reference_at_the_callers_line():
    api = TR.build(ARCH, smoke=True, device="cpu")
    for jmake, tmake, needle in [
            (lambda: jshim.DecodeServer(R.build(ARCH, smoke=True), None,
                                        jshim.ServeConfig()),
             lambda: tshim.DecodeServer(api, None, tshim.ServeConfig()),
             "ServeEngine"),
            (lambda: jshim.OffloadedKVCache(4, 2, (4, 4)),
             lambda: tshim.OffloadedKVCache(4, 2, (4, 4), device="cpu"),
             "PagedKVPool")]:
        want, got = _warned(jmake), _warned(tmake)
        assert str(got.message) == str(want.message).replace(
            "repro.", "repro_torch.")
        assert needle in str(got.message)
        assert got.filename == __file__          # stacklevel=2 -> caller


def test_serve_config_equals_the_reference():
    assert dataclasses.asdict(tshim.ServeConfig()) == \
        dataclasses.asdict(jshim.ServeConfig())


@pytest.fixture(scope="module")
def pair():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield _f32_pair()


def test_decode_server_generates_the_reference_tokens(pair):
    japi, jp, tapi, tp = pair
    prompts = np.random.default_rng(2).integers(
        0, tapi.cfg.vocab, (3, 5)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jsrv = jshim.DecodeServer(japi, jp, jshim.ServeConfig(cache_len=64))
        tsrv = tshim.DecodeServer(tapi, tp, tshim.ServeConfig(cache_len=64))
    want = np.asarray(jsrv.generate(jnp.asarray(prompts), 8))
    got = tsrv.generate(torch.as_tensor(prompts), 8)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # deterministic, and the same paging statistics as the reference's
    np.testing.assert_array_equal(tsrv.generate(prompts, 8).numpy(), want)
    assert tsrv.last_stats == jsrv.last_stats


def test_decode_server_refuses_what_the_shim_does_not_do():
    api = TR.build(ARCH, smoke=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for cfg in (tshim.ServeConfig(greedy=False), tshim.ServeConfig(seed=1)):
            with pytest.raises(NotImplementedError, match="greedy"):
                tshim.DecodeServer(api, None, cfg).generate(
                    np.ones((1, 2), np.int32), 2)


def _caches(*args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (jshim.OffloadedKVCache(*args),
                tshim.OffloadedKVCache(*args, device="cpu"))


def test_kv_paging_roundtrip_as_the_reference():
    jkv, tkv = _caches(12, 4, (8, 16))
    data = {b: jax.random.normal(jax.random.PRNGKey(b), (8, 16)
                                 ).astype(jnp.bfloat16) for b in range(8)}
    for b, x in data.items():
        jkv.write_block(b, x)
        tkv.write_block(b, torch.from_numpy(np.asarray(x, np.float32)))
    for b, x in data.items():
        want = np.asarray(jkv.read_block(b), np.float32)
        back = tkv.read_block(b).float().numpy()
        x32 = np.asarray(x, np.float32)
        # the reference test's int8 quantization bound: amax/127
        amax = float(np.abs(x32).max())
        assert float(np.abs(back - x32).max()) <= amax / 127.0 + 0.02
        # within one int8 step of the reference's own round trip
        assert float(np.abs(back - want).max()) <= amax / 127.0 + 1e-2
    assert tkv.stats == jkv.stats
    assert tkv.resident == jkv.resident and tkv.lru == jkv.lru


def test_batched_paging_duplexes_as_the_reference():
    jkv, tkv = _caches(32, 8, (8, 16))
    for kv, ones in ((jkv, jnp.ones), (tkv, torch.ones)):
        for b in range(32):                  # fill + spill real data
            kv.write_block(b, ones((8, 16)) * b)
        kv.stats = {"page_ins": 0, "page_outs": 0, "duplex_us": 0.0,
                    "serial_us": 0.0}
        for start in range(0, 24, 4):        # real ins co-issued with outs
            kv.touch(list(range(start, start + 4)))
            for b in range(start, start + 4):     # rewrite -> dirty evict
                kv.write_block(b, ones((8, 16)) * (b + 1))
    assert tkv.stats["page_ins"] > 0 and tkv.stats["page_outs"] > 0
    assert tkv.stats == jkv.stats
    assert tkv.duplex_speedup() == jkv.duplex_speedup() > 1.3
    assert tkv.hbm.shape == jkv.hbm.shape and tkv.hbm.dtype == torch.bfloat16


def test_lru_eviction_order_as_the_reference():
    jkv, tkv = _caches(8, 2, (4, 4))
    for kv in (jkv, tkv):
        for b in (0, 1, 0, 2):   # 0 most recent, then 2 evicts 1 (LRU)
            kv.touch([b])
    assert tkv.resident == jkv.resident
    assert 0 in tkv.resident and 2 in tkv.resident
    assert 1 not in tkv.resident
    assert tkv.lru == jkv.lru


def _run(main, argv, monkeypatch) -> list[str]:
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert main() == 0
    return out.getvalue().strip().splitlines()


def offload_demo_lines(lines: list[str]) -> tuple[dict, dict, str]:
    """(the run report, the demo's stats, its speedup line) of a serve
    CLI run with ``--offload-demo``."""
    assert lines[-2].startswith("offload demo stats: ")
    assert lines[-1].startswith("duplex vs phase-separated paging: ")
    return (json.loads(lines[-3]),
            json.loads(lines[-2].split(": ", 1)[1]), lines[-1])


@pytest.mark.parametrize("flags", [[], ["--no-paging"]])
def test_offload_demo_equals_the_reference_cli(flags, monkeypatch):
    argv = ["serve", "--requests", "2", "--gen", "3", "--no-warmup",
            "--offload-demo", *flags]
    want = offload_demo_lines(_run(jserve.main, argv, monkeypatch))
    got = offload_demo_lines(_run(tserve.main, argv + ["--device", "cpu"],
                                  monkeypatch))
    assert got[0]["device"] == "cpu"
    assert set(got[0]) - UNCOMPARED == set(want[0]) - UNCOMPARED
    for key in set(want[0]) - UNCOMPARED:
        assert got[0][key] == want[0][key], key
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1]["page_ins"] == 48 and got[1]["page_outs"] == 64
