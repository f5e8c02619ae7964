"""The port's optimizer (``repro_torch.optim``) against the JAX
package's: ``adamw_update``, ``cosine_schedule`` and
``clip_by_global_norm`` on the same numpy trees in f32; the reference's
own ``TestAdamW`` / ``TestSchedule`` / ``TestClipping`` cases on the
port; host against device AdamW; and the host optimizer's modelled link
report, ``plan_state_stream`` and ``apply_kv_plan`` equal to the
reference's exactly.

Tolerances: parameters, moments and the schedule within rtol 1e-6
(one f32 ulp is 6e-8: the transcendental cos, pow and sqrt and the
order of the global norm's sums may differ by an ulp or two between XLA
and PyTorch, and a step's error moves a parameter by lr times it); the
global norm within rtol 1e-6 (sum order); the clipped leaves within
rtol 1e-6 (they inherit the norm's). Host against device AdamW: atol
1e-5, the reference's own bound (``tests/test_system.py:83-98``): the
host update takes ``1 - b1`` in f32, the device update in a double."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as jopt  # noqa: E402
from repro.core import offload as joffload  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import offload as toffload  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402

RTOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": (rng.standard_normal((4, 5)) * scale
                        ).astype(np.float32)},
            "a": (rng.standard_normal((7,)) * scale).astype(np.float32),
            "c": {"z": (rng.standard_normal((3, 2, 2)) * scale
                        ).astype(np.float32),
                  "y": (rng.standard_normal((1,)) * scale
                        ).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = [np.asarray(x) for x in tree_leaves(got)]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _cfgs():
    return (dict(peak_lr=0.05, warmup_steps=2, total_steps=20),
            dict(peak_lr=3e-4, end_lr=3e-5, warmup_steps=0, total_steps=5,
                 weight_decay=0.0),
            dict(peak_lr=1e-3, warmup_steps=3, total_steps=8, clip_norm=0.5,
                 b1=0.8, b2=0.99, eps=1e-6))


@pytest.mark.parametrize("kw", _cfgs())
def test_adamw_update_equals_reference(kw):
    jcfg = jopt.AdamWConfig(grad_dtype=jnp.float32, **kw)
    tcfg = topt.AdamWConfig(grad_dtype=torch.float32, **kw)
    params = _tree(0)
    jp, js = _j(params), None
    tp = _t(params)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    before = {k: v.clone() for k, v in [("a", tp["a"])]}
    for step in range(6):
        grads = _tree(10 + step, scale=3.0 if step % 2 else 0.1)
        jp, js, jm = jopt.adamw_update(jcfg, jp, _j(grads), js)
        tp, ts, tm = topt.adamw_update(tcfg, tp, _t(grads), ts)
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        assert tm["lr"].dtype == torch.float32
    # out of place: the caller's first tree is untouched
    assert torch.equal(_t(params)["a"], before["a"])


def test_cosine_schedule_equals_reference():
    for kw in ({"peak_lr": 1.0, "end_lr": 0.1, "warmup_steps": 10,
                "total_steps": 110},
               {"peak_lr": 3e-4, "warmup_steps": 100, "total_steps": 10_000},
               {"peak_lr": 5e-3, "warmup_steps": 0, "total_steps": 1}):
        jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for step in (0, 1, 2, 5, 9, 10, 11, 50, 60, 109, 110, 111, 5000,
                     20_000):
            got = topt.cosine_schedule(tcfg, torch.tensor(step,
                                                          dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                float(got), float(jopt.cosine_schedule(jcfg, step)),
                rtol=RTOL)


@pytest.mark.parametrize("scale,max_norm", [(10.0, 1.0), (0.01, 1.0),
                                            (1.0, 0.25), (0.0, 1.0)])
def test_clip_by_global_norm_equals_reference(scale, max_norm):
    tree = _tree(5, scale)
    jc, jn = jopt.clip_by_global_norm(_j(tree), max_norm)
    tc, tn = topt.clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(topt.global_norm(_t(tree))),
                               float(jopt.global_norm(_j(tree))), rtol=RTOL)
    _close(tc, jc)


def test_clip_keeps_each_leafs_dtype():
    tree = {"a": torch.full((10,), 10.0, dtype=torch.bfloat16),
            "b": torch.ones((3,))}
    clipped, _ = topt.clip_by_global_norm(tree, 1.0)
    assert clipped["a"].dtype == torch.bfloat16
    assert clipped["b"].dtype == torch.float32


class TestAdamW:
    """The reference's cases (tests/test_optim.py), on the port."""

    def test_converges_on_quadratic(self):
        cfg = topt.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                               weight_decay=0.0, grad_dtype=torch.float32)
        params = {"w": torch.tensor([3.0, -2.0, 1.5]),
                  "b": torch.tensor([0.5])}
        state = topt.adamw_init(params)
        loss = lambda p: (p["w"] ** 2).sum() + (p["b"] ** 2).sum()
        for _ in range(200):
            grads = {k: 2.0 * v for k, v in params.items()}
            params, state, _ = topt.adamw_update(cfg, params, grads, state)
        assert float(loss(params)) < 1e-2

    def test_weight_decay_shrinks(self):
        cfg = topt.AdamWConfig(peak_lr=0.01, warmup_steps=0, total_steps=10,
                               weight_decay=0.5, grad_dtype=torch.float32)
        params = {"w": torch.ones((4,))}
        params2, _, _ = topt.adamw_update(cfg, params,
                                          {"w": torch.zeros((4,))},
                                          topt.adamw_init(params))
        assert float(params2["w"].max()) < 1.0

    def test_step_counter(self):
        params = {"w": torch.ones((2,))}
        _, state, _ = topt.adamw_update(topt.AdamWConfig(), params,
                                        {"w": torch.ones((2,))},
                                        topt.adamw_init(params))
        assert int(state["step"]) == 1


class TestSchedule:
    def test_warmup_then_cosine(self):
        cfg = topt.AdamWConfig(peak_lr=1.0, end_lr=0.1, warmup_steps=10,
                               total_steps=110)
        assert float(topt.cosine_schedule(cfg, 0)) == 0.0
        assert float(topt.cosine_schedule(cfg, 10)) == pytest.approx(1.0)
        assert float(topt.cosine_schedule(cfg, 110)) == pytest.approx(
            0.1, abs=1e-3)
        assert 0.1 < float(topt.cosine_schedule(cfg, 60)) < 1.0


class TestClipping:
    def test_clip_reduces_norm(self):
        clipped, norm = topt.clip_by_global_norm(
            {"a": torch.full((10,), 10.0)}, 1.0)
        assert float(norm) > 1.0
        assert float(topt.global_norm(clipped)) == pytest.approx(1.0,
                                                                 rel=1e-3)

    def test_no_clip_below_threshold(self):
        clipped, _ = topt.clip_by_global_norm(
            {"a": torch.tensor([0.1, 0.1])}, 1.0)
        np.testing.assert_allclose(clipped["a"].numpy(), [0.1, 0.1],
                                   rtol=1e-6)


def test_host_offload_equals_reference_host_offload():
    """Both packages' host optimizers, step for step (rtol 1e-6, atol
    1e-8), and the link report's modelled keys exactly."""
    kw = dict(peak_lr=0.05, warmup_steps=2, total_steps=20)
    jhost = jopt.HostOffloadAdamW(jopt.AdamWConfig(grad_dtype=jnp.float32,
                                                   **kw))
    thost = topt.HostOffloadAdamW(topt.AdamWConfig(grad_dtype=torch.float32,
                                                   **kw))
    params = _tree(1)
    jp, tp = _j(params), _t(params)
    js, ts = jhost.init(jp), thost.init(tp)
    for step in range(5):
        grads = _tree(20 + step, scale=0.5)
        jp, js, _ = jhost.update(jp, _j(grads), js)
        tp, ts, _ = thost.update(tp, _t(grads), ts)
        # atol 1e-8 beside rtol: XLA may contract the jitted leaf update's
        # b1 * m + (1 - b1) * g into one FMA; where the two terms nearly
        # cancel, the rounding it saves reads as a relative difference
        _close(tp, jp, atol=1e-8)
        _close(thost._m, jhost._m, atol=1e-8)
        _close(thost._v, jhost._v, atol=1e-8)
        rep = thost.last_transfer_report
        assert {k: rep[k] for k in jhost.last_transfer_report} \
            == jhost.last_transfer_report
        assert rep["measured_us"] > 0
    assert thost.state_bytes() == jhost.state_bytes()
    assert all(m.device.type == "cpu" and not m.is_pinned()
               for m in tree_leaves(thost._m))


def test_host_matches_device_adamw():
    """The reference's TestHostOffloadParity on the port: the host
    optimizer trains as the device one (atol 1e-5)."""
    cfg = topt.AdamWConfig(peak_lr=0.05, warmup_steps=2, total_steps=20,
                           grad_dtype=torch.float32)
    params_a = {"w": torch.tensor([1.0, -2.0]), "b": torch.tensor([3.0])}
    params_b = {k: v.clone() for k, v in params_a.items()}
    state_a = topt.adamw_init(params_a)
    host = topt.HostOffloadAdamW(cfg)
    state_b = host.init(params_b)
    for step in range(5):
        grads = {k: 0.1 * p + 0.01 * step for k, p in params_a.items()}
        params_a, state_a, _ = topt.adamw_update(cfg, params_a, grads,
                                                 state_a)
        params_b, state_b, _ = host.update(params_b, grads, state_b)
        for la, lb in zip(tree_leaves(params_a), tree_leaves(params_b)):
            np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [1, 1000, 123_457])
def test_transfer_report_equals_reference(n):
    jhost = jopt.HostOffloadAdamW(jopt.AdamWConfig(grad_dtype=jnp.float32))
    thost = topt.HostOffloadAdamW(topt.AdamWConfig(grad_dtype=torch.float32))
    js = jhost.init({"w": jnp.ones((n,)), "e": jnp.ones((3, 5))})
    ts = thost.init({"w": torch.ones((n,)), "e": torch.ones((3, 5))})
    jhost.update({"w": jnp.ones((n,)), "e": jnp.ones((3, 5))},
                 {"w": jnp.ones((n,)), "e": jnp.ones((3, 5))}, js)
    thost.update({"w": torch.ones((n,)), "e": torch.ones((3, 5))},
                 {"w": torch.ones((n,)), "e": torch.ones((3, 5))}, ts)
    rep = thost.last_transfer_report
    want = jhost.last_transfer_report
    assert rep["moment_bytes"] == 2 * (n + 15) * 4
    assert {k: rep[k] for k in want} == want
    assert rep["duplex_us"] <= rep["serial_us"]


@pytest.mark.parametrize("nbytes,chunk", [(8.0, 65536.0), (1e6, 65536.0),
                                          (3 * 2 ** 26 + 17, 2 ** 26),
                                          (2 ** 30, 2 ** 26)])
def test_plan_state_stream_equals_reference(nbytes, chunk):
    je, te = joffload.DuplexOffloadEngine(), toffload.DuplexOffloadEngine()
    jd, jsr = je.plan_state_stream(nbytes=nbytes, chunk_bytes=chunk)
    td, tsr = te.plan_state_stream(nbytes=nbytes, chunk_bytes=chunk)
    for a, b in ((td, jd), (tsr, jsr)):
        assert a.policy == b.policy
        assert [s.nbytes() for s in a.slots] == [s.nbytes() for s in b.slots]
        assert [(s.page_in.hint_path if s.page_in else None)
                for s in a.slots] == [(s.page_in.hint_path if s.page_in
                                       else None) for s in b.slots]
        assert a.modelled_time_us() == b.modelled_time_us()
    assert te.speedup(td, tsr) == je.speedup(jd, jsr)


def test_apply_kv_plan_equals_reference():
    rng = np.random.default_rng(2)
    hbm = rng.standard_normal((6, 4, 3)).astype(np.float32)
    host = rng.standard_normal((9, 4, 3)).astype(np.float32)
    for duplex in (True, False):
        kw = dict(needed_host_blocks=[7, 2, 5], evict_hbm_blocks=[1, 4],
                  free_hbm_blocks=[3], host_dst_blocks=[0, 8],
                  block_bytes=4096.0)
        je, te = joffload.DuplexOffloadEngine(), \
            toffload.DuplexOffloadEngine()
        if not duplex:
            from repro.core.hints import HintTree as JHT
            from repro.core.hints import MemoryHint as JMH
            from repro_torch.core.hints import HintTree, MemoryHint
            je.hints, te.hints = JHT(), HintTree()
            je.hints.set("/serve/kv_cache", JMH(duplex_opt_in=False))
            te.hints.set("/serve/kv_cache", MemoryHint(duplex_opt_in=False))
        jplan, tplan = je.plan_kv_paging(**kw), te.plan_kv_paging(**kw)
        assert tplan.policy == jplan.policy
        jh, jo = joffload.apply_kv_plan(jnp.asarray(hbm), jnp.asarray(host),
                                        jplan)
        th_in, to_in = torch.from_numpy(hbm.copy()), \
            torch.from_numpy(host.copy())
        th, to = toffload.apply_kv_plan(th_in, to_in, tplan)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        # the inputs are not written
        np.testing.assert_array_equal(th_in.numpy(), hbm)
