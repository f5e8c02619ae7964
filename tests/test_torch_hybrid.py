"""Port's Zamba2 family (Mamba2 with a shared attention block) against
the JAX package on the CPU: the SSD recurrence ``_ssd_scan``, the causal
conv ``_causal_conv`` and ``mamba2_apply`` (with and without a cache, in
f32 and in bf16), ``softplus`` against ``jax.nn.softplus``; the zamba2-7b
smoke model's ``forward``, ``loss_fn`` and ``decode_step`` on the
reference's own weights (``params_from_jax``), its stepwise decode
against its own forward, greedy tokens in float32; the FULL config's
values and published size; the registry entry; and that the port touches
no attention ring past the last application. Inputs are made with numpy
from a seed and handed to both."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as R  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serve import reference_decode as jax_reference_decode  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serve import reference_decode  # noqa: E402

ARCH = "zamba2-7b"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# f32: the same function in two frameworks; the SSD state's h.C
# contraction and the matmuls sum in other orders (|y| reaches ~30 in the
# scan alone, where an f32 ulp is ~2e-6)
SCAN_TOL = 1e-5
F32_TOL = 1e-4
# bf16 models: XLA and PyTorch round the bf16 matmuls and norms at other
# places. The smoke logits reach ~3.8, where one bf16 ulp is 2**-6 ~
# 0.016; the two frameworks' bf16 forwards differ by up to 0.055 (3.5
# ulps), less than either framework's own bf16 forward differs from its
# f32 one (0.088 and 0.092): allow five ulps
BF16_LOGIT_TOL = 8e-2


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _n(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _specs(dtype):
    return (JS.Mamba2Spec(d_model=64, d_state=8, dtype=JDT[dtype]),
            TS.Mamba2Spec(d_model=64, d_state=8, dtype=dtype))


def _scan_inputs(spec, B, S, seed):
    rng = np.random.default_rng(seed)
    H, P, G, N = spec.num_heads, spec.head_dim, spec.n_groups, spec.d_state
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return xh, Bm, Cm, dt, A_log, D, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_the_reference(dtype, with_state):
    """The recurrence in f32 whatever the input dtype (x, B, C cast up),
    from zero or from a carried state: outputs and final state."""
    jspec, tspec = _specs(dtype)
    xh, Bm, Cm, dt, A_log, D, state = _scan_inputs(jspec, 2, 12, seed=1)
    jy, jh = JS._ssd_scan(
        jspec, jnp.asarray(xh).astype(JDT[dtype]),
        jnp.asarray(Bm).astype(JDT[dtype]),
        jnp.asarray(Cm).astype(JDT[dtype]), jnp.asarray(dt),
        jnp.asarray(A_log), jnp.asarray(D),
        jnp.asarray(state) if with_state else None)
    ty, th = TS._ssd_scan(tspec, _t(xh, dtype), _t(Bm, dtype), _t(Cm, dtype),
                          _t(dt), _t(A_log), _t(D),
                          _t(state) if with_state else None)
    assert ty.dtype == th.dtype == torch.float32
    assert th.shape == (2, tspec.num_heads, tspec.head_dim, tspec.d_state)
    np.testing.assert_allclose(_n(ty), _n(jy), atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(_n(th), _n(jh), atol=SCAN_TOL, rtol=SCAN_TOL)


def test_ssd_scan_repeats_each_group_over_its_heads():
    """``jnp.repeat(B_t, rep, axis=1)`` is ``repeat_interleave``: with two
    groups of B/C over four heads, heads 0-1 read group 0 and heads 2-3
    group 1 (``torch.repeat`` would tile them 0, 1, 0, 1)."""
    jspec = JS.Mamba2Spec(d_model=128, d_state=4, n_groups=2,
                          dtype=jnp.float32)
    tspec = TS.Mamba2Spec(d_model=128, d_state=4, n_groups=2,
                          dtype=torch.float32)
    assert tspec.num_heads == 4
    xh, Bm, Cm, dt, A_log, D, _ = _scan_inputs(jspec, 1, 5, seed=2)
    jy, _ = JS._ssd_scan(jspec, *map(jnp.asarray, (xh, Bm, Cm, dt, A_log,
                                                   D)))
    ty, _ = TS._ssd_scan(tspec, *map(_t, (xh, Bm, Cm, dt, A_log, D)))
    np.testing.assert_allclose(_n(ty), _n(jy), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_window", [False, True])
def test_causal_conv_is_the_reference_bit_for_bit(dtype, with_window):
    """The taps are summed in the input dtype, in order of i, as the
    reference's Python ``sum``: equal bit for bit, bf16 included, and the
    new window is the last K-1 inputs."""
    rng = np.random.default_rng(3)
    B, S, C, K = 2, 9, 48, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, C))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    win = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    jd = JDT[dtype]
    jo, jw = JS._causal_conv(jnp.asarray(x).astype(jd),
                             jnp.asarray(w).astype(jd),
                             jnp.asarray(b).astype(jd),
                             jnp.asarray(win).astype(jd) if with_window
                             else None)
    to, tw = TS._causal_conv(_t(x, dtype), _t(w, dtype), _t(b, dtype),
                             _t(win, dtype) if with_window else None)
    assert to.dtype == tw.dtype == dtype and tw.shape == (B, K - 1, C)
    np.testing.assert_array_equal(_n(to), _n(jo))
    np.testing.assert_array_equal(_n(tw), _n(jw))
    np.testing.assert_array_equal(_n(tw), _n(_t(x, dtype)[:, -(K - 1):]))


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` is
    ``log1p(exp(x))`` up to its threshold of 20 and x above it. The port
    mirrors ``logaddexp``: within 2**-23 (one f32 ulp at 1) of the
    reference everywhere, and above 20, where ``F.softplus``
    switches branch, all three equal x's f32 sum bit for bit."""
    xs = np.linspace(-40.0, 60.0, 20001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(xs)))
    got = TS.softplus(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -23, rtol=0)
    big = xs > 20
    assert np.array_equal(got[big], want[big])
    f = torch.nn.functional.softplus(torch.from_numpy(xs)).numpy()
    assert np.array_equal(f[big], want[big])


def _mamba_pair(dtype, seed=0):
    """The reference's Mamba2 params at d_model 64 (f32 leaves f32 in both)
    and the port's conversion of them."""
    jspec, tspec = _specs(dtype)
    jp = JS.mamba2_init(jax.random.PRNGKey(seed), jspec)
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = {k: (nn.tree_map(lambda a: _t(a, dtype), v) if k not in
              ("A_log", "dt_bias", "D") else _t(v))
          for k, v in np_tree.items()}
    # the reference's dt_bias and D are 0 and 1: move them off their init
    # so the test sees them
    rng = np.random.default_rng(seed + 1)
    for k, base in (("dt_bias", 0.0), ("D", 1.0)):
        val = (base + 0.3 * rng.standard_normal(jspec.num_heads)).astype(
            np.float32)
        jp[k], tp[k] = jnp.asarray(val), _t(val)
    return jspec, jp, tspec, tp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_apply_full_sequence(dtype):
    jspec, jp, tspec, tp = _mamba_pair(dtype)
    x = np.random.default_rng(4).standard_normal((2, 10, 64)).astype(
        np.float32)
    jo, jc = JS.mamba2_apply(jp, jnp.asarray(x).astype(JDT[dtype]), jspec)
    to, tc = TS.mamba2_apply(tp, _t(x, dtype), tspec)
    assert jc is None and tc is None and to.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    np.testing.assert_allclose(_n(to), _n(jo), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_apply_with_a_cache_returns_new_leaves(dtype):
    """S=1 steps with a cache: outputs and the new conv window and SSM
    state track the reference's over six steps; the input cache is never
    written."""
    jspec, jp, tspec, tp = _mamba_pair(dtype, seed=5)
    rng = np.random.default_rng(6)
    jc = JS.mamba2_cache_init(jspec, 2)
    tc = TS.mamba2_cache_init(tspec, 2)
    assert tc["conv"].dtype == dtype and tc["ssm"].dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    for _ in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = JS.mamba2_apply(jp, jnp.asarray(x).astype(JDT[dtype]),
                                 jspec, jc)
        before = {k: v.clone() for k, v in tc.items()}
        to, new = TS.mamba2_apply(tp, _t(x, dtype), tspec, tc)
        for k in tc:
            assert torch.equal(tc[k], before[k])
            assert new[k] is not tc[k]
        tc = new
        np.testing.assert_allclose(_n(to), _n(jo), atol=tol, rtol=0)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_n(tc[k]), _n(jc[k]), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the zamba2-7b smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    api = R.build(ARCH, smoke=True)
    return api, api.init(jax.random.PRNGKey(0))


def _pair(jax_params, dtype):
    """(jax api, jax params, port api, port params) in ``dtype``; the f32
    leaves stay f32 in both."""
    api, params = jax_params
    jdt = JDT[dtype]
    japi = R._hybrid_api(ARCH, dataclasses.replace(api.cfg, dtype=jdt))
    jp = jax.tree.map(
        lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16 else a, params)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg, dtype=dtype)
    tapi = TR._hybrid_api(ARCH, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return japi, jp, tapi, TH.params_from_jax(npt, tcfg)


def test_params_tree_matches_the_reference(jax_params):
    """The port's own init and the converted reference tree have the
    reference's layout, shapes and dtypes (``A_log``, ``dt_bias``, ``D``
    f32 in a bf16 model), and the own init has its distributions."""
    _, params = jax_params
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    own = TR.build(ARCH, smoke=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = _pair(jax_params, torch.bfloat16)[3]
    jdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for tree in (own, conv):
        assert len(list(nn.tree_leaves(tree))) == len(want)
        for path, leaf in want:
            t = tree
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
            assert t.dtype == jdt[str(leaf.dtype)], path
    block = own["layers"]["block"]
    H = own["layers"]["block"]["A_log"].shape[1]
    np.testing.assert_allclose(block["A_log"][0].numpy(),
                               np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
    assert torch.all(block["D"] == 1) and torch.all(block["dt_bias"] == 0)
    assert 0.08 < block["conv_w"].float().std().item() < 0.12
    assert 0.9 < (block["in_proj"].float().std().item() * 8) < 1.1


def test_own_init_is_seeded():
    api = TR.build(ARCH, smoke=True, device="cpu")
    a = api.init(torch.Generator().manual_seed(3))
    b = api.init(torch.Generator().manual_seed(3))
    for x, y in zip(nn.tree_leaves(a), nn.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_logits_match_the_reference(jax_params, dtype):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks = _tokens(2, 16, seed=7)
    want = np.asarray(japi.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got, aux = TH.forward(tp, tapi.cfg, torch.from_numpy(toks))
    assert got.dtype == dtype and got.shape == (2, 16, 256)
    assert aux.item() == 0.0
    tol = F32_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    if dtype == torch.float32:
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_fn_matches_the_reference(jax_params, dtype):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks = _tokens(2, 17, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, _ = japi.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tm["aux"].item() == 0.0
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert abs(tl.item() - float(jl)) <= tol * abs(float(jl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_matches_the_reference(jax_params, dtype):
    """Eight steps of B=3 with random tokens: logits at each step and the
    final cache (Mamba state and attention rings) within the model
    tolerance; the ring positions exactly."""
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    jstep = jax.jit(japi.decode_step)
    B = 3
    jc, tc = japi.init_cache(B, 16), tapi.init_cache(B, 16)
    rng = np.random.default_rng(5)
    tol = F32_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    for t in range(8):
        toks = rng.integers(0, 256, B).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), atol=tol,
                                   rtol=0)
    for part, key in (("mamba", "conv"), ("mamba", "ssm"), ("attn", "k"),
                      ("attn", "v")):
        np.testing.assert_allclose(_n(tc[part][key]), _n(jc[part][key]),
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))


def test_decode_step_returns_new_mamba_leaves_and_the_same_rings(jax_params):
    """The Mamba leaves come back new and the input's are not written; the
    attention rings come back as the very tensors passed in, written in
    place at the token's slot of every application."""
    _, _, tapi, tp = _pair(jax_params, torch.bfloat16)
    cache = tapi.init_cache(2, 8)
    before = nn.tree_map(torch.clone, cache["mamba"])
    _, new = tapi.decode_step(tp, cache, torch.tensor([3, 4]),
                              torch.tensor([5, 5], dtype=torch.int32))
    for key in ("conv", "ssm"):
        assert new["mamba"][key] is not cache["mamba"][key]
        assert torch.equal(cache["mamba"][key], before[key])
        assert not torch.equal(new["mamba"][key], before[key])
    for key in ("k", "v", "pos"):
        assert new["attn"][key] is cache["attn"][key]
    assert torch.all(cache["attn"]["pos"][:, :, 5] == 5)
    assert torch.all(cache["attn"]["pos"][:, :, :5] == -1)


def test_no_ring_past_the_last_application(monkeypatch):
    """The reference indexes the rings with idx // attn_every on every
    layer; past the last application that is out of range (SMOKE: layer
    4 of 5 at every 2; FULL: layers 78-80 of 81 at every 6). The port runs
    the shared block once per application, each on its own ring in
    order, and never on an index past them (torch would raise)."""
    cfg = dataclasses.replace(TR.build(ARCH, smoke=True, device="cpu").cfg,
                              num_layers=9, attn_every=4)
    full = TR.build(ARCH, device="cpu").cfg
    assert full.num_attn_apps == 13 and 80 // full.attn_every == 13
    assert cfg.num_attn_apps == 2 and 8 // cfg.attn_every == 2
    api = TR._hybrid_api(ARCH, cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(1))
    cache = api.init_cache(2, 8)
    seen = []
    real = nn.attn_decode_step

    def spy(p, x, ring, pos, spec):
        seen.append(ring["k"].data_ptr())
        return real(p, x, ring, pos, spec)

    monkeypatch.setattr(nn, "attn_decode_step", spy)
    api.decode_step(params, cache, torch.tensor([1, 2]),
                    torch.tensor([0, 0], dtype=torch.int32))
    assert seen == [cache["attn"]["k"][a].data_ptr()
                    for a in range(cfg.num_attn_apps)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stepwise_decode_equals_the_forward(dtype):
    """``decode_step`` token by token reproduces the teacher-forced
    forward (tests/test_models.py:103-119: B=2, S=12, atol = rtol = 1e-2),
    inside the port; f32 within 1e-4."""
    api = TR.build(ARCH, smoke=True, device="cpu")
    api = TR._hybrid_api(ARCH, dataclasses.replace(api.cfg, dtype=dtype),
                         "cpu")
    params = api.init(torch.Generator().manual_seed(9))
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(B, S, seed=10))
    full = api.forward(params, {"tokens": toks})
    cache = api.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(params, cache, toks[:, t],
                                    torch.full((B,), t, dtype=torch.int32))
        outs.append(lg)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(torch.stack(outs, dim=1).float(),
                               full.float(), atol=tol, rtol=tol)


def test_greedy_trajectories_equal_float32(jax_params):
    japi, jp, tapi, tp = _pair(jax_params, torch.float32)
    prompts = _tokens(4, 6, seed=6)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           12, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 12, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

def test_full_config_values_and_published_size():
    """tests/test_models.py:74-84 and :197-198: 81 layers, d_model 3584,
    32 heads (MHA), d_ff 14336, vocab 32000; 6.8 B parameters within 10 %,
    the reference's count exactly."""
    cfg = TR.build(ARCH, device="cpu").cfg
    jcfg = R.build(ARCH).cfg
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.ssm_state, cfg.attn_every) == (
        81, 3584, 32, 32, 14336, 32000, 64, 6)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count() / 1e9 == pytest.approx(6.8, rel=0.1)
    mspec = cfg.mamba_spec()
    assert (mspec.d_inner, mspec.num_heads, mspec.conv_dim) == (
        7168, 112, 7296)
    smoke = TR.build(ARCH, smoke=True, device="cpu").cfg
    jsmoke = R.build(ARCH, smoke=True).cfg
    assert (smoke.num_layers, smoke.d_model, smoke.num_heads, smoke.d_ff,
            smoke.vocab, smoke.ssm_state, smoke.attn_every) == (
        5, 64, 4, 128, 256, 8, 2)
    assert smoke.param_count() == jsmoke.param_count()
    assert smoke.num_attn_apps == jsmoke.num_attn_apps == 2


def test_registry_entry():
    from repro_torch import configs
    assert ARCH in configs.ARCH_IDS
    api = TR.build(ARCH, smoke=True, device="cpu")
    assert (api.family, api.cache_kind) == ("hybrid", "recurrent")
    assert TR.FAMILY[ARCH] == R.FAMILY[ARCH] == "hybrid"
    assert api.param_count == api.active_param_count == \
        api.cfg.param_count()
    cache = api.init_cache(3, 64)
    assert cache["mamba"]["conv"].shape == (5, 3, 3, 144)
    assert cache["mamba"]["ssm"].shape == (5, 3, 2, 64, 8)
    assert cache["mamba"]["ssm"].dtype == torch.float32
    assert cache["attn"]["k"].shape == (2, 3, 64, 4, 16)
    assert torch.all(cache["attn"]["pos"] == -1)
    jcache = R.build(ARCH, smoke=True).init_cache(3, 64)
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        t = cache
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path


def test_arch_ids_keep_the_reference_order():
    from repro import configs as jconfigs
    from repro_torch import configs
    assert list(configs.ARCH_IDS) == [a for a in jconfigs.ARCH_IDS
                                      if a in configs.ARCH_IDS]
    assert {"zamba2-7b", "whisper-base"} <= set(configs.ARCH_IDS)
