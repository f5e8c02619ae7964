"""Port's Whisper encoder-decoder against the JAX package on the CPU:
``sinusoid_positions``, ``gelu_mlp``, and the whisper-base smoke model's
``encode``, ``decode_train``, ``forward``, ``loss_fn``, ``build_cache``
and ``decode_step`` on the reference's own weights (``params_from_jax``),
in f32 and in bf16; greedy tokens in float32 through the registry's
serving cache (cross K/V zeros, as the reference serves it); the FULL
config's values and published size; the registry entry. Inputs are made
with numpy from a seed and handed to both."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.serve import reference_decode as jax_reference_decode  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import reference_decode  # noqa: E402

ARCH = "whisper-base"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# sinusoids: ``exp`` of the frequencies differs by an f32 ulp between the
# frameworks and the angle pos * div carries it, so the gap grows with the
# position: measured 4.8e-7 at 12 positions, 1.5e-5 at 448 and 6.1e-5 at
# 1500 (Whisper's encoder length); allowed 1e-6 per 12 positions' worth,
# i.e. 1e-4 at 1500
SIN_TOL = {12: 1e-6, 448: 4e-5, 1500: 1e-4}
# f32 models: the same function in two frameworks, summed in other orders
F32_TOL = 1e-4
# bf16 models: XLA and PyTorch round the bf16 matmuls, norms and the
# bf16 positional add at other places. The smoke logits reach ~0.55 (one
# bf16 ulp 2**-9 ~ 0.002): the two frameworks' bf16 forwards differ by up
# to 0.0039, as much as either framework's bf16 forward differs from its
# f32 one (0.0042, 0.0043); allow five ulps. The encoding and the K/V
# built from it reach ~3.7 (one ulp 2**-6 ~ 0.016): 0.023 apart across
# the frameworks, 0.026 and 0.029 from f32; allow five ulps.
BF16_LOGIT_TOL = 1e-2
BF16_HIDDEN_TOL = 8e-2


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _n(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _frames(B, S, seed, d=64):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("length", [12, 448, 1500])
def test_sinusoid_positions_match_the_reference(length):
    want = np.asarray(JE.sinusoid_positions(length, 512))
    got = TE.sinusoid_positions(length, 512)
    assert got.dtype == torch.float32 and got.shape == (length, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=SIN_TOL[length],
                               rtol=0)
    # decode's per-row positions are the same function, bit for bit
    pos = torch.tensor([0, 5, length - 1], dtype=torch.int32)
    assert torch.equal(TE._sinusoid(pos.float(), 512), got[pos.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_mlp_matches_the_reference(dtype):
    """``jax.nn.gelu`` defaults to the tanh approximation; the port asks
    ``F.gelu`` for it. f32 within 1e-5, bf16 within one ulp of |y| ~ 2."""
    p = JL.gelu_mlp_init(jax.random.PRNGKey(3), 64, 128, jnp.float32)
    rng = np.random.default_rng(4)
    p = {k: jnp.asarray(np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                                         if k.startswith("b") else 0.0),
                        jnp.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jd = JDT[dtype]
    want = JL.gelu_mlp({k: v.astype(jd) for k, v in p.items()},
                       jnp.asarray(x).astype(jd))
    got = nn.gelu_mlp({k: _t(v, dtype) for k, v in p.items()}, _t(x, dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    np.testing.assert_allclose(_n(got), _n(want), atol=tol, rtol=0)
    exact = nn.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x))
    assert not torch.equal(exact, torch.nn.functional.gelu(
        _t(x) @ _t(p["w_in"]) + _t(p["b_in"])) @ _t(p["w_out"])
        + _t(p["b_out"]))


# ---------------------------------------------------------------------------
# the whisper-base smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    api = R.build(ARCH, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    # the reference's biases init to 0: move them off it so the tests see
    # them (QKV, MLP and layernorm biases alike)
    rng = np.random.default_rng(1)

    def nudge(path, a):
        name = path[-1].key
        if name.startswith("b") or name == "bias":
            return (a.astype(jnp.float32) + 0.05 * rng.standard_normal(
                a.shape).astype(np.float32)).astype(a.dtype)
        return a

    return api, jax.tree_util.tree_map_with_path(nudge, params)


def _pair(jax_params, dtype):
    """(jax api, jax params, port api, port params) in ``dtype``."""
    api, params = jax_params
    jdt = JDT[dtype]
    japi = R._encdec_api(ARCH, dataclasses.replace(api.cfg, dtype=jdt))
    jp = jax.tree.map(lambda a: a.astype(jdt), params)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg, dtype=dtype)
    tapi = TR._encdec_api(ARCH, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return japi, jp, tapi, TE.params_from_jax(npt, tcfg)


def test_params_tree_matches_the_reference(jax_params):
    """The port's own init and the converted reference tree have the
    reference's layout, shapes and dtypes."""
    _, params = jax_params
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    own = TR.build(ARCH, smoke=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = _pair(jax_params, torch.bfloat16)[3]
    for tree in (own, conv):
        assert len(list(nn.tree_leaves(tree))) == len(want)
        for path, leaf in want:
            t = tree
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
            assert t.dtype == torch.bfloat16, path
    dec = own["dec_layers"]
    assert torch.all(dec["cross"]["attn"]["bq"] == 0)
    assert torch.all(dec["ln_mlp"]["scale"] == 1)
    assert 0.9 < dec["mlp"]["w_in"].float().std().item() * 8 < 1.1


def _tol(dtype, hidden=False):
    if dtype == torch.float32:
        return F32_TOL
    return BF16_HIDDEN_TOL if hidden else BF16_LOGIT_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_matches_the_reference(jax_params, dtype):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    frames = _frames(2, 24, seed=2)
    want = JE.encode(jp, japi.cfg, jnp.asarray(frames))
    got = TE.encode(tp, tapi.cfg, _t(frames))
    assert got.dtype == dtype and got.shape == (2, 24, 64)
    np.testing.assert_allclose(_n(got), _n(want), atol=_tol(dtype, True),
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_and_decode_train_match_the_reference(jax_params, dtype):
    """``forward`` = ``encode`` then the teacher-forced ``decode_train``
    (causal self-attention, cross-attention over the encoding, tied
    unembedding)."""
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks, frames = _tokens(2, 10, seed=3), _frames(2, 24, seed=4)
    want = np.asarray(japi.forward(jp, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)}),
                      np.float32)
    got = tapi.forward(tp, {"tokens": torch.from_numpy(toks),
                            "frames": _t(frames)})
    assert got.dtype == dtype and got.shape == (2, 10, 256)
    np.testing.assert_allclose(_n(got), want, atol=_tol(dtype), rtol=0)
    enc = TE.encode(tp, tapi.cfg, _t(frames))
    assert torch.equal(TE.decode_train(tp, tapi.cfg, torch.from_numpy(toks),
                                       enc), got)
    if dtype == torch.float32:
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_fn_matches_the_reference(jax_params, dtype):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks, frames = _tokens(2, 11, seed=5), _frames(2, 16, seed=6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": frames}
    jl, _ = japi.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tm["aux"].item() == 0.0
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert abs(tl.item() - float(jl)) <= tol * abs(float(jl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_cache_matches_the_reference(jax_params, dtype):
    """The serving 'prefill': the encoding and every decoder layer's
    cross K/V from it, beside empty self rings."""
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    frames = _frames(2, 20, seed=7)
    jc, jenc = JE.build_cache(jp, japi.cfg, jnp.asarray(frames), 2, 16)
    tc, tenc = TE.build_cache(tp, tapi.cfg, _t(frames), 2, 16)
    np.testing.assert_allclose(_n(tenc), _n(jenc), atol=_tol(dtype, True),
                               rtol=0)
    for key in ("cross_k", "cross_v"):
        assert tc[key].shape == (2, 2, 20, 4, 16) and tc[key].dtype == dtype
        np.testing.assert_allclose(_n(tc[key]), _n(jc[key]),
                                   atol=_tol(dtype, True), rtol=0)
    assert tc["self"]["k"].shape == (2, 2, 16, 4, 16)
    assert torch.all(tc["self"]["pos"] == -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_matches_the_reference(jax_params, dtype):
    """Eight steps of B=2 against a built cache (non-zero cross K/V):
    logits at every step and the self rings within the model tolerance,
    ring positions exactly; the self rings are written in place and the
    cross K/V are left as they are."""
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    frames = _frames(2, 20, seed=8)
    jc, _ = JE.build_cache(jp, japi.cfg, jnp.asarray(frames), 2, 16)
    tc, _ = TE.build_cache(tp, tapi.cfg, _t(frames), 2, 16)
    cross = {k: tc[k].clone() for k in ("cross_k", "cross_v")}
    jstep = jax.jit(japi.decode_step)
    rng = np.random.default_rng(9)
    for t in range(8):
        toks = rng.integers(0, 256, 2).astype(np.int32)
        pos = np.array([t, t], np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, new = tapi.decode_step(tp, tc, torch.from_numpy(toks),
                                   torch.from_numpy(pos))
        assert new is tc
        np.testing.assert_allclose(_n(tl), _n(jl), atol=_tol(dtype), rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(_n(tc["self"][key]), _n(jc["self"][key]),
                                   atol=_tol(dtype, True), rtol=0)
    np.testing.assert_array_equal(tc["self"]["pos"].numpy(),
                                  np.asarray(jc["self"]["pos"]))
    for k, v in cross.items():
        assert torch.equal(tc[k], v)


def test_zero_cross_kv_adds_exactly_zero(jax_params):
    """The serving cache's cross K/V are zeros (``init_cache``, as the
    reference serves): the cross block's uniform softmax over zero values
    adds exactly 0, so the decoder runs as if it had no encoder."""
    _, _, tapi, tp = _pair(jax_params, torch.bfloat16)
    block = nn.tree_map(lambda t: t[0], tp["dec_layers"]["cross"])
    x = _t(_frames(2, 1, seed=10), torch.bfloat16)
    zeros = torch.zeros((2, 16, 4, 16), dtype=torch.bfloat16)
    out = TE._cross_attend(block, x, zeros, zeros,
                           tapi.cfg.attn_spec(causal=True))
    assert torch.equal(out, x)


def test_greedy_trajectories_equal_float32(jax_params):
    """Both packages' ``reference_decode`` through their registry's
    serving cache: the same tokens in float32."""
    japi, jp, tapi, tp = _pair(jax_params, torch.float32)
    prompts = _tokens(4, 6, seed=11)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           12, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 12, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

def test_full_config_values_and_published_size():
    """tests/test_models.py:74-84 and :197-198: 6 layers a side, d_model
    512, 8 heads (MHA), d_ff 2048, vocab 51865; 0.071 B parameters within
    10 %, the reference's count exactly."""
    cfg = TR.build(ARCH, device="cpu").cfg
    jcfg = R.build(ARCH).cfg
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab) == (6, 512, 8, 8, 2048, 51865)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count() / 1e9 == pytest.approx(0.071, rel=0.1)
    smoke = TR.build(ARCH, smoke=True, device="cpu").cfg
    assert (smoke.num_layers, smoke.d_model, smoke.num_heads, smoke.d_ff,
            smoke.vocab) == (2, 64, 4, 128, 256)
    assert smoke.param_count() == R.build(ARCH, smoke=True).cfg.param_count()


def test_registry_entry():
    from repro_torch import configs
    assert ARCH in configs.ARCH_IDS
    api = TR.build(ARCH, smoke=True, device="cpu")
    assert (api.family, api.cache_kind) == ("audio", "ring")
    assert TR.FAMILY[ARCH] == R.FAMILY[ARCH] == "audio"
    assert api.param_count == api.active_param_count == \
        api.cfg.param_count()
    cache = api.init_cache(3, 40)
    # the cross K/V sized to cache_len, as the reference sizes it
    assert cache["cross_k"].shape == cache["cross_v"].shape == \
        (2, 3, 40, 4, 16)
    assert cache["self"]["k"].shape == (2, 3, 40, 4, 16)
    jcache = R.build(ARCH, smoke=True).init_cache(3, 40)
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        t = cache
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
