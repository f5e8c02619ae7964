"""Port's dense decoder against the JAX package on the smoke configs
(smollm-135m, paligemma-3b, llama3.2-3b, qwen2.5-14b with its QKV bias,
stablelm-3b): the reference's own weights (bf16 passed through float32,
which is exact), the same inputs made with numpy, ``decode_step`` logits
and greedy trajectories, the full-sequence forward, loss, prefill and
the serve and prefill steps."""

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
from repro.serve import reference_decode as jax_reference_decode  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import reference_decode  # noqa: E402

ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def jax_params():
    api = R.build(ARCH, smoke=True)
    return api, api.init(jax.random.PRNGKey(0))


def _pair(jax_params, dtype):
    """(jax api, jax params, port api, port params) in ``dtype``."""
    api, params = jax_params
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    japi = R._lm_api(ARCH, dataclasses.replace(api.cfg, dtype=jdt))
    jp = jax.tree.map(lambda a: a.astype(jdt), params)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg, dtype=dtype)
    tapi = TR._lm_api(ARCH, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return japi, jp, tapi, TT.params_from_jax(npt, tcfg)


def _logit_gap(jax_params, dtype, steps=8, B=3, cache_len=16):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    jstep = jax.jit(japi.decode_step)
    jc, tc = japi.init_cache(B, cache_len), tapi.init_cache(B, cache_len)
    rng = np.random.default_rng(5)
    worst = 0.0
    for t in range(steps):
        toks = rng.integers(0, japi.cfg.vocab, B).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
        worst = max(worst, float(np.max(np.abs(
            np.asarray(jl, np.float32) - tl.float().numpy()))))
    return worst


def test_decode_step_logits_float32(jax_params):
    assert _logit_gap(jax_params, torch.float32) <= 1e-5


def test_decode_step_logits_bf16(jax_params):
    # bf16 matmuls round differently in XLA and PyTorch; logits are
    # ~0.5 in magnitude, where one bf16 ulp is 2**-8: allow a few ulps.
    assert _logit_gap(jax_params, torch.bfloat16) <= 2e-2


def test_greedy_trajectories_equal_float32(jax_params):
    japi, jp, tapi, tp = _pair(jax_params, torch.float32)
    prompts = np.random.default_rng(6).integers(
        0, japi.cfg.vocab, (4, 6)).astype(np.int32)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           12, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 12, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_tree_layout_matches_reference(jax_params):
    api, params = jax_params
    tapi = TR.build(ARCH, smoke=True, device="cpu")
    own = tapi.init(torch.Generator().manual_seed(0))

    def shapes(tree, leaf):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf) for k, v in tree.items()}
        return leaf(tree)

    assert shapes(own, lambda t: tuple(t.shape)) == shapes(
        params, lambda a: tuple(a.shape))
    assert all(t.dtype == torch.bfloat16 for t in (
        own["embed"], own["layers"]["attn"]["wq"], own["ln_f"]["scale"]))
    assert tapi.param_count == api.param_count


def test_own_init_is_seeded():
    tapi = TR.build(ARCH, smoke=True, device="cpu")
    a = tapi.init(torch.Generator().manual_seed(3))
    b = tapi.init(torch.Generator().manual_seed(3))
    c = tapi.init(torch.Generator().manual_seed(4))
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])


def test_argmax_picks_the_first_maximum_in_both():
    x = np.asarray([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    np.testing.assert_array_equal(
        torch.argmax(torch.from_numpy(x), dim=-1).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)))


def test_full_config_is_the_published_width():
    cfg = TR.build(ARCH, device="cpu").cfg
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == (
        30, 576, 9, 3, 1536, 49152, True)
    assert cfg.param_count() == R.build(ARCH).param_count


# ---------------------------------------------------------------------------
# the full-sequence forward (prefill / loss) of both dense decoders
# ---------------------------------------------------------------------------

from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_prefill_step, make_serve_step)
from repro_torch.models import layers as TL  # noqa: E402

ARCHS = ["smollm-135m", "paligemma-3b", "llama3.2-3b", "qwen2.5-14b",
         "stablelm-3b"]
B_FWD, S_FWD = 2, 16
# f32: the two frameworks differ only in the order of f32 sums (and, with
# use_kernel, the reference's Pallas kernel keeps P in f32 where the
# port's CPU path runs the plain version); bf16: several bf16 roundings
# per layer land on other values, logits are ~0.5, one bf16 ulp there is
# 2**-9 — allow a few ulps
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _ulp_scale(want, dtype) -> float:
    """The bf16 tolerances are set in ulps of logits below 1 (smollm's
    and paligemma's reach ~0.6, one ulp 2**-8 there). The untied heads
    of qwen2.5-14b and stablelm-3b give logits up to ~4, where one bf16
    ulp is 4-8x larger: the tolerance grows with the ulp at the largest
    |logit| (1 below 1, so the other configs keep theirs)."""
    if dtype != torch.bfloat16:
        return 1.0
    top = float(np.max(np.abs(np.asarray(want, np.float32))))
    return 2.0 ** max(0, int(np.floor(np.log2(top))) + 1) if top else 1.0


@pytest.fixture(scope="module")
def arch_params():
    out = {}
    for arch in ARCHS:
        api = R.build(arch, smoke=True)
        out[arch] = (api, api.init(jax.random.PRNGKey(1)))
    return out


def _arch_pair(arch_params, arch, dtype):
    """(jax cfg, jax params, port api, port params) in ``dtype``."""
    api, params = arch_params[arch]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(api.cfg, dtype=jdt)
    jp = jax.tree.map(lambda a: a.astype(jdt), params)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True,
                                        device="cpu").cfg, dtype=dtype)
    tapi = TR._lm_api(arch, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, jp, tapi, TT.params_from_jax(npt, tcfg)


def _batch(cfg, S=S_FWD, seed=11):
    """numpy tokens (B, S), next-token labels with the prefix and one
    more position ignored (-1), and prefix embeddings for a prefix-LM
    config."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B_FWD, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, cfg.prefix_len] = -1
    labels[:, :cfg.prefix_len] = -1
    pe = None
    if cfg.prefix_len:
        pe = (0.1 * rng.standard_normal(
            (B_FWD, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    return toks[:, :S], labels, pe


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch_params, arch, dtype,
                                            use_kernel):
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, dtype)
    toks, _, pe = _batch(jcfg)
    want, jaux = JT.forward(jp, jcfg, _j(toks), _j(pe), use_kernel)
    got, aux = TT.forward(tp, tapi.cfg, _t(toks), _t(pe), use_kernel)
    assert got.dtype == dtype and got.shape == (B_FWD, S_FWD, jcfg.vocab)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=FWD_TOL[dtype] * _ulp_scale(want, dtype),
                               rtol=0)
    assert aux.item() == float(jaux) == 0.0


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_the_reference(arch_params, arch, use_kernel):
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, torch.float32)
    toks, labels, pe = _batch(jcfg)
    jbatch = {"tokens": _j(toks), "labels": _j(labels)}
    tbatch = {"tokens": _t(toks), "labels": _t(labels)}
    if pe is not None:
        jbatch["prefix_embeds"], tbatch["prefix_embeds"] = _j(pe), _t(pe)
    want, jm = JT.loss_fn(jp, jcfg, jbatch, use_kernel)
    got, m = TT.loss_fn(tp, tapi.cfg, tbatch, use_kernel)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert abs(m["ce"].item() - float(jm["ce"])) <= 1e-5 * float(jm["ce"])
    if not use_kernel:       # the registry's loss runs the plain forward
        reg, _ = tapi.loss_fn(tp, tbatch)
        assert reg.item() == got.item()


@pytest.mark.parametrize("cache_extra", [4, -5])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_the_reference(arch_params, arch,
                                             cache_extra):
    """The ring cache (k, v, pos) and the logits of ``prefill``, with a
    cache longer than the sequence (empty slots stay -1) and shorter
    (the last W positions wrap into slots pos % W)."""
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, torch.float32)
    toks, _, pe = _batch(jcfg)
    cache_len = S_FWD + cache_extra
    jl, jc = JT.prefill(jp, jcfg, _j(toks), _j(pe), cache_len=cache_len)
    tl, tc = TT.prefill(tp, tapi.cfg, _t(toks), _t(pe), cache_len=cache_len)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(jl[:, -1]),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continues_the_forward(arch_params, arch):
    """``tests/test_models.py``'s prefill-then-decode pattern on the port
    (bf16, its atol 1e-2): prefill S tokens into a cache of S + 4, decode
    4 more, and match the full forward over all S + 4."""
    _, _, tapi, tp = _arch_pair(arch_params, arch, torch.bfloat16)
    cfg = tapi.cfg
    toks, _, pe = _batch(cfg, S=S_FWD + 4, seed=12)
    toks, pe = _t(toks), _t(pe)
    full, _ = TT.forward(tp, cfg, toks, pe)
    lg, cache = TT.prefill(tp, cfg, toks[:, :S_FWD], pe,
                           cache_len=S_FWD + 4)
    torch.testing.assert_close(lg[:, -1].float(),
                               full[:, S_FWD - 1].float(), atol=1e-2,
                               rtol=0)
    for i in range(4):
        pos = torch.full((B_FWD,), S_FWD + i, dtype=torch.int32)
        ld, cache = tapi.decode_step(tp, cache, toks[:, S_FWD + i], pos)
        torch.testing.assert_close(ld.float(), full[:, S_FWD + i].float(),
                                   atol=1e-2, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_argmax_matches_the_reference(arch_params, arch):
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, torch.float32)
    toks, _, pe = _batch(jcfg)
    japi = R._lm_api(arch, jcfg)
    jb, tb = {"tokens": _j(toks)}, {"tokens": _t(toks)}
    if pe is not None:
        jb["prefix_embeds"], tb["prefix_embeds"] = _j(pe), _t(pe)
    jarg, jlog = jax_steps.make_prefill_step(japi)(jp, jb)
    targ, tlog = make_prefill_step(tapi)(tp, tb)
    np.testing.assert_array_equal(targ.numpy(), np.asarray(jarg))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_the_reference(arch_params, arch):
    """``make_serve_step`` after ``prefill``: the greedy next token and the
    cache it leaves against the reference's serve step."""
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, torch.float32)
    toks, _, pe = _batch(jcfg, S=S_FWD + 1, seed=14)
    japi = R._lm_api(arch, jcfg)
    _, jc = JT.prefill(jp, jcfg, _j(toks[:, :S_FWD]), _j(pe),
                       cache_len=S_FWD + 2)
    _, tc = TT.prefill(tp, tapi.cfg, _t(toks[:, :S_FWD]), _t(pe),
                       cache_len=S_FWD + 2)
    jnext, jc = jax_steps.make_serve_step(japi)(
        jp, jc, _j(toks[:, S_FWD]), jnp.full((B_FWD,), S_FWD, jnp.int32))
    tnext, tc = make_serve_step(tapi)(
        tp, tc, _t(toks[:, S_FWD]),
        torch.full((B_FWD,), S_FWD, dtype=torch.int32))
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("ignore_id", [-1, 3])
def test_cross_entropy_matches_the_reference(ignore_id):
    rng = np.random.default_rng(13)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = ignore_id
    labels[2, 5] = -1
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            ignore_id)
    got = TL.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), ignore_id)
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    # every label ignored: the mean over no tokens is 0, not NaN
    none = TL.cross_entropy(torch.from_numpy(logits),
                            torch.full((3, 7), ignore_id), ignore_id)
    assert none.item() == 0.0


def test_paligemma_full_config_is_the_published_width():
    cfg = TR.build("paligemma-3b", device="cpu").cfg
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab, cfg.prefix_len,
            cfg.embed_scale) == (18, 2048, 8, 1, 256, 16384, 257216, 256,
                                 True)
    assert cfg.param_count() == R.build("paligemma-3b").param_count
    assert TR.FAMILY["paligemma-3b"] == R.FAMILY["paligemma-3b"] == "vlm"


# ---------------------------------------------------------------------------
# the other dense configs: decode, greedy trajectories, published widths
# ---------------------------------------------------------------------------

DENSE = ["llama3.2-3b", "qwen2.5-14b", "stablelm-3b"]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_decode_logits_match_the_reference(arch_params, arch,
                                                        dtype, tol):
    """``decode_step`` logits over 8 steps, within smollm's tolerances
    (in bf16 at the logits' own scale, ``_ulp_scale``)."""
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, dtype)
    japi = R._lm_api(arch, jcfg)
    jstep = jax.jit(japi.decode_step)
    B, cache_len = 3, 16
    jc, tc = japi.init_cache(B, cache_len), tapi.init_cache(B, cache_len)
    rng = np.random.default_rng(5)
    worst, scale = 0.0, 1.0
    for t in range(8):
        toks = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
        worst = max(worst, float(np.max(np.abs(
            np.asarray(jl, np.float32) - tl.float().numpy()))))
        scale = max(scale, _ulp_scale(jl, dtype))
    assert worst <= tol * scale


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_greedy_trajectories_equal_float32(arch_params, arch):
    jcfg, jp, tapi, tp = _arch_pair(arch_params, arch, torch.float32)
    japi = R._lm_api(arch, jcfg)
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab, (4, 6)).astype(np.int32)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           12, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 12, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,want", [
    ("llama3.2-3b", (28, 3072, 24, 8, 128, 8192, 128256, True, False)),
    ("qwen2.5-14b", (48, 5120, 40, 8, 128, 13824, 152064, False, True)),
    ("stablelm-3b", (32, 2560, 32, 32, 80, 6912, 50304, False, False))])
def test_dense_config_full_is_the_published_width(arch, want):
    """The FULL configs equal the reference's; their head dims (128, 128,
    80) are ones the CUDA flash kernel takes."""
    cfg = TR.build(arch, device="cpu").cfg
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab,
            cfg.tie_embeddings, cfg.qkv_bias) == want
    jcfg = R.build(arch).cfg
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab", "head_dim", "qkv_bias", "window", "rope_theta",
              "prefix_len", "embed_scale", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(TR.build(arch, smoke=True, device="cpu").cfg, f) == \
            getattr(R.build(arch, smoke=True).cfg, f), f
    assert cfg.param_count() == R.build(arch).param_count
    assert TR.FAMILY[arch] == R.FAMILY[arch] == "dense"
