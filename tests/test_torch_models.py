"""Port's dense decoder against the JAX package on the smoke config: the
reference's own weights (bf16 passed through float32, which is exact),
the same inputs made with numpy, ``decode_step`` logits and greedy
trajectories."""

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
