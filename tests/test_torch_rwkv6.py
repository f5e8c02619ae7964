"""Port's RWKV6 family against the JAX package on the CPU: the WKV6
recurrence (``ref.wkv6`` and ``ops.wkv6``, which runs the plain version
for a CPU tensor) against the Pallas kernel in interpret mode and its
``lax.scan`` oracle on the shapes and tolerances of
``tests/test_kernels.py``'s WKV tests; ``layernorm``; the rwkv6-7b smoke
model's ``forward``, ``loss_fn`` and ``decode_step`` on the reference's
own weights; the registry entry, the step functions and the serve CLI.
Inputs are made with numpy from a seed and handed to both."""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.serve import reference_decode as jax_reference_decode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.serve import reference_decode  # noqa: E402

ARCH = "rwkv6-7b"
# the reference's WKV tolerance (tests/test_kernels.py:107)
WKV_TOL = 1e-4
# f32 models: the same function in two frameworks, summed in other orders
F32_TOL = 1e-4
# bf16 models: XLA and PyTorch round the bf16 lerps and matmuls at other
# places; the logits reach ~4, where one bf16 ulp is 2**-6 ~ 0.016, and
# differ by about two ulps (0.033) after the two layers: allow three
BF16_LOGIT_TOL = 5e-2


def _wkv_inputs(B, S, H, hs, seed):
    """r, k, v N(0, 1), w = sigmoid(N) * 0.5 + 0.45, u 0.3 N(0, 1), as
    ``tests/test_kernels.py`` draws them, in numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hs)).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hs))))
         + 0.45).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hs))).astype(np.float32)
    return r, k, v, w, u


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("B,S,H,hs,chunk", [
    (2, 256, 2, 32, 64),
    (1, 128, 4, 64, 128),
    (2, 64, 1, 16, 32),
    (1, 192, 3, 32, 64),
])
def test_wkv6_matches_the_pallas_kernel_and_its_oracle(B, S, H, hs, chunk):
    jin, tin = _both(_wkv_inputs(B, S, H, hs, seed=B * S + H + hs))
    pallas = np.asarray(jops.wkv6(*jin, chunk=chunk))
    oracle = np.asarray(jref.wkv6(*jin)[0])
    got = ops.wkv6(*tin, chunk=chunk)
    plain, _ = ref.wkv6(*tin)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hs)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), want, atol=WKV_TOL,
                                   rtol=WKV_TOL)
        np.testing.assert_allclose(plain.numpy(), want, atol=WKV_TOL,
                                   rtol=WKV_TOL)


def test_wkv6_state_continuity_across_chunks():
    """The chunk is only a contract: chunk 32 and chunk 256 give the same
    result, as the Pallas kernel does with its state carried in VMEM."""
    B, S, H, hs = 1, 256, 2, 32
    rng = np.random.default_rng(11)
    r, k, v = (rng.standard_normal((B, S, H, hs)).astype(np.float32)
               for _ in range(3))
    w = np.full((B, S, H, hs), 0.9, np.float32)
    u = np.zeros((H, hs), np.float32)
    jin, tin = _both((r, k, v, w, u))
    a = ops.wkv6(*tin, chunk=32)
    b = ops.wkv6(*tin, chunk=256)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(a.numpy(),
                               np.asarray(jops.wkv6(*jin, chunk=32)),
                               atol=WKV_TOL, rtol=WKV_TOL)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wkv6_refuses_an_indivisible_sequence_on_every_device(device):
    jin, tin = _both(_wkv_inputs(1, 100, 2, 16, seed=0))
    with pytest.raises(ValueError):
        jops.wkv6(*jin, chunk=64)
    with pytest.raises(ValueError, match="divisible"):
        ops.wkv6(*(t.to(device) for t in tin), chunk=64)
    assert ops.wkv6(*tin, chunk=50).shape == (1, 100, 2, 16)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_scan_final_state_matches_the_reference(with_state):
    B, S, H, hs = 2, 48, 2, 16
    arrs = _wkv_inputs(B, S, H, hs, seed=21)
    s0 = (np.random.default_rng(22).standard_normal((B, H, hs, hs))
          .astype(np.float32) if with_state else None)
    jin, tin = _both(arrs)
    jout, jstate = JW.wkv_scan(*jin, None if s0 is None else jnp.asarray(s0))
    out, state = TW.wkv_scan(*tin, None if s0 is None
                             else torch.from_numpy(s0))
    assert state.shape == (B, H, hs, hs) and state.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                               atol=WKV_TOL, rtol=WKV_TOL)


def _wkv_factored(r, k, v, w, u):
    """The CUDA kernel's arithmetic (``wkv6_kernel``) in torch: the state
    update rounded where the plain loop rounds (k*v, w*S, w*S + kv), and
    the output in the factored form sum_i r_i S_ij + v_j c_t with the
    bonus dot c_t = sum_i r_i u_i k_i taken once per step."""
    B, S, H, hs = r.shape
    state = torch.zeros((B, H, hs, hs))
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        c = (rt * u * kt).sum(-1, keepdim=True)                  # (B, H, 1)
        outs.append(torch.einsum("bhi,bhij->bhj", rt, state) + vt * c)
        kv = kt[..., :, None] * vt[..., None, :]
        state = wt[..., :, None] * state + kv
    return torch.stack(outs, dim=1), state


@pytest.mark.parametrize("B,S,H,hs,chunk", [
    (2, 256, 2, 32, 64),
    (1, 128, 4, 64, 128),
    (2, 64, 1, 16, 32),
    (1, 192, 3, 32, 64),
    (1, 96, 2, 128, 32),
])
def test_wkv6_factored_form_matches_the_pallas_kernel(B, S, H, hs, chunk):
    """The kernel's factored output against the Pallas kernel in
    interpret mode and its oracle at the reference's tolerance, with a
    state bit-equal to the plain loop's."""
    arrs = _wkv_inputs(B, S, H, hs, seed=B * S + H + hs + 1)
    jin, tin = _both(arrs)
    got, state = _wkv_factored(*tin)
    _, plain_state = ref.wkv6(*tin)
    assert torch.equal(state, plain_state)
    for want in (np.asarray(jops.wkv6(*jin, chunk=chunk)),
                 np.asarray(jref.wkv6(*jin)[0])):
        np.testing.assert_allclose(got.numpy(), want, atol=WKV_TOL,
                                   rtol=WKV_TOL)


def test_wkv6_wrapper_refuses_cpu_tensors_without_building():
    t = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rs.wkv6(t, t, t, t, torch.zeros((2, 16)))
    assert rs._lib is None and rs.LAUNCHES["wkv6"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_matches_the_reference(dtype):
    """f32 statistics and the population variance: an input with a large
    mean and few features, where the unbiased variance would differ."""
    from repro.models import layers as jnn
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((3, 5, 8))).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jnn.layernorm({"scale": jnp.asarray(scale).astype(jdt),
                          "bias": jnp.asarray(bias).astype(jdt)},
                         jnp.asarray(x).astype(jdt))
    got = nn.layernorm({"scale": torch.from_numpy(scale).to(dtype),
                        "bias": torch.from_numpy(bias).to(dtype)},
                       torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    init = nn.layernorm_init((2,), 8, dtype)
    assert torch.equal(init["scale"], torch.ones((2, 8), dtype=dtype))
    assert torch.equal(init["bias"], torch.zeros((2, 8), dtype=dtype))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    api = R.build(ARCH, smoke=True)
    return api, api.init(jax.random.PRNGKey(0))


def _pair(jax_params, dtype):
    """(jax api, jax params, port api, port params) in ``dtype``; the f32
    leaves stay f32 in both."""
    api, params = jax_params
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    japi = R._rwkv_api(ARCH, dataclasses.replace(api.cfg, dtype=jdt))
    jp = jax.tree.map(
        lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16 else a, params)
    tcfg = dataclasses.replace(TR.build(ARCH, smoke=True,
                                        device="cpu").cfg, dtype=dtype)
    tapi = TR._rwkv_api(ARCH, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return japi, jp, tapi, TW.params_from_jax(npt, tcfg)


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_params_tree_matches_the_reference(jax_params):
    """The port's own init and the converted reference tree have the
    reference's layout, shapes and dtypes (``tm.w0`` and ``tm.u`` f32)."""
    api, params = jax_params
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    own = TR.build(ARCH, smoke=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = _pair(jax_params, torch.bfloat16)[3]
    jdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for tree in (own, conv):
        for path, leaf in want:
            t = tree
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
            assert t.dtype == jdt[str(leaf.dtype)], path
    lay = own["layers"]
    assert torch.all(lay["tm"]["w0"] == -6.0)
    # U(0, 1) in f32, rounded to bf16 (which can round up to 1)
    assert lay["tm"]["mu"].min() >= 0 and lay["tm"]["mu"].max() <= 1
    assert torch.all(lay["cm"]["mu_k"] == 0.5)
    assert torch.equal(lay["ln1"]["scale"], torch.ones_like(
        lay["ln1"]["scale"]))
    assert 0.4 < lay["tm"]["u"].std().item() < 0.6


def test_param_count_leaves_out_ln_in(jax_params):
    """``param_count`` is the reference's formula, which counts one final
    layernorm and not ``ln_in`` as well: the tree holds 2*d more
    parameters, in both packages (ROADMAP Queue 3)."""
    api, params = jax_params
    own = TR.build(ARCH, smoke=True, device="cpu").init(
        torch.Generator().manual_seed(0))

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        return tree.numel()

    jax_numel = sum(a.size for a in jax.tree.leaves(params))
    d = api.cfg.d_model
    assert numel(own) == jax_numel == api.cfg.param_count() + 2 * d
    assert TR.build(ARCH, smoke=True, device="cpu").param_count == \
        api.cfg.param_count()


def test_own_init_is_seeded():
    api = TR.build(ARCH, smoke=True, device="cpu")
    a = api.init(torch.Generator().manual_seed(3))
    b = api.init(torch.Generator().manual_seed(3))
    assert torch.equal(a["layers"]["cm"]["wk"], b["layers"]["cm"]["wk"])
    assert torch.equal(a["head"], b["head"])


def test_full_config_is_the_published_width():
    cfg = TR.build(ARCH, device="cpu").cfg
    jcfg = R.build(ARCH).cfg
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
            cfg.head_size, cfg.num_heads, cfg.decay_lora) == (
        32, 4096, 14336, 65536, 64, 64, 64)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == 7.53
    smoke = TR.build(ARCH, smoke=True, device="cpu").cfg
    assert (smoke.num_layers, smoke.d_model, smoke.d_ff, smoke.vocab,
            smoke.head_size, smoke.decay_lora) == (2, 64, 224, 256, 16, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_logits_match_the_reference(jax_params, dtype, use_kernel):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks = _tokens(2, 24, seed=7)
    want = np.asarray(japi.forward(jp, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got, aux = TW.forward(tp, tapi.cfg, torch.from_numpy(toks), use_kernel)
    assert got.dtype == dtype and got.shape == (2, 24, 256)
    assert aux.item() == 0.0
    tol = F32_TOL if dtype == torch.float32 else BF16_LOGIT_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    if dtype == torch.float32:
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_forward_with_and_without_the_kernel_path_agree_on_the_cpu(
        jax_params):
    """On the CPU ``ops.wkv6`` is the plain scan: the two paths are one
    function, bit for bit."""
    _, _, tapi, tp = _pair(jax_params, torch.bfloat16)
    toks = torch.from_numpy(_tokens(2, 20, seed=8))
    a, _ = TW.forward(tp, tapi.cfg, toks, use_kernel=True)
    b, _ = TW.forward(tp, tapi.cfg, toks, use_kernel=False)
    assert torch.equal(a, b)
    assert torch.equal(a, tapi.forward(tp, {"tokens": toks}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_fn_matches_the_reference(jax_params, dtype):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    toks = _tokens(2, 17, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jm = japi.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tapi.loss_fn(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tm["aux"].item() == 0.0
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert abs(tl.item() - float(jl)) <= tol * abs(float(jl))


def _decode_gap(jax_params, dtype, steps=8, B=3):
    japi, jp, tapi, tp = _pair(jax_params, dtype)
    jstep = jax.jit(japi.decode_step)
    jc, tc = japi.init_cache(B, 16), tapi.init_cache(B, 16)
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
    for key in ("wkv", "tm_last", "cm_last"):
        assert tc[key].dtype == {"wkv": torch.float32}.get(key, dtype)
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   atol=1e-4 if dtype == torch.float32
                                   else 5e-2, rtol=1e-2)
    return worst


def test_decode_step_logits_float32(jax_params):
    assert _decode_gap(jax_params, torch.float32) <= F32_TOL


def test_decode_step_logits_bf16(jax_params):
    assert _decode_gap(jax_params, torch.bfloat16) <= BF16_LOGIT_TOL


def test_greedy_trajectories_equal_float32(jax_params):
    japi, jp, tapi, tp = _pair(jax_params, torch.float32)
    prompts = _tokens(4, 6, seed=6)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           12, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 12, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_step_leaves_its_input_cache_untouched(jax_params):
    _, _, tapi, tp = _pair(jax_params, torch.bfloat16)
    cache = tapi.init_cache(2, 0)
    cache["wkv"].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in cache.items()}
    _, new = tapi.decode_step(tp, cache, torch.tensor([3, 4]), None)
    for k in cache:
        assert torch.equal(cache[k], before[k])
        assert not torch.equal(new[k], before[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stepwise_decode_equals_the_forward(dtype):
    """``decode_step`` token by token reproduces the teacher-forced
    forward (tests/test_models.py:103-118), inside the port."""
    api = TR.build(ARCH, smoke=True, device="cpu")
    cfg = dataclasses.replace(api.cfg, dtype=dtype)
    api = TR._rwkv_api(ARCH, cfg, "cpu")
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


# ---------------------------------------------------------------------------
# registry, step functions, CLI
# ---------------------------------------------------------------------------

def test_registry_entry():
    from repro_torch import configs
    assert ARCH in configs.ARCH_IDS
    api = TR.build(ARCH, smoke=True, device="cpu")
    assert (api.family, api.cache_kind) == ("ssm", "recurrent")
    assert TR.FAMILY[ARCH] == R.FAMILY[ARCH] == "ssm"
    assert api.param_count == api.active_param_count == \
        api.cfg.param_count()
    cache = api.init_cache(3, 64)
    assert cache["wkv"].shape == (2, 3, 4, 16, 16)
    assert cache["tm_last"].shape == cache["cm_last"].shape == (2, 3, 64)
    assert cache["tm_last"].dtype == torch.bfloat16


def test_step_functions_run_rwkv(jax_params):
    """``make_prefill_step`` and ``make_serve_step`` go through the RWKV
    ``forward`` and ``decode_step`` and match the reference's."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps
    japi, jp, tapi, tp = _pair(jax_params, torch.float32)
    toks = _tokens(2, 10, seed=12)
    jn, jlog = jsteps.make_prefill_step(japi)(jp, {"tokens":
                                                    jnp.asarray(toks)})
    tn, tlog = steps.make_prefill_step(tapi)(tp, {"tokens":
                                                   torch.from_numpy(toks)})
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=F32_TOL, rtol=0)
    jc, tc = japi.init_cache(2, 16), tapi.init_cache(2, 16)
    jserve, tserve = (jsteps.make_serve_step(japi),
                      steps.make_serve_step(tapi))
    for t in range(4):
        pos = np.full((2,), t, np.int32)
        jn, jc = jserve(jp, jc, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        tn, tc = tserve(tp, tc, torch.from_numpy(toks[:, t]),
                        torch.from_numpy(pos))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_cli_serves_rwkv_unpaged(monkeypatch, capsys):
    """``--arch rwkv6-7b --device cpu`` gates paging off and reports the
    reference CLI's host-deterministic counts on the default arguments
    (``python -m repro.launch.serve --arch rwkv6-7b``: 8 requests, 128
    tokens, 40 steps, 16 host dispatches, 16 megasteps, 1 blocked
    boundary)."""
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device",
                                      "cpu", "--no-warmup"])
    assert serve.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["arch"] == ARCH
    assert report["paging"]["paged"] is False
    assert (report["requests"], report["generated_tokens"],
            report["steps"], report["host_dispatches"],
            report["paging"]["megasteps"], report["host_blocked"]) == (
        8, 128, 40, 16, 16, 1)
