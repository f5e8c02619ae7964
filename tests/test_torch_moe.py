"""Port's MoE family against the JAX package on the CPU: ``moe_capacity``
over a grid of token counts, ``top_k`` against ``lax.top_k`` (the lower
index first among equal values, -0.0 below +0.0), ``moe_apply`` in f32
and bf16 (with capacity headroom and with drops, on exact ties from a
router with duplicated columns, on signed-zero ties) and
``moe_aux_loss``; the mixtral-8x7b and kimi-k2-1t-a32b smoke models'
``forward`` (``aux`` included), ``loss_fn`` and ``decode_step`` on the
reference's own weights (``params_from_jax``, the router kept f32),
greedy tokens in float32, the port's stepwise decode against its own
forward and the sliding-window ring eviction; the FULL configs' values
and parameter counts; and that the combine adds each token's slots in a
fixed order whatever order top-k returns them in. Inputs are made with
numpy from a seed and handed to both.

Routing near ties: the two frameworks sum the router's f32 products in
other orders, and in bf16 round the hidden state at other places, so
an expert whose logit is within a hair of the K-th can be picked by one
and not the other. Where a test compares whole forwards, it compares the
positions of each batch row before the first token whose gap between
the K-th and (K+1)-th router logit (in any layer of the port's run) is
below ``NEAR_TIE[dtype]``, and counts the positions it leaves out; the
MoE block alone is compared on the same input everywhere."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import reference_decode as jax_reference_decode  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import reference_decode  # noqa: E402

ARCHS = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# the MoE block alone on the same input: f32 differs in the order of the
# router's and the experts' f32 sums (outputs reach ~2.3, an f32 ulp
# there is 2.4e-7); bf16 rounds the same exact products to the same
# values but for a rare last-bit case: allow one bf16 ulp at 2.3 (2**-7)
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# whole forwards: f32 as the dense configs (1e-4); bf16 in ulps of the
# untied heads' logits (~2-4 here, one bf16 ulp 2**-7 to 2**-6): the two
# frameworks' bf16 forwards differ by up to 0.04 where the routing
# agrees, allow 0.08
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}
# a router logit gap below which the other framework may pick the other
# expert: at these widths the two frameworks' layer-by-layer router
# logits differ by at most 3e-6, in f32 and in bf16 (whose hidden states
# mostly round to the same values); an ulp of difference in a bf16
# hidden state moves a logit by ~1e-3, so bf16 allows more
NEAR_TIE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def _jax_tree(params, dtype, E):
    """The reference's params in ``dtype``, the f32 router kept f32."""
    jdt = JDT[dtype]

    def cast(path, a):
        return a if path[-1].key == "router" else a.astype(jdt)
    return jax.tree_util.tree_map_with_path(cast, params)


@pytest.fixture(scope="module")
def arch_params():
    out = {}
    for arch in ARCHS:
        api = R.build(arch, smoke=True)
        out[arch] = (api, api.init(jax.random.PRNGKey(1)))
    return out


def _pair(arch_params, arch, dtype, **cfg_kw):
    """(jax cfg, jax params, port api, port params) in ``dtype``."""
    api, params = arch_params[arch]
    jcfg = dataclasses.replace(api.cfg, dtype=JDT[dtype], **cfg_kw)
    jp = _jax_tree(params, dtype, api.cfg.moe.num_experts)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True, device="cpu").cfg,
                               dtype=dtype, **cfg_kw)
    tapi = TR._lm_api(arch, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, jp, tapi, TT.params_from_jax(npt, tcfg)


def _layer0(arch_params, arch, dtype):
    """Layer 0's MoE params in both packages, and the spec."""
    api, params = arch_params[arch]
    mp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    jm = {k: v if k == "router" else v.astype(JDT[dtype])
          for k, v in mp.items()}
    tm = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else dtype) for k, v in mp.items()}
    return jm, tm, api.cfg.moe


def _n(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _gap(logits: np.ndarray, k: int) -> np.ndarray:
    s = -np.sort(-logits, axis=-1)
    return s[..., k - 1] - s[..., k]


# ---------------------------------------------------------------------------
# capacity and top-k
# ---------------------------------------------------------------------------

TOKENS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 100, 127, 128, 129, 200,
          255, 256, 257, 300, 511, 512, 513, 1000, 1023, 1024, 1025, 2047,
          2048]


@pytest.mark.parametrize("spec", [
    (8, 2, 1.25), (4, 2, 1.25), (384, 8, 1.25), (8, 4, 1.25), (4, 2, 4.0),
    (8, 4, 0.5), (8, 2, 0.5), (3, 1, 1.0)])
def test_moe_capacity_equals_the_reference(spec):
    """The clamp to [8, T] and the round-up to 256 above 256, on a grid
    of T that crosses both (the round-up where 2048 tokens need more than
    256 slots an expert)."""
    E, K, cf = spec
    js, ts = JL.MoESpec(E, K, cf), TL.MoESpec(E, K, cf)
    got = [TL.moe_capacity(T, ts) for T in TOKENS]
    assert got == [JL.moe_capacity(T, js) for T in TOKENS]
    assert all(isinstance(c, int) for c in got) and got[0] == 8
    if K * 2048 * cf / E > 256:           # the grid reaches the round-up
        assert got[-1] > 256 and got[-1] % 256 == 0


@pytest.mark.parametrize("values,k", [
    ([1, 3, 3, 2, 3, -0.0, 0, 0], 5),
    ([0, -0.0, 0, -1], 3),
    ([-0.0, 0.0, -0.0, 0.0, -1e-30, 1e-30], 6),
    ([2.0] * 8, 4)])
def test_top_k_tie_order_equals_lax(values, k):
    """The issue cases: ``torch.topk`` orders the ties otherwise."""
    x = np.asarray([values], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = TL.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.signbit(tv.numpy()),
                                  np.signbit(np.asarray(jv)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_top_k_on_many_ties_equals_lax(k):
    """Rows of small integers and signed zeros (ties everywhere), and of
    normals, at the two MoE smoke widths and kimi-k2's 384."""
    rng = np.random.default_rng(4)
    for E in (8, 16, 384):
        ints = rng.integers(-2, 3, (64, E)).astype(np.float32)
        ints[rng.random((64, E)) < 0.3] = -0.0
        for x in (ints, rng.standard_normal((64, E)).astype(np.float32)):
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            tv, ti = TL.top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(
                tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _routing(logits: np.ndarray, k: int) -> np.ndarray:
    return np.asarray(jax.lax.top_k(jnp.asarray(logits), k)[1])


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_the_reference(arch_params, arch, dtype,
                                         capacity_factor):
    """Layer 0's block on one (3, 11, D) input: with headroom (no slot
    dropped) and at capacity factor 0.5 (slots dropped). The experts the
    port picks equal ``lax.top_k``'s on the reference's logits wherever
    the K-th gap exceeds the f32 near-tie (near ties counted: none at
    this seed)."""
    jm, tm, spec = _layer0(arch_params, arch, dtype)
    js = dataclasses.replace(spec, capacity_factor=capacity_factor)
    ts = TL.MoESpec(js.num_experts, js.top_k, capacity_factor)
    x = np.random.default_rng(2).standard_normal(
        (3, 11, jm["router"].shape[0])).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(dtype)
    want = JL.moe_apply(jm, xj, js)
    got = TL.moe_apply(tm, xt, ts)
    assert got.dtype == dtype and got.shape == xt.shape
    np.testing.assert_allclose(_n(got), _n(want), atol=MOE_TOL[dtype],
                               rtol=0)
    T = 33
    C = TL.moe_capacity(T, ts)
    assert (C < T * js.top_k / js.num_experts) == (capacity_factor < 1)
    jlog = np.asarray(xj.reshape(T, -1).astype(jnp.float32) @ jm["router"])
    tlog = (xt.reshape(T, -1).float() @ tm["router"]).numpy()
    clear = _gap(jlog, js.top_k) > NEAR_TIE[torch.float32]
    assert clear.all()
    np.testing.assert_array_equal(
        TL.top_k(torch.from_numpy(tlog), js.top_k)[1].numpy()[clear],
        _routing(jlog, js.top_k)[clear])


def _tied_block(E: int, D: int, F: int, dtype, seed: int, zeros=False):
    """An integer router whose columns repeat (every expert e >= E/2
    routes as expert e - E/2), random experts, and an integer input: the
    logits are exact in both frameworks and tie in pairs. ``zeros``: the
    router's first half is zero instead (+0.0 and -0.0 columns), so every
    token ties at zero between those experts."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-1, 2, (D, E // 2)).astype(np.float32)
    if zeros:
        half[:] = 0.0
        half[:, ::2] = -0.0
    router = np.concatenate([half, half], axis=1)
    x = rng.integers(-2, 3, (2, 9, D)).astype(np.float32)
    if zeros:
        x = -np.abs(x) - 1.0          # products of -0.0 and +0.0 columns
    w = {name: (rng.standard_normal((E, a, b)) / np.sqrt(a)).astype(
        np.float32) for name, a, b in (("w_gate", D, F), ("w_up", D, F),
                                        ("w_down", F, D))}
    jm = {"router": jnp.asarray(router),
          **{k: jnp.asarray(v).astype(JDT[dtype]) for k, v in w.items()}}
    tm = {"router": torch.from_numpy(router),
          **{k: torch.from_numpy(v).to(dtype) for k, v in w.items()}}
    return jm, tm, x


@pytest.mark.parametrize("zeros", [False, True], ids=["pairs", "signed_zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", [(4, 2), (8, 4)], ids=["mixtral", "kimi"])
def test_moe_apply_on_exact_ties_matches_the_reference(spec, dtype, zeros):
    """Gate logits that tie exactly (duplicated router columns; or zero
    columns, signed and not, under negative inputs): the expert choice
    equals ``lax.top_k``'s on the same logits bit for bit, and the outputs
    agree. The tied experts have different weights, so picking the
    other one of a pair would move the output by ~1."""
    E, K = spec
    jm, tm, x = _tied_block(E, 32, 16, dtype, seed=E + K, zeros=zeros)
    js, ts = JL.MoESpec(E, K), TL.MoESpec(E, K)
    xj, xt = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(dtype)
    jlog = np.asarray(xj.reshape(18, -1).astype(jnp.float32) @ jm["router"])
    tlog = (xt.reshape(18, -1).float() @ tm["router"]).numpy()
    np.testing.assert_array_equal(tlog.view(np.int32), jlog.view(np.int32))
    ties = np.sum(jlog[:, :, None] == jlog[:, None, :]) - jlog.size
    assert ties >= jlog.shape[0] * E      # every expert ties with its twin
    np.testing.assert_array_equal(
        TL.top_k(torch.from_numpy(tlog), K)[1].numpy(), _routing(jlog, K))
    want = JL.moe_apply(jm, xj, js)
    got = TL.moe_apply(tm, xt, ts)
    np.testing.assert_allclose(_n(got), _n(want), atol=MOE_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_the_reference(arch_params, arch, dtype):
    jm, tm, spec = _layer0(arch_params, arch, dtype)
    x = np.random.default_rng(3).standard_normal(
        (2, 13, jm["router"].shape[0])).astype(np.float32)
    want = JL.moe_aux_loss(jm, jnp.asarray(x).astype(JDT[dtype]), spec)
    got = TL.moe_aux_loss(tm, torch.from_numpy(x).to(dtype),
                          TL.MoESpec(spec.num_experts, spec.top_k))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_does_not_depend_on_the_slot_order(arch_params, arch):
    """``moe_combine`` on the same slots handed over in every cyclic
    order of the K columns gives one output bit for bit; ``moe_apply``'s
    output is each token's K contributions added from 0 in ascending
    expert id (the reference's scatter-add order), computed by hand."""
    _, tm, spec = _layer0(arch_params, arch, torch.float32)
    E, K = spec.num_experts, spec.top_k
    ts = TL.MoESpec(E, K, 4.0)                   # nothing dropped
    rng = np.random.default_rng(5)
    T, D = 14, tm["router"].shape[0]
    eout = torch.from_numpy(rng.standard_normal((E * 8, D)).astype(
        np.float32))
    idx = torch.from_numpy(np.argsort(rng.random((T, E)), axis=1)[:, :K])
    dest = idx * 8 + torch.from_numpy(rng.integers(0, 8, (T, K)))
    keep = torch.from_numpy(rng.random((T, K)) < 0.8)
    gates = torch.softmax(torch.from_numpy(rng.standard_normal(
        (T, K)).astype(np.float32)), -1)
    want = TL.moe_combine(eout, dest, keep, gates, idx)
    for r in range(1, K):
        perm = [(j + r) % K for j in range(K)]
        got = TL.moe_combine(eout, dest[:, perm], keep[:, perm],
                             gates[:, perm], idx[:, perm])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # moe_apply by hand: per token, ascending expert id
    x = torch.from_numpy(rng.standard_normal((2, 7, D)).astype(np.float32))
    xt = x.reshape(T, D)
    vals, idx = TL.top_k(xt @ tm["router"], K)
    gates = torch.softmax(vals, -1)
    rows = []
    for t in range(T):
        acc = torch.zeros(D)
        for j in torch.argsort(idx[t]).tolist():
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xt[t] @ tm["w_gate"][e]) * (
                xt[t] @ tm["w_up"][e])
            acc = acc + (h @ tm["w_down"][e]) * gates[t, j]
        rows.append(acc)
    np.testing.assert_allclose(TL.moe_apply(tm, x, ts).reshape(T, D).numpy(),
                               torch.stack(rows).numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

B_FWD, S_FWD = 2, 16


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _port_gaps(tp, tcfg, tokens, monkeypatch) -> np.ndarray:
    """The port's forward once more with its router logits recorded: the
    K-th gap of every token in every layer, (L, B, S)."""
    gaps = []
    real = TL.top_k

    def spy(v, k):
        gaps.append(_gap(v.float().numpy(), k))
        return real(v, k)
    monkeypatch.setattr(TL, "top_k", spy)
    TT.forward(tp, tcfg, torch.from_numpy(tokens))
    monkeypatch.undo()
    B, S = tokens.shape
    return np.stack(gaps[::2]).reshape(-1, B, S)   # apply, then aux loss


def _settled(gaps: np.ndarray, eps: float) -> np.ndarray:
    """(B, S) bool: the positions of each row before its first near tie
    in any layer (attention carries a flipped token's change to every
    later position of its row)."""
    near = (gaps < eps).any(axis=0)
    first = np.where(near.any(axis=1), near.argmax(axis=1), near.shape[1])
    return np.arange(near.shape[1])[None, :] < first[:, None]


@pytest.mark.parametrize("dtype,use_kernel", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_the_reference(arch_params, arch, dtype,
                                                    use_kernel, monkeypatch):
    """Logits at the positions before each row's first near tie (at
    least half of them), and ``aux``, the mean of the layers' aux losses
    (f32 relative 1e-6; bf16 1e-2: a near tie moves one token's count).
    With ``use_kernel`` the reference runs its Pallas kernel, which keeps
    P in f32 where the port's plain attention on the CPU rounds it to bf16
    (``tests/test_torch_models.py``): in bf16 that moves the hidden state
    by bf16 ulps and flips routings at gaps of 1e-2 and more, on most
    positions of these rows, so the kernel case is held in f32."""
    jcfg, jp, tapi, tp = _pair(arch_params, arch, dtype)
    toks = _tokens(B_FWD, S_FWD, seed=11)
    want, jaux = JT.forward(jp, jcfg, jnp.asarray(toks),
                            use_kernel=use_kernel)
    got, aux = TT.forward(tp, tapi.cfg, torch.from_numpy(toks),
                          use_kernel=use_kernel)
    assert got.dtype == dtype and got.shape == (B_FWD, S_FWD, jcfg.vocab)
    keep = _settled(_port_gaps(tp, tapi.cfg, toks, monkeypatch),
                    NEAR_TIE[dtype])
    assert keep.sum() >= keep.size // 2, keep
    np.testing.assert_allclose(_n(got)[keep], _n(want)[keep],
                               atol=FWD_TOL[dtype], rtol=0)
    assert aux.dtype == torch.float32
    rel = {torch.float32: 1e-6, torch.bfloat16: 1e-2}[dtype]
    assert abs(aux.item() - float(jaux)) <= rel * float(jaux)
    assert float(jaux) > 1.0 - 1e-6          # E * sum(f p) >= 1-ish


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_the_reference(arch_params, arch, monkeypatch):
    """f32: the loss (cross-entropy plus 0.01 aux) and its parts; no near
    tie in the port's routing at this seed (a flip would move the mean)."""
    jcfg, jp, tapi, tp = _pair(arch_params, arch, torch.float32)
    toks = _tokens(B_FWD, S_FWD + 1, seed=12)
    labels = toks[:, 1:].copy()
    labels[:, 3] = -1
    toks = toks[:, :S_FWD]
    assert (_port_gaps(tp, tapi.cfg, toks, monkeypatch)
            >= NEAR_TIE[torch.float32]).all()
    want, jm = JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    got, m = TT.loss_fn(tp, tapi.cfg, tb)
    for g, w in ((got, want), (m["ce"], jm["ce"]), (m["aux"], jm["aux"])):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    assert got.item() == (m["ce"] + 0.01 * m["aux"]).item()
    reg, _ = tapi.loss_fn(tp, tb)
    assert reg.item() == got.item()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_match_the_reference_float32(arch_params, arch):
    """Eight ``decode_step``s at B=3 (capacity 8: nothing dropped) on a
    cache of 16 — mixtral's smoke window — within the dense configs' f32
    tolerance."""
    jcfg, jp, tapi, tp = _pair(arch_params, arch, torch.float32)
    japi = R._lm_api(arch, jcfg)
    jstep = jax.jit(japi.decode_step)
    B = 3
    jc, tc = japi.init_cache(B, 16), tapi.init_cache(B, 16)
    rng = np.random.default_rng(5)
    worst = 0.0
    for t in range(8):
        toks = rng.integers(0, jcfg.vocab, B).astype(np.int32)
        pos = np.full((B,), t, np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = tapi.decode_step(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
        worst = max(worst, float(np.max(np.abs(_n(jl) - _n(tl)))))
    assert worst <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_trajectories_equal_float32(arch_params, arch):
    """Prompts of 6 decoded 20 tokens with a cache of 32 (mixtral's ring
    of 16 wraps)."""
    jcfg, jp, tapi, tp = _pair(arch_params, arch, torch.float32)
    japi = R._lm_api(arch, jcfg)
    prompts = _tokens(4, 6, seed=6, vocab=jcfg.vocab)
    want = np.asarray(jax_reference_decode(japi, jp, jnp.asarray(prompts),
                                           20, cache_len=32))
    got = reference_decode(tapi, tp, prompts, 20, cache_len=32).numpy()
    np.testing.assert_array_equal(got, want)


def _stepwise(tp, cfg, toks, cache_len):
    B, S = toks.shape
    cache = TT.init_cache(cfg, B, cache_len)
    outs = []
    for t in range(S):
        lg, cache = TT.decode_step(tp, cfg, cache, toks[:, t],
                                   torch.full((B,), t, dtype=torch.int32))
        outs.append(lg)
    return torch.stack(outs, 1), cache


def test_stepwise_decode_equals_the_forward_with_headroom():
    """``tests/test_models.py``'s MoE case on the port: mixtral's smoke
    config with capacity factor 4 (the forward drops nothing), 12 decode
    steps against the forward in bf16 at its atol 1e-2."""
    cfg = dataclasses.replace(
        TR.build("mixtral-8x7b", smoke=True, device="cpu").cfg,
        moe=TL.MoESpec(num_experts=4, top_k=2, capacity_factor=4.0))
    tp = TT.init(torch.Generator().manual_seed(9), cfg)
    toks = torch.from_numpy(_tokens(2, 12, seed=10))
    full, _ = TT.forward(tp, cfg, toks)
    dec, _ = _stepwise(tp, cfg, toks, 12)
    torch.testing.assert_close(dec.float(), full.float(), atol=1e-2,
                               rtol=0)


def test_sliding_window_ring_eviction():
    """``tests/test_models.py``'s ring-eviction case on the port: B=1,
    S=24 past mixtral's smoke window of 16, the cache 16 wide, decode
    against the forward at its atol = rtol = 2e-2."""
    cfg = dataclasses.replace(
        TR.build("mixtral-8x7b", smoke=True, device="cpu").cfg,
        moe=TL.MoESpec(num_experts=4, top_k=2, capacity_factor=4.0))
    tp = TT.init(torch.Generator().manual_seed(16), cfg)
    toks = torch.from_numpy(_tokens(1, 24, seed=17))
    full, _ = TT.forward(tp, cfg, toks)
    dec, cache = _stepwise(tp, cfg, toks, 24)
    assert cache["k"].shape[2] == 16
    torch.testing.assert_close(dec.float(), full.float(), atol=2e-2,
                               rtol=2e-2)
    # without the window the first 16 positions agree and the rest do not
    wide = dataclasses.replace(cfg, window=None)
    unwindowed, _ = TT.forward(tp, wide, toks)
    torch.testing.assert_close(unwindowed[:, :16], full[:, :16])
    assert (unwindowed[:, 16:].float() - full[:, 16:].float()).abs().max() \
        > 2e-2


# ---------------------------------------------------------------------------
# configs, counts, init, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,billions,active", [
    ("mixtral-8x7b", 46.7, None), ("kimi-k2-1t-a32b", 1041.0, 31.0)])
def test_full_config_counts_equal_the_reference(arch, billions, active):
    """Every field of FULL and SMOKE equals the reference's; the
    parameter counts equal the reference's and its published sizes
    (``tests/test_models.py``)."""
    for smoke in (False, True):
        cfg = TR.build(arch, smoke=smoke, device="cpu").cfg
        jcfg = R.build(arch, smoke=smoke).cfg
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab", "head_dim", "qkv_bias", "window",
                  "rope_theta", "prefix_len", "embed_scale",
                  "tie_embeddings"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert dataclasses.astuple(cfg.moe) == dataclasses.astuple(jcfg.moe)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    tapi, japi = TR.build(arch, device="cpu"), R.build(arch)
    assert tapi.param_count == japi.param_count
    assert tapi.active_param_count == japi.active_param_count
    assert tapi.param_count / 1e9 == pytest.approx(billions, rel=0.1)
    if active is not None:
        assert tapi.active_param_count / 1e9 == pytest.approx(active,
                                                              rel=0.1)
    assert tapi.active_param_count < tapi.param_count
    assert TR.FAMILY[arch] == R.FAMILY[arch] == "moe"
    assert tapi.cache_kind == "ring"


def test_dense_active_param_count_is_the_param_count():
    for arch in ("smollm-135m", "qwen2.5-14b", "paligemma-3b"):
        tapi = TR.build(arch, device="cpu")
        assert tapi.active_param_count == tapi.param_count == \
            R.build(arch).active_param_count


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_layout_matches_reference(arch_params, arch):
    """Own init: the reference's tree and shapes, bf16 but for the f32
    router; ``params_from_jax`` keeps the router f32 in a bf16 config."""
    api, params = arch_params[arch]
    tapi = TR.build(arch, smoke=True, device="cpu")
    own = tapi.init(torch.Generator().manual_seed(0))

    def shapes(tree, leaf):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf) for k, v in tree.items()}
        return leaf(tree)

    assert shapes(own, lambda t: tuple(t.shape)) == shapes(
        params, lambda a: tuple(a.shape))
    moe = own["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_up", "w_down"))
    conv = TT.params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params), tapi.cfg)
    assert conv["layers"]["moe"]["router"].dtype == torch.float32
    assert conv["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert conv["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        conv["layers"]["moe"]["router"].numpy(),
        np.asarray(params["layers"]["moe"]["router"]))


def test_own_init_is_seeded_and_scaled():
    """The expert stacks, drawn one matrix at a time, are seeded and
    N(0, 1/fan_in) like every dense projection."""
    tapi = TR.build("kimi-k2-1t-a32b", smoke=True, device="cpu")
    a = tapi.init(torch.Generator().manual_seed(3))
    b = tapi.init(torch.Generator().manual_seed(3))
    c = tapi.init(torch.Generator().manual_seed(4))
    for k in ("router", "w_gate", "w_down"):
        assert torch.equal(a["layers"]["moe"][k], b["layers"]["moe"][k])
        assert not torch.equal(a["layers"]["moe"][k], c["layers"]["moe"][k])
    wd = a["layers"]["moe"]["w_down"].float()        # (L, E, F, D)
    assert not torch.equal(wd[0, 0], wd[0, 1])
    assert wd.std().item() == pytest.approx(32 ** -0.5, rel=0.1)
