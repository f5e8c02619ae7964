"""One training step of each of the ten archs in the port against the
JAX package: ``make_grads_step`` and ``make_train_step`` on the SMOKE
config in f32, on the reference's own weights (``params_from_jax``) and
the same numpy batch. Loss within 1e-5 relative; each gradient leaf
within 1e-4 of its largest magnitude, floored at 1e-4 of the tree's
largest (f32 sums in another order through a backward; a leaf whose
gradient is zero in exact arithmetic, whisper's key bias, which softmax
cannot see, holds rounding noise alone); the step's grad norm within
1e-4 relative and its lr within 1e-6. The MoE archs first show that both
packages route every token of every layer to the same experts, since a
flipped routing moves the loss by the gap between two experts. Also:
the default ``grad_dtype`` casts to bf16 and leaves the caller's tree
alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as configs_lib  # noqa: E402
from repro.launch.steps import make_grads_step as jmake_grads  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ALL_ARCHS = list(configs_lib.ARCH_IDS)
CONVERT = {"dense": TT, "vlm": TT, "moe": TT, "ssm": TW, "hybrid": TH,
           "audio": TE}
APIS = {"dense": "_lm_api", "vlm": "_lm_api", "moe": "_lm_api",
        "ssm": "_rwkv_api", "hybrid": "_hybrid_api", "audio": "_encdec_api"}
B, S = 2, 16


def _f32_pair(arch):
    """(jax api, jax params, port api, port params), both in f32, the
    port's converted from the reference's own init."""
    api = R.build(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    jcfg = dataclasses.replace(api.cfg, dtype=jnp.float32)
    japi = getattr(R, APIS[api.family])(arch, jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True, device="cpu").cfg,
                               dtype=torch.float32)
    tapi = getattr(TR, APIS[api.family])(arch, tcfg, "cpu")
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return japi, jp, tapi, CONVERT[api.family].params_from_jax(npt, tcfg)


def _batch(api, seed=3):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, api.cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, api.cfg.vocab, (B, S)).astype(np.int32)}
    if api.family == "audio":
        b["frames"] = (0.1 * rng.standard_normal(
            (B, S, api.cfg.d_model))).astype(np.float32)
    if api.family == "vlm":
        b["prefix_embeds"] = (0.1 * rng.standard_normal(
            (B, api.cfg.prefix_len, api.cfg.d_model))).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _routings(japi, jp, jb, tapi, tp, tb, monkeypatch):
    """Every top-k expert choice of one forward of each package's loss,
    in call order (each layer's dispatch, then its aux loss); the
    reference's evaluated op by op (``jax.disable_jit``: its layer scan
    then runs as a loop, so the choices are concrete)."""
    jidx, tidx = [], []
    jreal, treal = jax.lax.top_k, TL.top_k

    def jspy(x, k):
        out = jreal(x, k)
        jidx.append(np.asarray(out[1]))
        return out

    def tspy(x, k):
        out = treal(x, k)
        tidx.append(out[1].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", jspy)
    monkeypatch.setattr(TL, "top_k", tspy)
    with jax.disable_jit():
        japi.loss_fn(jp, jb)
    with torch.no_grad():
        tapi.loss_fn(tp, tb)
    monkeypatch.undo()
    return jidx, tidx


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_equals_reference_float32(arch, monkeypatch):
    japi, jp, tapi, tp = _f32_pair(arch)
    jb, tb = _batch(japi)
    if japi.family == "moe":
        jidx, tidx = _routings(japi, jp, jb, tapi, tp, tb, monkeypatch)
        assert len(jidx) == len(tidx) == 2 * japi.cfg.num_layers
        for a, b in zip(jidx, tidx):
            np.testing.assert_array_equal(b, a)
    jopt = JAdamW(grad_dtype=jnp.float32)
    topt = AdamWConfig(grad_dtype=torch.float32)
    jgrads, jm = jax.jit(jmake_grads(japi, jopt))(jp, jb)
    tgrads, tm = TS.make_grads_step(tapi, topt)(tp, tb)
    want_loss = float(jm["loss"])
    assert abs(float(tm["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    jl, tl = jax.tree.leaves(jgrads), list(TL.tree_leaves(tgrads))
    assert len(jl) == len(tl)
    # a leaf's scale is floored at 1e-4 of the tree's largest gradient: a
    # leaf whose gradient is zero in exact arithmetic (whisper's key
    # bias, which softmax cannot see) holds rounding noise alone
    top = max(float(np.abs(np.asarray(a)).max()) for a in jl)
    for a, b in zip(jl, tl):
        a = np.asarray(a, np.float32)
        assert b.dtype == torch.float32 and b.shape == a.shape
        scale = max(float(np.abs(a).max()), 1e-4 * top)
        assert np.abs(b.numpy() - a).max() <= 1e-4 * scale
    # the whole step: the same loss, grad norm and lr; params move
    jp2, _, jmet = jax.jit(jmake_train(japi, jopt))(jp, jadamw_init(jp), jb)
    tp2, ts2, tmet = TS.make_train_step(tapi, topt)(tp, adamw_init(tp), tb)
    assert abs(float(tmet["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(ts2["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(
        TL.tree_leaves(tp), TL.tree_leaves(tp2)))


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_train_step_casts_grads_to_bf16_by_default(arch):
    api = TR.build(arch, smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    _, tb = _batch(api)
    grads, metrics = TS.make_grads_step(api)(params, tb)
    assert all(g.dtype == torch.bfloat16 for g in TL.tree_leaves(grads))
    assert metrics["loss"].requires_grad is False
    # the caller's tree is not changed, nor made to require grad
    assert not any(p.requires_grad for p in TL.tree_leaves(params))




def test_bmm_f32_backward_equals_jax_grad():
    """``layers._BmmF32``'s backward (the card's expert products under
    autograd) against ``jax.grad`` of the reference's
    ``preferred_element_type=f32`` einsum, bit for bit: both take the two
    products in f32 and round them to bf16. Its forward needs the card
    (``torch.bmm`` with ``out_dtype``); the backward is called directly."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 8, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16, 5)).astype(np.float32)
    g = rng.standard_normal((3, 8, 5)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jax.grad(lambda x, y: jnp.sum(jnp.einsum(
        "ecd,edf->ecf", x, y, preferred_element_type=jnp.float32)
        * jnp.asarray(g)), argnums=(0, 1))(ja, jb)

    class Ctx:
        saved_tensors = (torch.from_numpy(a).to(torch.bfloat16),
                         torch.from_numpy(b).to(torch.bfloat16))

    got = TL._BmmF32.backward(Ctx(), torch.from_numpy(g))
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))
