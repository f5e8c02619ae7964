"""``models/runconfig.py`` against the JAX package's: ``constrain`` is the
identity outside a shard env; inside one it resolves the reference's
PartitionSpec (the largest dividing prefix of the batch axes, a ``tp``
dim smaller than the axis replicated) and, on a DTensor over a (2, 2)
fake mesh, gives that spec as placements; ``scan`` is ``lax.scan``'s
loop; and remat changes no loss and no gradient: for one arch of every
family on its SMOKE config in f32, the port's loss and gradients with
remat on equal those with it off exactly (the recomputed layer runs the
same CPU kernels on the same inputs), and the loss equals the
reference's under ``runconfig.options(remat=True)`` within 1e-5
relative (``tests/test_torch_train_steps.py``'s tolerance)."""

import dataclasses
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch.mesh import abstract_mesh as jabstract  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import runconfig as jrc  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh as tabstract  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import runconfig as trc  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402

CONVERT = {"dense": TT, "vlm": TT, "moe": TT, "ssm": TW, "hybrid": TH,
           "audio": TE}
APIS = {"dense": "_lm_api", "vlm": "_lm_api", "moe": "_lm_api",
        "ssm": "_rwkv_api", "hybrid": "_hybrid_api", "audio": "_encdec_api"}
FAMILY_ARCHS = ["smollm-135m", "paligemma-3b", "mixtral-8x7b", "rwkv6-7b",
                "zamba2-7b", "whisper-base"]
B, S = 2, 16

AXES = [("dp", None, None), ("dp", None, "tp"), ("dp", None, "tp", None),
        ("tp", "dp", None), (None, "dp", "tp"), ("dpt", None), ("dp", "tp")]
SHAPES = [(32, 8, 24, 128), (256, 4, 8, 64), (6, 3, 40, 16), (1, 5, 16, 16),
          (512, 2, 4, 8)]
ENVS = [((16, 16), ("data", "model"), ("data",), "model"),
        ((16, 16), ("data", "model"), ("data", "model"), None),
        ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"), "model"),
        ((2, 2), ("data", "model"), ("data",), "model")]


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _norm(spec) -> tuple:
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


def _reference_spec(axes, shape, env):
    mesh_shape, names, dp, tp = env
    mesh = jabstract(mesh_shape, names)
    x = jax.ShapeDtypeStruct(shape[:len(axes)], jnp.bfloat16)
    with unittest.mock.patch.object(jrc.jax.lax, "with_sharding_constraint",
                                    lambda x, s: s.spec), \
            jrc.options(shard_env=(mesh, dp, tp)):
        return jrc.constrain(x, axes)


def test_constrain_is_the_identity_outside_a_shard_env():
    x = torch.ones(4, 4)
    assert trc.constrain(x, ("dp", None)) is x
    assert trc.tp_size() is None and trc.shard_env() is None
    # a plain tensor inside an env is also left alone
    env = (tabstract((2, 2), ("data", "model")), ("data",), "model")
    with trc.options(shard_env=env):
        assert trc.constrain(x, ("dp", "tp")) is x
        assert trc.tp_size() == 2
    assert trc.shard_env() is None


@pytest.mark.parametrize("env", ENVS, ids=lambda e: "x".join(map(str, e[0]))
                         + ("-tp" if e[3] else "-dp"))
def test_resolve_equals_reference(env):
    mesh_shape, names, dp, tp = env
    mesh = tabstract(mesh_shape, names)
    for axes in AXES:
        for shape in SHAPES:
            want = _norm(_reference_spec(axes, shape, env))
            got = _norm(trc.resolve(axes, shape[:len(axes)], mesh, dp, tp))
            assert got == want, (axes, shape)


def test_constrain_on_a_fake_mesh_gives_the_reference_placements():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import device_mesh

    env = ENVS[3]
    mesh = device_mesh(env[0], env[1])
    with FakeTensorMode():
        for axes in AXES:
            for shape in SHAPES:
                x = distribute_tensor(torch.empty(shape[:len(axes)]), mesh,
                                      [Replicate(), Replicate()])
                with trc.options(shard_env=(mesh, env[2], env[3])):
                    y = trc.constrain(x, axes)
                want = trc.placements(_reference_spec(axes, shape, env),
                                      mesh)
                assert list(y.placements) == want, (axes, shape)
                assert tuple(y.shape) == tuple(x.shape)


def test_scan_is_lax_scan():
    xs = {"a": torch.arange(12.0).reshape(3, 4), "i": range(3)}

    def body(c, x):
        return c + x["a"] * x["i"], (x["a"].sum(), None)

    carry, (sums, none) = trc.scan(body, torch.zeros(4), xs)
    assert torch.equal(carry, (xs["a"] * torch.arange(3.0)[:, None]).sum(0))
    assert torch.equal(sums, xs["a"].sum(1))
    assert none is None
    assert trc.scan(lambda c, x: (c, None), 0, xs)[1] is None


def _f32_pair(arch):
    api = JR.build(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    jcfg = dataclasses.replace(api.cfg, dtype=jnp.float32)
    japi = getattr(JR, APIS[api.family])(arch, jcfg)
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


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_changes_no_loss_or_gradient(arch):
    japi, jp, tapi, tp = _f32_pair(arch)
    jb, tb = _batch(japi)
    out = {}
    for remat in (False, True):
        with trc.options(remat=remat):
            loss, _m, grads = TS.value_and_grad(tapi.loss_fn, tp, tb,
                                                torch.float32)
        out[remat] = (loss, list(tree_leaves(grads)))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    with jrc.options(remat=True):
        (jloss, _), _ = jax.value_and_grad(japi.loss_fn, has_aux=True)(
            jp, jb)
    want = float(jloss)
    assert abs(float(out[True][0]) - want) <= 1e-5 * abs(want)


def test_remat_recomputes_each_layer_once_in_the_backward():
    """With remat on, the backward reruns every layer's forward: the
    ``wkv6`` op is called 2 x layers times in a loss-and-gradient step of
    rwkv6 (fake tensors, so the op, not the plain loop, runs), layers
    without; ``wkv6_backward`` layers times either way."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    tapi = TR.build("rwkv6-7b", smoke=True, device="cpu")
    L = tapi.cfg.num_layers
    counts = {}
    for remat in (False, True):
        with FakeTensorMode() as mode:
            params = TR.fake_like(TR.param_shapes(tapi), mode)
            batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32),
                     "labels": torch.zeros((2, 32), dtype=torch.int32)}
            with FlopCounterMode(display=False) as fc, \
                    trc.options(remat=remat):
                TS.value_and_grad(tapi.loss_fn, params, batch,
                                  torch.float32)
        by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
        counts[remat] = by_op
    from repro_torch.kernels import ops
    H, hs = tapi.cfg.num_heads, tapi.cfg.head_size
    one = ops.wkv6_flops(2, 32, H, hs)
    back = ops.wkv6_backward_flops(2, 32, H, hs)
    assert counts[False]["repro_torch.wkv6"] == L * one
    assert counts[True]["repro_torch.wkv6"] == 2 * L * one
    assert counts[False]["repro_torch.wkv6_backward"] == L * back
    assert counts[True]["repro_torch.wkv6_backward"] == L * back
