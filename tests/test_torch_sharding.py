"""The port's sharding rules and shape cells against the JAX package's, on
abstract meshes (no devices, no process group): ``param_specs`` and its
unmatched list for every arch on the pod (16 x 16) and multi-pod
(2 x 16 x 16) meshes, ``cache_specs`` / ``decode_input_specs`` for every
decode cell of ``cells()``, ``batch_specs`` and ``parallelism`` for every
cell, and the registry's ``SHAPES``, ``cells``, ``runnable``,
``skip_reason`` and ``input_specs`` shapes and dtypes for every runnable
cell. Specs compare entry for entry (a one-axis tuple and the bare axis
name are the same sharding). Then ``placements``: a spec as DTensor
placements on a ``DeviceMesh``, a dim over two axes in mesh order."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as configs_lib  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch.mesh import abstract_mesh as jabstract  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh as tabstract  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402

ARCHS = list(configs_lib.ARCH_IDS)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _norm(part):
    if isinstance(part, tuple) and len(part) == 1:
        return part[0]
    return part


def _spec(s) -> tuple:
    return tuple(_norm(p) for p in s)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _same_specs(got, want):
    g = [_spec(s) for s in tree_leaves(got)]
    w = [_spec(s) for s in _jleaves(want)]
    assert g == w


def _jshapes(api):
    return jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    jm, tm = jabstract(*MESHES[mesh]), tabstract(*MESHES[mesh])
    japi, tapi = JR.build(arch), TR.build(arch, device="cpu")
    jspecs, junm = jsh.param_specs(japi, _jshapes(japi), jm)
    tspecs, tunm = tsh.param_specs(tapi, TR.param_shapes(tapi), tm)
    assert tunm == junm
    _same_specs(tspecs, jspecs)
    assert tsh.parallelism(tapi, tm) == jsh.parallelism(japi, jm)


def test_param_shapes_equal_reference():
    """The shapes-only init gives the reference's tree, leaf for leaf (the
    port's rwkv6 ``ln_in`` included), in well under a second for kimi-k2."""
    import time
    for arch in ARCHS:
        japi, tapi = JR.build(arch), TR.build(arch, device="cpu")
        t0 = time.monotonic()
        got = TR.param_shapes(tapi)
        if arch == "kimi-k2-1t-a32b":
            assert time.monotonic() - t0 < 10
        want = _jshapes(japi)
        assert [tuple(s.shape) for s in tree_leaves(got)] == \
            [tuple(s.shape) for s in jax.tree.leaves(want)]


def test_shape_cells_equal_reference():
    assert {k: tuple(v) for k, v in TR.SHAPES.items()} == \
        {k: tuple(v) for k, v in JR.SHAPES.items()}
    assert TR.LONG_CONTEXT_OK == JR.LONG_CONTEXT_OK
    assert TR.cells() == JR.cells()
    assert len(TR.cells()) == 33
    for arch in ARCHS:
        for shape in TR.SHAPES:
            assert TR.runnable(arch, shape) == JR.runnable(arch, shape)
            assert TR.skip_reason(arch, shape) == JR.skip_reason(arch,
                                                                 shape)


def _leaves_meta(tree, jax_side: bool):
    leaves = jax.tree.leaves(tree) if jax_side else list(tree_leaves(tree))
    if jax_side:
        return [(tuple(x.shape), DTYPES[str(x.dtype)]) for x in leaves]
    return [(tuple(x.shape), x.dtype) for x in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_batch_cache_specs_equal_reference(arch):
    """For every runnable cell of the arch: the inputs' shapes and dtypes
    (fake tensors, the decode cache from ``init_cache`` under fake mode),
    and on both meshes the batch specs (train, prefill) or the decode
    input specs (the cache's, with the sequence-parallel fallback)."""
    from torch._subclasses.fake_tensor import is_fake

    japi, tapi = JR.build(arch), TR.build(arch, device="cpu")
    for a, shape in JR.cells():
        if a != arch:
            continue
        jin = JR.input_specs(japi, shape)
        tin = TR.input_specs(tapi, shape)
        assert all(is_fake(t) for t in tree_leaves(tin))
        assert sorted(tin) == sorted(jin)
        for k in jin:
            jt = jin[k] if isinstance(jin[k], dict) else {"_": jin[k]}
            tt = tin[k] if isinstance(tin[k], dict) else {"_": tin[k]}
            assert _leaves_meta(tt, False) == _leaves_meta(jt, True), k
        for mesh in MESHES:
            jm, tm = jabstract(*MESHES[mesh]), tabstract(*MESHES[mesh])
            if JR.SHAPES[shape].kind == "decode":
                jd = jsh.decode_input_specs(jin, japi, jm)
                td = tsh.decode_input_specs(tin, tapi, tm)
                _same_specs(td["cache"], jd["cache"])
                assert _spec(td["tokens"]) == _spec(jd["tokens"])
                assert _spec(td["pos"]) == _spec(jd["pos"])
            else:
                _same_specs(tsh.batch_specs(tin, tm, tapi),
                            jsh.batch_specs(jin, jm, japi))
                _same_specs(tsh.batch_specs(tin, tm),
                            jsh.batch_specs(jin, jm))


def test_gqa_cache_falls_back_to_sequence_parallel():
    """qwen2.5-14b's 8 kv heads do not divide the 16-wide model axis: its
    K/V rings shard the ring axis over ``model`` instead, as the
    reference's."""
    tapi = TR.build("qwen2.5-14b", device="cpu")
    tin = TR.input_specs(tapi, "decode_32k")
    specs = tsh.cache_specs(tapi, tin["cache"], tabstract(*MESHES["pod"]))
    assert _spec(specs["k"]) == (None, "data", "model", None, None)
    assert _spec(specs["pos"]) == (None, "data", None)


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import device_mesh

    mesh = device_mesh((2, 2, 2), ("pod", "data", "model"))
    got = tsh.placements(tsh.P(("pod", "data"), "model"), mesh)
    assert got == [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements(tsh.P(None, ("data",)), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(tsh.P(("data", "pod")), mesh)
    # named(): a spec tree as a placements tree
    tree = tsh.named({"a": tsh.P("data"), "b": {"c": tsh.P()}}, mesh)
    assert tree == {"a": [Replicate(), Shard(0), Replicate()],
                    "b": {"c": [Replicate()] * 3}}


def test_abstract_mesh_and_axis_helpers():
    from repro_torch.launch import mesh as M
    m = M.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.axis_names == ("pod", "data", "model")
    assert M.data_axes(m) == ("pod", "data")
    assert M.axis_size(m, ("pod", "data")) == 32
    assert np.prod(list(m.shape.values())) == 512


def test_production_meshes_share_one_fake_group():
    """``--mesh both``: the pod mesh is a sub-mesh over the first 256
    ranks of the one fake group of 512 that the two-pod mesh spans; a
    (2, 2) mesh over its first 4 ranks coexists with both."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M

    pod = M.make_production_mesh(multi_pod=False)
    multi = M.make_production_mesh(multi_pod=True)
    small = M.device_mesh((2, 2), ("data", "model"))
    assert dist.get_backend() == "fake" and dist.get_world_size() == 512
    assert M.mesh_shape(pod) == {"data": 16, "model": 16}
    assert M.mesh_shape(multi) == {"pod": 2, "data": 16, "model": 16}
    assert M.mesh_shape(small) == {"data": 2, "model": 2}
    assert pod.size() == 256 and multi.size() == 512
    assert list(pod.get_coordinate()) == [0, 0]
    assert list(multi.get_coordinate()) == [0, 0, 0]
    with pytest.raises(RuntimeError, match="fake group of at least"):
        M.fake_world(1024)
