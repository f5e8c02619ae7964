"""Port's kernels on the CPU (the duplex stream and ``l2_distance``): the
plain PyTorch versions against the JAX package's Pallas kernels
(interpret mode on the CPU) on the shapes of ``tests/test_kernels.py``,
with its tolerances, and the wrapper contract (CUDA tensors only, nothing
built at import, one library per source)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import duplex_stream as ds  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import vector_distance as vd  # noqa: E402

SHAPES = [(4, 64, 128), (2, 32, 256), (1, 16, 64)]


def _inputs(N, T, D, seed):
    """The same streams for both packages: page-in blocks quantized by
    the JAX reference, bf16 page-out blocks (f32 -> bf16 rounds to
    nearest even in both frameworks)."""
    rng = np.random.default_rng(seed)
    in_x = rng.standard_normal((N, T, D)).astype(np.float32)
    out_x = rng.standard_normal((N, T, D)).astype(np.float32)
    jq, js = jref.quantize_int8(jnp.asarray(in_x))
    j = (jq, js, jnp.asarray(out_x).astype(jnp.bfloat16))
    t = (torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)),
         torch.from_numpy(out_x).to(torch.bfloat16))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want):
    """tests/test_kernels.py:135-141: dequantized rows exact, scales
    within rtol 1e-6, int8 codes within 1 LSB (exact rounding ties)."""
    deq, q, scale = got
    wdeq, wq, wscale = want
    np.testing.assert_array_equal(_f32(deq), _f32(wdeq))
    np.testing.assert_allclose(_f32(scale), _f32(wscale), rtol=1e-6)
    assert int(np.max(np.abs(q.numpy().astype(np.int32)
                             - np.asarray(wq, np.int32)))) <= 1


@pytest.mark.parametrize("N,T,D", SHAPES)
@pytest.mark.parametrize("fused", [True, False])
def test_duplex_stream_vs_jax(N, T, D, fused):
    j, t = _inputs(N, T, D, seed=N * 1000 + D)
    want = jops.duplex_kv_stream(*j, fused=fused)
    got = ops.duplex_kv_stream(*t, fused=fused)
    _assert_close(got, want)


@pytest.mark.parametrize("N,T,D", SHAPES)
def test_single_direction_halves_vs_jax(N, T, D):
    j, t = _inputs(N, T, D, seed=7 + D)
    deq = ops.dequant_kv_stream(t[0], t[1])
    q, scale = ops.quant_kv_stream(t[2])
    want_deq = jops.dequant_kv_stream(j[0], j[1])
    want_q, want_scale = jops.quant_kv_stream(j[2])
    _assert_close((deq, q, scale), (want_deq, want_q, want_scale))


def test_fused_equals_serial_bit_for_bit():
    _, t = _inputs(4, 32, 64, seed=12)
    a = ops.duplex_kv_stream(*t, fused=True)
    b = ops.duplex_kv_stream(*t, fused=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_plain_quantize_matches_jax_reference_exactly():
    x = np.random.default_rng(3).standard_normal((3, 16, 96)).astype(
        np.float32)
    jq, js = jref.quantize_int8(jnp.asarray(x))
    q, s = ref.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = ref.dequantize_int8(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jref.dequantize_int8(jq, js, jnp.float32)))


def test_staging_depth_must_divide_the_stream():
    _, t = _inputs(3, 8, 32, seed=1)
    with pytest.raises(ValueError, match="staging"):
        ops.duplex_kv_stream(*t, stage_blocks=2)


def test_zero_rows_quantize_to_zero():
    x = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    q, s = ops.quant_kv_stream(x)
    assert not q.any()
    np.testing.assert_allclose(s.numpy(), 1e-8 / 127.0, rtol=1e-6)


def test_wrappers_take_cuda_tensors_only():
    _, t = _inputs(2, 8, 32, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        ds.duplex_kv_stream(*t)
    with pytest.raises(ValueError, match="CUDA"):
        ds.quant_stream(t[2])
    with pytest.raises(ValueError, match="CUDA"):
        ds.dequant_stream(t[0], t[1])


def test_no_fallback_to_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    launches or raises — never to the plain version."""
    meta = [x.to("meta") for x in _inputs(2, 8, 32, seed=4)[1]]
    with pytest.raises(ValueError, match="CUDA"):
        ops.duplex_kv_stream(*meta, stage_blocks=2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.duplex_kv_stream(*meta, fused=False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.quant_kv_stream(meta[2])
    with pytest.raises(ValueError, match="CUDA"):
        ops.dequant_kv_stream(meta[0], meta[1])


def test_nothing_is_built_at_import():
    assert ds._lib is None
    path = ds.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libduplex_stream_")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


# -- l2_distance (vector-search tenant) --------------------------------------

def _l2_inputs(Q, N, T, D, seed):
    """The same queries and bf16 blocks for both packages (f32 -> bf16
    rounds to nearest even in both frameworks)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    b = rng.standard_normal((N, T, D)).astype(np.float32)
    j = (jnp.asarray(q), jnp.asarray(b).astype(jnp.bfloat16))
    t = (torch.from_numpy(q), torch.from_numpy(b).to(torch.bfloat16))
    return j, t


@pytest.mark.parametrize("Q,N,T,D", [(4, 3, 16, 64), (1, 1, 8, 128),
                                     (8, 5, 32, 32)])
def test_l2_distance_vs_jax(Q, N, T, D):
    """tests/test_kernels.py:165-175: the port's plain version against the
    Pallas kernel (interpret mode), rtol 1e-4, atol 1e-3."""
    j, t = _l2_inputs(Q, N, T, D, seed=Q * 100 + D)
    want = np.asarray(jops.l2_distance(*j))
    got = ref.l2_distance(*t)
    assert got.shape == (N, Q, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.l2_distance(*j)),
                               rtol=1e-4, atol=1e-3)


def test_l2_zero_distance_to_self():
    _, (_, blocks) = _l2_inputs(1, 2, 8, 64, seed=22)
    d = ops.l2_distance(blocks[1, 3][None].float(), blocks)
    assert d[1, 0, 3] == d.min()
    assert d[1, 0, 3] <= 1e-2


def test_l2_cpu_tensor_goes_to_the_plain_version():
    _, t = _l2_inputs(3, 2, 4, 40, seed=9)
    assert torch.equal(ops.l2_distance(*t), ref.l2_distance(*t))


def test_l2_off_the_cpu_reaches_only_the_kernel():
    _, t = _l2_inputs(2, 2, 4, 16, seed=10)
    with pytest.raises(ValueError, match="CUDA"):
        vd.l2_distance(*t)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA"):
        ops.l2_distance(*meta)


def test_each_library_is_keyed_by_its_own_source():
    """Both kernel modules build through ``kernels/_build.py``; each
    library's name carries its own source's stem and hash, and nothing is
    built when the modules are imported."""
    assert vd._lib is None
    paths = {m: m.library_path() for m in (ds, vd)}
    assert paths[ds] != paths[vd]
    for mod, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{mod.SOURCE.stem}_")
        assert path == _build.library_path(mod.SOURCE)
    assert vd.SOURCE.name == "vector_distance.cu" and vd.SOURCE.exists()
