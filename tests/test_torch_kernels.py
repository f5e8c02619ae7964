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


# -- the CUDA kernels' launch geometry and l2_distance's summation order ----
#
# The geometry is computed in Python (``vd.geometry``, ``ds.geometry``) and
# handed to the kernels; the sums of ``csrc/vector_distance.cu`` are
# modelled here in numpy, in the kernel's order.

D_KV = 30 * 2 * 3 * 64    # smollm-135m's kv_dims: the pool's row width
# chip_smoke.py's check_l2 and check_kernels shapes
L2_SHAPES = [(4, 3, 16, 64), (1, 1, 8, 128), (8, 5, 32, 32), (4, 2, 16, D_KV),
             (4, 32, 16, D_KV), (3, 4, 16, 1001), (12, 2, 16, D_KV),
             (4, 8, 16, D_KV), (12, 3, 16, 1001), (1, 8, 16, D_KV)]
STREAM_SHAPES = [(2, 16, D_KV), (8, 16, D_KV), (32, 16, D_KV), (3, 5, 1001),
                 (4, 16, D_KV), (1, 16, D_KV), (1, 1, 7)]


@pytest.mark.parametrize("Q,N,T,D", L2_SHAPES)
def test_l2_geometry_covers_the_work(Q, N, T, D):
    """Every unit of D in exactly one slice of one cluster rank, every
    slice walked in tiles of at most one unit a thread, every row in one
    group, within the source's limits; the tenant shape fills 128
    blocks."""
    g = vd.geometry(Q, N, T, D)
    assert g["vec"] == (D % 8 == 0) and g["unit"] * g["units"] == D
    assert g["cluster"] in (1, 2, 4, 8)
    covered = []
    for rank in range(g["cluster"]):
        lo = rank * g["slice_units"]
        hi = min(g["units"], lo + g["slice_units"])
        assert hi > lo
        covered += range(lo, hi)
    assert covered == list(range(g["units"]))
    assert 1 <= g["tile_units"] <= min(vd.THREADS, g["slice_units"])
    assert 1 <= g["rows_per_cta"] <= vd.MAX_ROWS
    groups = g["blocks"] // g["cluster"]
    assert (groups - 1) * g["rows_per_cta"] < N * T \
        <= groups * g["rows_per_cta"]
    buffers = 1 if g["tile_units"] == g["slice_units"] else 2
    rows = g["rows_per_cta"] * g["tile_units"] * 16 if g["vec"] else 0
    assert g["smem_bytes"] == buffers * (
        min(Q, vd.Q_CHUNK) * g["tile_units"] * g["unit"] * 4 + rows)
    assert g["smem_bytes"] <= 227 * 1024
    if (Q, N, T, D) == (4, 2, 16, D_KV):
        assert g["blocks"] >= 128 and g["cluster"] == 8
    assert not vd.geometry(Q, N, T, D, aligned=False)["vec"]


@pytest.mark.parametrize("N,T,D", STREAM_SHAPES)
@pytest.mark.parametrize("directions", [1, 2])
def test_stream_geometry_cuts_rows_into_parts(N, T, D, directions):
    """On the 16-byte path (D a multiple of 16, the pointers aligned) 1, 2
    or 4 blocks a row and direction, the most that keep the launch within
    one wave; on the element path one block a row; the serving shape's
    fused pass takes 256 blocks, two a row each way."""
    g = ds.geometry(N * T, D, directions)
    assert g["vec"] == (D % 16 == 0)
    assert g["parts"] in (1, 2, 4)
    assert g["blocks"] == N * T * directions * g["parts"]
    assert g["blocks"] <= ds.WAVE_BLOCKS or g["parts"] == 1
    if g["vec"]:
        assert g["parts"] == ds.MAX_PARTS \
            or 2 * g["blocks"] > ds.WAVE_BLOCKS
    else:
        assert g["parts"] == 1
    if (N, T, D, directions) == (4, 16, D_KV, 2):
        assert (g["blocks"], g["parts"]) == (256, 2)
    unaligned = ds.geometry(N * T, D, directions, aligned=False)
    assert not unaligned["vec"] and unaligned["parts"] == 1


def _fma(a, b, c):
    """fmaf in float32: the exact product plus c in float64, rounded to
    float32 (twice rounded; the card's fmaf rounds once, which can differ
    in the last bit)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _tree(v):
    """A block's reduction of per-thread sums (..., THREADS): warp
    butterflies, then the warps' sums in order."""
    lanes = np.arange(32)
    v = v.reshape(*v.shape[:-1], vd.THREADS // 32, 32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    s = np.zeros(v.shape[:-2], np.float32)
    for w in range(v.shape[-2]):
        s = (s + v[..., w, 0]).astype(np.float32)
    return s


def _unit_dot(a, b):
    """``unit_dot``: a . b over the last axis (a unit) as two FMA chains,
    over its first and second half in order, then their sum; a one-element
    unit is the rounded product."""
    unit = a.shape[-1] if a.shape[-1] >= b.shape[-1] else b.shape[-1]
    if unit == 1:
        return (a[..., 0].astype(np.float64) * b[..., 0]).astype(np.float32)
    shape = np.broadcast_shapes(a.shape, b.shape)[:-1]
    lo = np.zeros(shape, np.float32)
    hi = np.zeros(shape, np.float32)
    for k in range(unit // 2):
        lo = _fma(a[..., k], b[..., k], lo)
        hi = _fma(a[..., unit // 2 + k], b[..., unit // 2 + k], hi)
    return (lo + hi).astype(np.float32)


def _l2_model(queries, blocks, geo):
    """``csrc/vector_distance.cu``'s sums: per cluster rank (a slice of
    D) and thread, for each of its units (one a tile, tiles in order),
    ||q||^2, ||b||^2 and q . b by ``_unit_dot``, and
    (||q||^2 + ||b||^2) - 2 q . b added to the thread's sum;
    ``_tree`` per block; the ranks' partials in rank order."""
    Q, D = queries.shape
    N, T, _ = blocks.shape
    x = blocks.reshape(N * T, D).astype(np.float32)
    y = queries.astype(np.float32)
    unit, units = geo["unit"], geo["units"]
    out = np.zeros((N * T, Q), np.float32)
    for rank in range(geo["cluster"]):
        lo = rank * geo["slice_units"]
        hi = min(units, lo + geo["slice_units"])
        acc = np.zeros((N * T, Q, vd.THREADS), np.float32)
        for t0 in range(lo, hi, geo["tile_units"]):
            n = min(geo["tile_units"], hi - t0)
            xu = x[:, t0 * unit:(t0 + n) * unit].reshape(N * T, 1, n, unit)
            yu = y[:, t0 * unit:(t0 + n) * unit].reshape(1, Q, n, unit)
            qq, bb, dot = (_unit_dot(a, b) for a, b in
                           ((yu, yu), (xu, xu), (yu, xu)))
            unit_d = ((qq + bb).astype(np.float32)
                      - (2 * dot).astype(np.float32)).astype(np.float32)
            acc[..., :n] = (acc[..., :n] + unit_d).astype(np.float32)
        out = (out + _tree(acc)).astype(np.float32)
    return out.reshape(N, T, Q).transpose(0, 2, 1)


@pytest.mark.parametrize("shape", [(4, 2, 16, D_KV), (3, 2, 8, 1001)])
def test_l2_summation_order_vs_the_pallas_kernel(shape):
    """The kernel's summation order at the tenant shape (D cut into 8
    slices combined in rank order) and on the scalar path against the
    Pallas kernel in interpret mode, at the reference's tolerance; a
    query equal to a stored vector is at exactly 0."""
    Q, N, T, D = shape
    j, t = _l2_inputs(Q, N, T, D, seed=D)
    geo = vd.geometry(Q, N, T, D)
    blocks = t[1].float().numpy()
    got = _l2_model(t[0].numpy(), blocks, geo)
    want = np.asarray(jops.l2_distance(*j))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    # the reference's own expansion leaves ~1e-2 here; the kernel's one
    # FMA sequence and tree leave nothing
    queries = t[0].numpy().copy()
    queries[1] = blocks[1, 3]
    self_d = _l2_model(queries, blocks, geo)
    assert self_d[1, 1, 3] == 0.0 and self_d.min() == 0.0
