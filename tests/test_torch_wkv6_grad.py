"""The gradient of the WKV6 recurrence in the port: ``ref.wkv6_backward``
(the plain backward, the CUDA backward's algorithm) against autograd
through the port's ``wkv_scan`` (within 1e-5 of each gradient's largest
magnitude: both f32, sums in another order) and against ``jax.grad`` of
the JAX package's ``wkv_scan`` (within 1e-4 of each gradient's largest
magnitude: another framework's f32 sums), at the kernel's segment and
sub-chunk and at other chunkings, the kernel's geometry
(``rwkv6_scan.backward_geometry``: the shared-memory budget and the
scratch the wrapper allocates), ``gradcheck`` of
``kernels.ops.WKV6Function`` in f64, the ``Function`` on the CPU against
autograd, and the dispatch of ``ops.wkv6``: the ``Function`` only when
autograd records the call on a CUDA tensor (run here through stubs that
stand in for the kernels), and every kernel wrapper refusing an input
that requires grad under grad mode (each wrapper's guard runs before its
device check, so the CPU reaches it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import rwkv6 as JW  # noqa: E402
from repro_torch.kernels import duplex_stream as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402
from repro_torch.kernels import vector_distance as vd  # noqa: E402
from repro_torch.models.rwkv6 import wkv_scan  # noqa: E402

SHAPES = [(2, 7, 3, 4), (1, 1, 2, 8), (2, 37, 2, 8), (1, 16, 1, 16),
          (1, 33, 2, 16)]


def _inputs(B, S, H, hs, seed, dtype=np.float32, decay_bias=-1.0):
    """r, k, v, dout N(0, 1); w = exp(-exp(decay_bias + N(0, 1))), as
    the model draws its decay; u 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, n, d = (rng.standard_normal((B, S, H, hs)) for _ in range(5))
    w = np.exp(-np.exp(decay_bias + n))
    u = 0.5 * rng.standard_normal((H, hs))
    return tuple(x.astype(dtype) for x in (r, k, v, w, u, d))


def _within(got, want, share):
    for name, g, w in zip("r k v w u".split(), got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= share * scale, (
            name, np.abs(g - w).max(), scale)


def _autograd(xs):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs[:5]]
    out, _ = wkv_scan(*ts)
    return torch.autograd.grad(out, ts, torch.from_numpy(xs[5]),
                               allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_equals_autograd(shape):
    xs = _inputs(*shape, seed=1)
    got = ref.wkv6_backward(*(torch.from_numpy(x) for x in xs))
    assert all(g.dtype == torch.float32 for g in got)
    assert got[4].shape == (shape[2], shape[3])
    _within(got, _autograd(xs), 1e-5)


def test_plain_backward_equals_autograd_f64():
    """In f64 the formulas and autograd through the same loop agree to
    rounding (read 3.6e-15 at (2, 7, 3, 4)): the backward is the exact
    gradient, not an approximation of it."""
    xs = _inputs(2, 7, 3, 4, seed=10, dtype=np.float64)
    got = ref.wkv6_backward(*(torch.from_numpy(x) for x in xs))
    assert all(g.dtype == torch.float64 for g in got)
    _within(got, _autograd(xs), 1e-13)


@pytest.mark.parametrize("shape", SHAPES + [(1, 300, 1, 8)])
def test_plain_backward_equals_jax_grad(shape):
    xs = _inputs(*shape, seed=2)
    jxs = [jnp.asarray(x) for x in xs]

    def loss(r, k, v, w, u):
        return jnp.sum(JW.wkv_scan(r, k, v, w, u)[0] * jxs[5])

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jxs[:5])
    got = ref.wkv6_backward(*(torch.from_numpy(x) for x in xs))
    _within(got, want, 1e-4)


# (seg, sub, S): the kernel's pair at S no multiple of either and at
# S = 1; one-level (seg = sub) and finer pairs; segments of one step
CHUNKINGS = [(64, 8, 37), (64, 8, 1), (64, 8, 130), (8, 8, 37), (6, 3, 37),
             (20, 5, 37), (16, 4, 1), (1, 1, 13)]


@pytest.mark.parametrize("seg,sub,S", CHUNKINGS)
def test_plain_backward_does_not_depend_on_its_chunk(seg, sub, S):
    """Every (seg, sub) chunking of the plain backward is the gradient:
    against autograd (1e-5) and ``jax.grad`` (1e-4) at the file's
    tolerances."""
    xs = _inputs(2, S, 2, 8, seed=3)
    got = ref.wkv6_backward(*(torch.from_numpy(x) for x in xs), seg=seg,
                            sub=sub)
    _within(got, _autograd(xs), 1e-5)
    jxs = [jnp.asarray(x) for x in xs]

    def loss(r, k, v, w, u):
        return jnp.sum(JW.wkv_scan(r, k, v, w, u)[0] * jxs[5])

    _within(got, jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jxs[:5]), 1e-4)


def test_plain_backward_refuses_a_segment_not_of_whole_sub_chunks():
    xs = [torch.from_numpy(x) for x in _inputs(1, 4, 1, 4, seed=3)]
    for seg, sub in ((12, 8), (4, 8), (8, 0)):
        with pytest.raises(ValueError, match="multiple"):
            ref.wkv6_backward(*xs, seg=seg, sub=sub)


@pytest.mark.parametrize("hs", rs.HEAD_SIZES)
def test_backward_geometry(hs):
    """The backward kernel's shape, as ``csrc/rwkv6_scan.cu``'s
    ``BwdShape`` sets it: whole warps, a row's lanes inside one warp, at
    most one store item a thread, the kernel's own sub-chunk and segment,
    a block's shared memory within the card's 227 KB (the slots, the
    input ring, the column partials and the row sums), registers for
    sub-chunk states of 16 floats a thread, and the checkpoint scratch
    the wrapper allocates: one state (slice) a segment but the last."""
    g = rs.backward_geometry(hs)
    assert (g["sub"], g["seg"]) == (rs.BWD_SUB, rs.BWD_SEG)
    assert ref.wkv6_backward.__defaults__ == (rs.BWD_SEG, rs.BWD_SUB)
    assert g["slices"] * g["slice_rows"] == hs
    lanes = hs // g["cols"]
    assert lanes <= 32 and 32 % lanes == 0
    assert g["threads"] % 32 == 0
    assert g["threads"] == g["slice_rows"] // g["rows"] * lanes
    assert g["sub"] * hs // 4 <= g["threads"]
    assert g["rows"] * g["cols"] <= 16
    assert g["smem_bytes"] <= rs.SMEM_LIMIT
    slots = g["seg"] // g["sub"] * g["slice_rows"] * hs
    assert g["smem_bytes"] > 4 * slots
    assert g["stages"] - 1 < g["seg"] // g["sub"]
    for B, S, H in ((2, 4096, 64), (1, 1, 3), (2, 64, 2), (1, 65, 2),
                    (3, 203, 1)):
        want = B * H * (-(-S // rs.BWD_SEG) - 1) * g["slice_rows"] * hs
        assert rs.backward_geometry(hs, B, S, H)["scratch_floats"] == want
        kept = rs._backward_scratch(B, S, H, hs, "cpu")
        assert kept.dtype == torch.float32 and kept.numel() == max(want, 1)


def test_backward_geometry_at_the_path_shape():
    """hs 64 (rwkv6-7b): 256 threads of 4 x 4, the 8 sub-chunk states of a
    thread in 128 registers, 8 slots of 16 KB and 226 KB in all; 134 MB
    of checkpoints at (2, 4096, 64), where the old kernel kept 537 MB and
    a 34 MB per-block scratch of one state a step; hs 128 in four slices
    of 32 rows, within 227 KB."""
    g = rs.backward_geometry(64, 2, 4096, 64)
    assert (g["threads"], g["rows"], g["cols"], g["slices"]) == (256, 4, 4, 1)
    assert g["smem_bytes"] == 231_424 <= rs.SMEM_LIMIT
    assert 4 * g["scratch_floats"] == 132_120_576
    g = rs.backward_geometry(128)
    assert (g["slices"], g["slice_rows"], g["threads"]) == (4, 32, 256)
    assert g["smem_bytes"] == 228_352 <= rs.SMEM_LIMIT
    with pytest.raises(ValueError, match="head size"):
        rs.backward_geometry(48)


def test_plain_backward_where_w_is_zero():
    """w = exp(-exp(.)) rounds to 0 in f32 for a large decay input; the
    gradient stays finite and equals autograd's (no divide by w)."""
    xs = list(_inputs(1, 20, 2, 8, seed=4, decay_bias=4.5))
    assert (xs[3] == 0).mean() > 0.1
    got = ref.wkv6_backward(*(torch.from_numpy(x) for x in xs))
    assert all(torch.isfinite(g).all() for g in got)
    _within(got, _autograd(xs), 1e-5)


def test_function_gradcheck_f64():
    xs = [torch.from_numpy(x).requires_grad_(True)
          for x in _inputs(2, 5, 2, 3, seed=5, dtype=np.float64)[:5]]
    assert torch.autograd.gradcheck(ops.WKV6Function.apply, xs)


def test_function_on_cpu_equals_autograd():
    xs = _inputs(2, 23, 2, 8, seed=6)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs[:5]]
    out = ops.WKV6Function.apply(*ts)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        wkv_scan(*(torch.from_numpy(x) for x in xs[:5]))[0].numpy())
    got = torch.autograd.grad(out, ts, torch.from_numpy(xs[5]))
    _within(got, _autograd(xs), 1e-5)


@pytest.fixture
def card_stub(monkeypatch):
    """``ops`` treating CPU tensors as the card's, with the two kernels
    replaced by counting calls of their plain versions."""
    calls = []

    def fwd(*a):
        rs._no_grad("wkv6", *a)
        calls.append("wkv6")
        return ref.wkv6(*a)[0]

    def bwd(*a):
        calls.append("wkv6_backward")
        return ref.wkv6_backward(*a)

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._rs, "wkv6", fwd)
    monkeypatch.setattr(ops._rs, "wkv6_backward", bwd)
    return calls


def test_ops_wkv6_goes_through_the_function_under_autograd(card_stub):
    xs = _inputs(1, 12, 2, 4, seed=7)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs[:5]]
    out = ops.wkv6(*ts, chunk=12)
    assert out.grad_fn is not None and card_stub == ["wkv6"]
    got = torch.autograd.grad(out, ts, torch.from_numpy(xs[5]))
    assert card_stub == ["wkv6", "wkv6_backward"]
    _within(got, _autograd(xs), 1e-5)


def test_ops_wkv6_saves_nothing_without_grad(card_stub):
    xs = [torch.from_numpy(x) for x in _inputs(1, 12, 2, 4, seed=8)[:5]]
    for t in xs:
        t.requires_grad_(True)
    with torch.no_grad():
        out = ops.wkv6(*xs, chunk=12)
    assert out.grad_fn is None and card_stub == ["wkv6"]
    out = ops.wkv6(*(t.detach() for t in xs), chunk=12)
    assert out.grad_fn is None and card_stub == ["wkv6", "wkv6"]


def _guarded():
    rng = np.random.default_rng(9)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    bf = lambda *s: f32(*s).to(torch.bfloat16)
    q8 = lambda *s: torch.zeros(s, dtype=torch.int8)
    return [
        ("wkv6", rs.wkv6, (f32(1, 4, 1, 16),) * 4 + (f32(1, 16),), 4),
        ("flash_attention", fa.flash_attention,
         (bf(1, 16, 2, 64), bf(1, 16, 1, 64), bf(1, 16, 1, 64)), 2),
        ("duplex_kv_stream", ds.duplex_kv_stream,
         (q8(1, 16, 32), f32(1, 16, 1), bf(1, 16, 32)), 1),
        ("quant_stream", ds.quant_stream, (bf(1, 16, 32),), 0),
        ("dequant_stream", ds.dequant_stream,
         (q8(1, 16, 32), f32(1, 16, 1)), 1),
        ("l2_distance", vd.l2_distance, (f32(2, 32), bf(1, 16, 32)), 0),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_wrappers_refuse_inputs_that_require_grad(case):
    name, fn, args, i = _guarded()[case]
    args = list(args)
    args[i] = args[i].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        fn(*args)
    # without autograd the guard passes and the device check refuses
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        fn(*args)
