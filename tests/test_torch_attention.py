"""Port's flash attention on the CPU (``ops.flash_attention``, which runs
its plain version ``ref.attention`` for a CPU tensor) against the JAX
package: its Pallas kernel in interpret mode on the shapes and
tolerances of ``tests/test_kernels.py``'s flash tests, and its dense
``ref.attention`` where the Pallas kernel's block skip drops prefix
keys. Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402

# the reference's tolerances (tests/test_kernels.py:36-48): the port's
# plain version rounds P to the input dtype before P.V, the Pallas kernel
# keeps it in f32
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# (prefix, blocks) and (window, prefix) corners where the Pallas kernel
# and the reference model's mask part ways
CORNERS = [({"prefix_len": 160}, 64), ({"window": 64, "prefix_len": 32}, 128)]


def _qkv(B, S, H, KV, hd, dtype, seed=0):
    """(jax arrays, torch tensors) of the same N(0, 1) values in
    ``dtype`` (f32 -> bf16 rounds to nearest even in both)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def _against_kernel(shape, dtype=torch.bfloat16, **kw):
    (jq, jk, jv), (q, k, v) = _qkv(*shape, dtype, seed=sum(shape))
    got = ops.flash_attention(q, k, v, **kw)
    want = jops.flash_attention(jq, jk, jv, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 256, 4, 2, 64), (1, 256, 4, 4, 128),
                                   (2, 128, 8, 1, 64), (1, 512, 2, 2, 64)])
def test_causal_sweep(shape):
    _against_kernel(shape, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dtypes(dtype):
    _against_kernel((1, 256, 2, 2, 64), dtype, causal=True)


@pytest.mark.parametrize("window", [64, 96, 256])
def test_sliding_window(window):
    _against_kernel((1, 256, 2, 2, 64), causal=True, window=window)


@pytest.mark.parametrize("prefix", [32, 128])
def test_prefix_lm(prefix):
    _against_kernel((1, 256, 2, 1, 64), causal=True, prefix_len=prefix)


def test_bidirectional():
    _against_kernel((1, 128, 2, 2, 64), causal=False)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 256), (256, 128)])
def test_block_sizes(blocks):
    _against_kernel((1, 256, 2, 2, 64), causal=True, q_block=blocks[0],
                    kv_block=blocks[1])


@pytest.mark.parametrize("mask,blocks", CORNERS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_matches_the_reference_model_at_the_corners(mask, blocks, dtype):
    """Prefix keys past the first q block, and a window beside a prefix:
    the port computes the reference model's mask (``_mask_bias``)."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 256, 2, 1, 64, dtype, seed=7)
    got = ops.flash_attention(q, k, v, q_block=blocks, kv_block=blocks,
                              **mask)
    want = jref.attention(jq, jk, jv, **mask)
    # both are the dense plain version: they differ only by the order
    # of f32 sums and, in bf16, by one rounding of P or the output
    tol = {torch.bfloat16: 1e-2, torch.float32: 2e-5}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("mask,blocks", CORNERS)
def test_reference_kernel_diverges_at_the_corners(mask, blocks):
    """The fault the port does not copy (ROADMAP Queue 3): the Pallas
    kernel skips kv blocks holding prefix keys beyond the first q block,
    and exempts prefix keys from the window; its own oracle does
    neither."""
    (jq, jk, jv), _ = _qkv(1, 256, 2, 1, 64, torch.float32, seed=7)
    kern = jops.flash_attention(jq, jk, jv, q_block=blocks,
                                kv_block=blocks, **mask)
    gold = jref.attention(jq, jk, jv, **mask)
    assert float(jnp.max(jnp.abs(kern - gold))) > 0.1


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_indivisible_sequence_is_refused_on_every_device(device):
    """The reference's divisibility check runs before the dispatch: a CPU
    tensor and a non-CPU one (``meta``, which would go to the kernel)
    are refused alike."""
    q = torch.zeros((1, 200, 2, 64), device=device)
    k = torch.zeros((1, 200, 2, 64), device=device)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(q[:, :96], k[:, :96], k[:, :96], q_block=64)


def test_kernel_wrapper_refuses_cpu_tensors_without_building():
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    assert fa._lib is None and fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("q_block", [16, 64, 24])
def test_chunked_attention_matches_the_reference(q_block):
    """``layers.attention`` over q blocks (24 does not divide S: one dense
    block), with per-row positions, prefix and window, in f32."""
    from repro.models import layers as jnn
    (jq, jk, jv), (q, k, v) = _qkv(2, 64, 4, 2, 16, torch.float32, seed=3)
    pos = np.broadcast_to(np.arange(64)[None, :], (2, 64)).astype(np.int32)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, window=40,
              prefix_len=8, q_block=q_block)
    got = nn.attention(q, k, v, nn.AttnSpec(**kw), torch.from_numpy(pos),
                       torch.from_numpy(pos))
    want = jnn.attention(jq, jk, jv, jnn.AttnSpec(**kw), jnp.asarray(pos),
                         jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    dense = ref.attention(q, k, v, window=40, prefix_len=8)
    torch.testing.assert_close(got, dense, atol=2e-6, rtol=2e-6)
