"""Port's flash attention on the CPU (``ops.flash_attention``, which runs
its plain version ``ref.attention`` for a CPU tensor) against the JAX
package: its Pallas kernel in interpret mode on the shapes and
tolerances of ``tests/test_kernels.py``'s flash tests, and its dense
``ref.attention`` where the Pallas kernel's block skip drops prefix
keys. Inputs are made with numpy from a seed and handed to both."""

import math

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


# ---------------------------------------------------------------------------
# the CUDA kernel's bf16 arithmetic (flash_kernel_tc), modelled in torch
# ---------------------------------------------------------------------------

TC_BQ = 64             # the tensor-core body's q tile height
TC_STAGES = 2          # its K/V ring depth


def _tc_bk(hd):
    """Its kv tile height: 32 at hd 256, else 64."""
    return 32 if hd == 256 else 64


def _tc_ld(hd):
    """Row stride of its shared tiles in bf16 elements (``kTcLd``): hd
    rounded up to a multiple of 64, eight 16-byte chunks."""
    return -(-hd // 64) * 64


def _swz(ld, row, chunk):
    """``swz``: element offset of 16-byte chunk ``chunk`` of ``row`` in a
    tile of row stride ``ld``, the chunk XORed with row % 8."""
    return row * ld + ((chunk ^ (row & 7)) << 3)


def _tc_smem_bytes(hd):
    """``tc_smem_bytes``: the Q tile and two stages of K and V tiles."""
    return 2 * _tc_ld(hd) * (TC_BQ + 2 * TC_STAGES * _tc_bk(hd))


def _swizzle_faults(hd, ld, rows):
    """What breaks the swizzled layout of a ``rows``-row tile of hd
    columns at row stride ``ld``: a chunk mapped outside its own row, two
    chunks on one place, or the eight rows one ldmatrix phase reads (rows
    8i..8i+7, one chunk) not in eight distinct bank groups of 16 bytes."""
    faults = []
    seen = {}
    for row in range(rows):
        for chunk in range(hd // 8):
            off = _swz(ld, row, chunk)
            if not (row * ld <= off and off + 8 <= (row + 1) * ld):
                faults.append(("outside its row", row, chunk, off))
            if off in seen:
                faults.append(("shared", row, chunk, seen[off]))
            seen[off] = (row, chunk)
    for row0 in range(0, rows, 8):
        for chunk in range(hd // 8):
            groups = {(_swz(ld, r, chunk) // 8) % 8
                      for r in range(row0, row0 + 8)}
            if len(groups) != 8:
                faults.append(("bank conflict", row0, chunk, len(groups)))
    return faults


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_tc_swizzle_stays_in_its_row(hd):
    """Every (row, chunk) of the Q tile and of each K and V tile maps
    inside its own row, one to one and free of ldmatrix bank conflicts,
    and the tiles fill ``tc_smem_bytes`` exactly; the layout before hd 80
    and 112 were added (row stride hd) fails there."""
    ld = _tc_ld(hd)
    for rows in (TC_BQ, _tc_bk(hd)):
        assert _swizzle_faults(hd, ld, rows) == []
    tiles = TC_BQ + 2 * TC_STAGES * _tc_bk(hd)
    assert _tc_smem_bytes(hd) == 2 * tiles * ld
    # the Q tile and the ring, one tile after another, end in the last row
    top = max(_swz(ld, r, c) for r in range(tiles) for c in range(hd // 8))
    assert (tiles - 1) * ld <= top and 2 * (top + 8) <= _tc_smem_bytes(hd)
    assert _tc_smem_bytes(hd) <= 227 * 1024
    unpadded = _swizzle_faults(hd, hd, TC_BQ)
    assert (unpadded == []) == (hd % 64 == 0)
    if hd in (80, 112):
        assert ("outside its row", 7, 8, 7 * hd + 15 * 8) in unpadded


def _visible(qi, kj, S, causal, window, prefix_len):
    vis = kj < S
    if causal:
        vis = vis & ((kj <= qi) | (kj < prefix_len))
    if window is not None:
        vis = vis & (kj > qi - window)
    return vis


def _tile_range(q_lo, S, causal, window, prefix_len, bq, bk):
    """The kernel's visited kv tiles [t_begin, t_end) for one q tile."""
    q_hi = min(q_lo + bq, S) - 1
    t_end = -(-S // bk)
    if causal:
        t_end = min(t_end, max(q_hi, prefix_len - 1) // bk + 1)
    # C's integer division truncates toward zero
    t_begin = max(0, int((q_lo - window + 1) / bk)) if window else 0
    return t_begin, t_end


def _tc_model(q, k, v, *, causal=True, window=None, prefix_len=0):
    """flash_kernel_tc's arithmetic: 64-row q tiles and ``_tc_bk``-row kv
    tiles, only the kv tiles of ``_tile_range`` (checked to be those that
    hold a visible pair), the per-element mask only on a tile that
    straddles a mask edge, scores of the bf16 inputs summed in f32,
    the online softmax in the log2 domain with f32 m, l and acc, P rounded
    to bf16 before P.V, and acc / max(l, 1e-20) rounded to bf16."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    bq, bk = TC_BQ, _tc_bk(hd)
    scale_log2 = torch.tensor((1.0 / math.sqrt(hd)) * math.log2(math.e),
                              dtype=torch.float32)
    neg = torch.tensor(-1e30)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    out = torch.empty_like(q)
    for q_lo in range(0, S, bq):
        qi = torch.arange(q_lo, q_lo + bq)
        qt = torch.zeros((B, bq, H, hd))
        n_q = min(bq, S - q_lo)
        qt[:, :n_q] = q[:, q_lo:q_lo + n_q].float()
        m = torch.full((B, H, bq), -1e30)
        l = torch.zeros((B, H, bq))
        acc = torch.zeros((B, H, bq, hd))
        t_begin, t_end = _tile_range(q_lo, S, causal, window, prefix_len,
                                     bq, bk)
        # the visit rule: exactly the kv tiles that hold a visible pair of
        # a real query
        held = _visible(qi[:n_q, None], torch.arange(S)[None, :], S, causal,
                        window, prefix_len).any(0).nonzero().flatten()
        assert set((held // bk).tolist()) == set(range(t_begin, t_end)), q_lo
        for t in range(t_begin, t_end):
            k_lo = t * bk
            kj = torch.arange(k_lo, k_lo + bk)
            n_k = min(bk, S - k_lo)
            kt = torch.zeros((B, bk, H, hd))
            vt = torch.zeros((B, bk, H, hd))
            kt[:, :n_k] = kf[:, k_lo:k_lo + n_k]
            vt[:, :n_k] = vf[:, k_lo:k_lo + n_k]
            x = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * scale_log2
            k_last = k_lo + bk - 1
            edge = (k_last >= S
                    or (causal and not (k_last <= q_lo
                                        or k_last < prefix_len))
                    or (window is not None
                        and not k_lo > q_lo + bq - 1 - window))
            vis = _visible(qi[:, None], kj[None, :], S, causal, window,
                           prefix_len)
            if edge:
                x = torch.where(vis, x, neg)
            else:
                # a tile off every edge is visible throughout (real rows)
                assert vis[:n_q].all()
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vt)
            m = m_new
        o = acc / torch.clamp(l, min=1e-20)[..., None]
        out[:, q_lo:q_lo + n_q] = o.permute(0, 2, 1, 3)[:, :n_q].to(q.dtype)
    return out


@pytest.mark.parametrize("shape,mask", [
    ((2, 256, 4, 2, 64), {}),
    ((1, 256, 4, 4, 128), {}),
    ((2, 128, 8, 1, 64), {}),
    ((1, 256, 2, 2, 64), {"window": 96}),
    ((1, 128, 2, 2, 64), {"causal": False}),
    ((1, 256, 2, 1, 64), {"prefix_len": 32}),
    ((1, 256, 8, 1, 128), {}),
    ((1, 128, 2, 1, 256), {}),
    ((1, 256, 4, 4, 80), {}),
    ((2, 128, 8, 1, 112), {}),
    ((1, 256, 2, 2, 80), {"window": 96}),
    ((1, 256, 2, 1, 112), {"prefix_len": 32}),
])
def test_tc_model_matches_the_pallas_kernel(shape, mask):
    """The kernel's bf16 tile arithmetic against the Pallas kernel in
    interpret mode, at the reference's bf16 tolerance."""
    (jq, jk, jv), (q, k, v) = _qkv(*shape, torch.bfloat16,
                                   seed=sum(shape) + 1)
    got = _tc_model(q, k, v, **mask)
    want = jops.flash_attention(jq, jk, jv, **mask)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("shape,mask", [
    ((1, 256, 2, 1, 64), {"prefix_len": 160}),
    ((1, 256, 2, 1, 64), {"window": 64, "prefix_len": 32}),
    ((1, 256, 2, 1, 256), {"prefix_len": 96}),
    ((2, 200, 4, 2, 64), {}),
    ((1, 200, 2, 2, 64), {"window": 40, "prefix_len": 70}),
])
def test_tc_model_matches_the_oracle_where_pallas_cannot(shape, mask):
    """Prefix keys past the first q tile, a window beside a prefix (where
    the Pallas kernel is wrong) and a ragged S (which it refuses): the
    kernel's bf16 tile arithmetic against the dense oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(*shape, torch.bfloat16,
                                   seed=sum(shape) + 2)
    got = _tc_model(q, k, v, **mask)
    want = jref.attention(jq, jk, jv, **mask)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
