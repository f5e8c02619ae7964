"""On-card tests of the port (marker ``cuda``): the CUDA kernels against
their plain versions, the serving engine token-exact on the GPU, with
and without tenants, its CUDA graphs of the engine steps against the
eager megastep (smollm-135m paged, the tenant mix, rwkv6-7b,
mixtral-8x7b paged), the MoE block against the CPU's, the
forward through the flash-attention kernel, the RWKV6 forward
through the wkv6 kernel, a traced engine against an untraced one (also
under the torch profiler, its phases as host ranges), the
stream simulator on the card against the CPU and its step graphs
against its eager steps, a crashed graphed engine restored from its
snapshots against its uncrashed twin, and training: the wkv6 backward
kernel against its plain version, ``ops.wkv6`` through its autograd
Function, the kernel wrappers refusing inputs that require grad, and
one train step of mixtral-8x7b and of rwkv6-7b (SMOKE) on the card;
the wkv6 custom ops' fake shapes and FLOP formula against the kernels,
and remat keeping rwkv6's gradients while it recomputes wkv6.
They skip where there is no CUDA device; on a machine with one, run

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import sync_watch  # noqa: E402
from repro_torch.kernels import duplex_stream as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import vector_distance as vd  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _streams(n, t, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    in_q, in_scale = ref.quantize_int8(torch.randn((n, t, d), generator=g))
    out_x = torch.randn((n, t, d), generator=g).to(torch.bfloat16)
    return [x.to(device) for x in (in_q, in_scale, out_x)]


def _assert_close(got, want):
    deq, q, scale = got
    wdeq, wq, wscale = want
    assert torch.equal(deq, wdeq)
    torch.testing.assert_close(scale, wscale, rtol=1e-6, atol=0.0)
    assert (q.int() - wq.int()).abs().max().item() <= 1


@pytest.mark.parametrize("shape", [(2, 16, 11520), (6, 16, 11520),
                                   (8, 16, 11520), (32, 16, 11520),
                                   (3, 5, 1001), (1, 1, 7), (300, 16, 48)])
def test_kernels_match_plain_versions(cuda, shape):
    streams = _streams(*shape, seed=sum(shape), device=cuda)
    want = ref.duplex_kv_stream(*streams)
    before = dict(ds.LAUNCHES)
    _assert_close(ds.duplex_kv_stream(*streams), want)
    _assert_close(ops.duplex_kv_stream(*streams, fused=False), want)
    q, scale = ds.quant_stream(streams[2])
    _assert_close((ds.dequant_stream(*streams[:2]), q, scale), want)
    torch.cuda.synchronize()
    assert {k: ds.LAUNCHES[k] - before[k] for k in before} == {
        "duplex_kv_stream": 1, "quant_stream": 2, "dequant_stream": 2}


def test_page_out_rounds_exact_ties_half_to_even(cuda):
    """Rows whose values divide by their scale to exact half-integers
    (amax 127, so the scale is 1): the kernels' codes equal the plain
    version's true divide and round half to even, code for code."""
    halves = torch.arange(-126, 127, dtype=torch.float32) + 0.5
    row = torch.cat([halves, torch.tensor([127.0, -127.0])])
    out_x = row.repeat(2, 16, 4).to(torch.bfloat16).to(cuda)
    assert out_x.shape == (2, 16, 1020)
    for x in (out_x, torch.nn.functional.pad(out_x, (0, 4))):
        x = x.contiguous()
        want_q, want_scale = ref.quantize_int8(x)
        q, scale = ds.quant_stream(x)
        assert torch.equal(q, want_q) and torch.equal(scale, want_scale)
        assert torch.equal(ds.duplex_kv_stream(want_q, want_scale, x)[1],
                           want_q)


def test_wrappers_reject_bad_inputs(cuda):
    in_q, in_scale, out_x = _streams(2, 4, 32, seed=0, device=cuda)
    with pytest.raises(TypeError):
        ds.quant_stream(out_x.float())
    with pytest.raises(ValueError, match="contiguous"):
        ds.quant_stream(out_x.transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        ds.duplex_kv_stream(in_q, in_scale[:1], out_x)


def test_engine_token_exact_on_the_card(cuda):
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig, ServeEngine, reference_decode
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 7)).astype(np.int32)
    cfg = EngineConfig(max_batch=3, cache_len=64, block_tokens=4,
                       hbm_blocks=6, prefill_chunk=3, max_queue=8,
                       megastep=4, pipeline_depth=2, device="cuda")
    eng = ServeEngine(api, params, cfg)
    rids = [eng.submit(prompts[i], 9, arrival_step=2 * i).rid
            for i in range(6)]
    ds.reset_launches()
    outs = eng.run(max_steps=300)
    assert ds.LAUNCHES["duplex_kv_stream"] > 0
    for lo in range(0, 6, 3):
        want = reference_decode(api, params, prompts[lo:lo + 3], 9,
                                cache_len=64).cpu().numpy()
        for j in range(3):
            np.testing.assert_array_equal(outs[rids[lo + j]], want[j])
    assert eng.stats()["host_blocked"] == 1
    eng.pool.check_invariants()


@pytest.mark.parametrize("shape", [(4, 3, 16, 64), (1, 1, 8, 128),
                                   (8, 5, 32, 32), (4, 2, 16, 11520),
                                   (4, 8, 16, 11520), (4, 32, 16, 11520),
                                   (12, 3, 16, 1001), (3, 4, 16, 1001)])
def test_l2_distance_matches_plain_version(cuda, shape):
    Q, N, T, D = shape
    g = torch.Generator().manual_seed(sum(shape))
    q = torch.randn((Q, D), generator=g).to(cuda)
    blocks = torch.randn((N, T, D), generator=g).to(torch.bfloat16).to(cuda)
    before = vd.LAUNCHES["l2_distance"]
    got = ops.l2_distance(q, blocks)
    torch.cuda.synchronize()
    assert vd.LAUNCHES["l2_distance"] == before + 1
    torch.testing.assert_close(got, ref.l2_distance(q, blocks), rtol=1e-4,
                               atol=1e-3)
    self_d = ops.l2_distance(blocks[1 % N, 3][None].float(), blocks)
    assert self_d[1 % N, 0, 3] == self_d.min() <= 1e-2


def test_l2_wrapper_rejects_bad_inputs(cuda):
    q = torch.randn((2, 32), device=cuda)
    blocks = torch.randn((3, 4, 32), device=cuda).to(torch.bfloat16)
    with pytest.raises(TypeError):
        vd.l2_distance(q, blocks.float())
    with pytest.raises(ValueError, match="shape"):
        vd.l2_distance(q[:, :16].contiguous(), blocks)
    with pytest.raises(ValueError, match="contiguous"):
        vd.l2_distance(q, blocks.transpose(0, 1))


def test_tenant_engine_on_the_card(cuda):
    """Both tenants co-served with decode: tokens exact, every kernel
    launched, the withdrawn scope never fused."""
    from repro_torch.models import registry
    from repro_torch.serve import (EngineConfig, KVStoreTenant, ServeEngine,
                                   VectorSearchTenant, reference_decode)
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (4, 7)).astype(np.int32)
    eng = ServeEngine(api, params, EngineConfig(
        max_batch=2, cache_len=64, block_tokens=4, hbm_blocks=10,
        prefill_chunk=2, max_queue=12, megastep=4, pipeline_depth=2,
        device="cuda"))
    kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=1,
                                      store_blocks=12))
    kv.preload(12)
    vec = eng.add_tenant(VectorSearchTenant(n_slots=1, visits_per_step=2,
                                            data_blocks=6))
    rids = [eng.submit(prompts[i], 8, arrival_step=2 * i).rid
            for i in range(4)]
    kv.submit("sequential", n_steps=24)
    kv.submit("read_heavy", n_steps=24)
    vec.submit(n_steps=24)
    ds.reset_launches()
    vd.reset_launches()
    outs = eng.run(max_steps=300)
    for lo in range(0, 4, 2):
        want = reference_decode(api, params, prompts[lo:lo + 2], 8,
                                cache_len=64).cpu().numpy()
        for j in range(2):
            np.testing.assert_array_equal(outs[rids[lo + j]], want[j])
    assert vd.LAUNCHES["l2_distance"] > 0
    assert ds.LAUNCHES["quant_stream"] + ds.LAUNCHES["dequant_stream"] > 0
    withdrawn = eng.paging_stats()["by_path"]["/serve/redis/read_heavy"]
    assert withdrawn["fused_calls"] == 0
    assert kv.ops_done > 0 and vec.queries_done > 0
    eng.pool.check_invariants()


@pytest.mark.parametrize("shape,mask", [
    ((2, 256, 4, 2, 64, torch.bfloat16), {}),
    # prefix keys past the first q tile: the Pallas kernel drops them
    ((1, 256, 2, 1, 64, torch.bfloat16), {"prefix_len": 160}),
    ((1, 192, 4, 1, 256, torch.float32), {"prefix_len": 70, "window": 100}),
])
def test_flash_attention_matches_plain_version(cuda, shape, mask):
    B, S, H, KV, hd, dtype = shape
    g = torch.Generator().manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=g).to(dtype).to(cuda)
    k = torch.randn((B, S, KV, hd), generator=g).to(dtype).to(cuda)
    v = torch.randn((B, S, KV, hd), generator=g).to(dtype).to(cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, q_block=64, kv_block=64, **mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype
    # the reference's tolerances; f32 products in the plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got, ref.attention(q, k, v, **mask),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,mask", [
    # a ragged last q and kv tile of the 64-row tiles (200 = 3 x 64 + 8)
    ((2, 200, 4, 2, 64), {}),
    ((1, 200, 2, 2, 64), {"window": 40, "prefix_len": 70}),
    # GQA with 8 q heads on one kv head at hd 128
    ((1, 256, 8, 1, 128), {}),
    # a prefix ending inside the second q tile at hd 256
    ((1, 256, 2, 1, 256), {"prefix_len": 96}),
])
def test_flash_attention_edges_of_the_tensor_core_tiles(cuda, shape, mask):
    """The bf16 kernel (tensor cores, 64-row tiles) at the edges of its
    tiling against ``ref.attention``, at the reference's bf16
    tolerance; the wrapper takes a ragged S the model path never hands
    it."""
    B, S, H, KV, hd = shape
    g = torch.Generator().manual_seed(S + hd + H)
    q = torch.randn((B, S, H, hd), generator=g).to(torch.bfloat16).to(cuda)
    k = torch.randn((B, S, KV, hd), generator=g).to(torch.bfloat16).to(cuda)
    v = torch.randn((B, S, KV, hd), generator=g).to(torch.bfloat16).to(cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.attention(q, k, v, **mask),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,mask", [
    # stablelm-3b's heads (hd 80), a ragged S and a prefix past a q tile
    ((1, 256, 4, 4, 80), {}),
    ((2, 200, 4, 2, 80), {"prefix_len": 96}),
    # kimi-k2's (hd 112, 8 q heads on a kv head), a window and ragged S
    ((1, 256, 8, 1, 112), {}),
    ((1, 200, 4, 1, 112), {"window": 40, "prefix_len": 70}),
])
def test_flash_attention_at_head_dims_80_and_112(cuda, shape, mask, dtype):
    """Both bodies at the head dims whose rows are not a whole number of
    64 elements: the tensor-core body's padded tile rows and the f32
    body's partial last pass over the columns, against ``ref.attention``
    at the reference's tolerance for the dtype."""
    B, S, H, KV, hd = shape
    g = torch.Generator().manual_seed(S + hd + H)
    q, k, v = (torch.randn((B, S, n, hd), generator=g).to(dtype).to(cuda)
               for n in (H, KV, KV))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got, ref.attention(q, k, v, **mask),
                               atol=tol, rtol=tol)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                           q[..., :32].contiguous())
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)


def test_forward_through_the_kernel_on_the_card(cuda):
    """A two-layer decoder at head_dim 64: ``use_kernel=True`` launches
    the kernel once per layer and matches the plain forward; prefill's
    logits equal the plain forward's."""
    import dataclasses

    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    cfg = dataclasses.replace(api.cfg, d_model=192, num_heads=3,
                              num_kv_heads=1)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 128))).to(cuda)
    fa.reset_launches()
    with torch.inference_mode():
        lk, _ = T.forward(params, cfg, tokens, use_kernel=True)
        assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
        lp, _ = T.forward(params, cfg, tokens)
        lg, _ = T.prefill(params, cfg, tokens, cache_len=130)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(lk.float(), lp.float(), atol=5e-2, rtol=0)
    torch.testing.assert_close(lg, lp, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (1, 77, 2, 16),
                                   (1, 100, 2, 128), (2, 33, 2, 32)])
def test_wkv6_matches_plain_version(cuda, shape):
    """The kernel against ``ref.wkv6`` at the reference's tolerance, with
    a ragged S (no multiple of the kernel's 32-step chunk)."""
    from repro_torch.kernels import rwkv6_scan as rs
    g = torch.Generator().manual_seed(sum(shape))
    B, S, H, hs = shape
    r, k, v, n = (torch.randn(shape, generator=g) for _ in range(4))
    w = torch.exp(-torch.exp(-6.0 + n))
    u = 0.5 * torch.randn((H, hs), generator=g)
    r, k, v, w, u = (x.to(cuda) for x in (r, k, v, w, u))
    before = rs.LAUNCHES["wkv6"]
    got = ops.wkv6(r, k, v, w, u, chunk=S)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wkv6"] == before + 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(got, ref.wkv6(r, k, v, w, u)[0], atol=1e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        ops.wkv6(r, k, v, w, u, chunk=S - 1)


def test_rwkv_forward_launches_wkv6_once_per_layer(cuda):
    """The registry's forward on the card runs the recurrence as the
    kernel, once per layer, and matches the plain forward."""
    import dataclasses

    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.models import registry
    from repro_torch.models import rwkv6 as W
    api = registry.build("rwkv6-7b", smoke=True, device="cuda")
    cfg = dataclasses.replace(api.cfg, dtype=torch.float32)
    api = registry._rwkv_api("rwkv6-7b", cfg, "cuda")
    params = api.init(torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 100))).to(cuda)
    rs.reset_launches()
    with torch.inference_mode():
        lk = api.forward(params, {"tokens": tokens})
        assert rs.LAUNCHES["wkv6"] == cfg.num_layers
        lp, _ = W.forward(params, cfg, tokens, use_kernel=False)
    assert rs.LAUNCHES["wkv6"] == cfg.num_layers
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke configs' MoE block in bf16 on the card (cuBLAS writes the
    gate and up products in f32) against the same block on the CPU (the
    operands upcast to f32): the same experts, outputs within one bf16 ulp
    at |out| ~2 (2**-7); two runs on the card bit-equal (the combine adds
    in a fixed order)."""
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    api = registry.build(arch, smoke=True, device="cpu")
    params = api.init(torch.Generator().manual_seed(1))
    block = nn.tree_map(lambda t: t[0], params["layers"]["moe"])
    x = torch.randn((3, 11, api.cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    want = nn.moe_apply(block, x, api.cfg.moe)
    on_card = nn.tree_map(lambda t: t.to(cuda), block)
    got = nn.moe_apply(on_card, x.to(cuda), api.cfg.moe)
    again = nn.moe_apply(on_card, x.to(cuda), api.cfg.moe)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=2.0 ** -7, rtol=0)
    logits = x.reshape(33, -1).float() @ block["router"]
    assert torch.equal(
        nn.top_k(logits.to(cuda), api.cfg.moe.top_k)[1].cpu(),
        nn.top_k(logits, api.cfg.moe.top_k)[1])


# ---------------------------------------------------------------------------
# the engine steps as CUDA graphs
# ---------------------------------------------------------------------------

def _graph_case(case):
    """(api, params, config, prompts, gen, tenants?) of one SMOKE case."""
    from repro_torch.models import registry
    from repro_torch.serve import EngineConfig
    arch = {"rwkv6": "rwkv6-7b", "moe": "mixtral-8x7b"}.get(case,
                                                            "smollm-135m")
    api = registry.build(arch, smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 7)).astype(np.int32)
    cfg = {"paged": dict(max_batch=3, cache_len=64, block_tokens=4,
                         hbm_blocks=6, prefill_chunk=3, max_queue=8),
           "moe": dict(max_batch=3, cache_len=64, block_tokens=4,
                       hbm_blocks=6, prefill_chunk=3, max_queue=8),
           "tenants": dict(max_batch=2, cache_len=64, block_tokens=4,
                           hbm_blocks=10, prefill_chunk=2, max_queue=12),
           "rwkv6": dict(max_batch=3, cache_len=64, prefill_chunk=4,
                         max_queue=8)}[case]
    return (api, params, EngineConfig(**cfg, megastep=4, pipeline_depth=2,
                                      device="cuda"), prompts)


def _graph_run(api, params, cfg, prompts, graphs, tenants):
    """One run with ``decode_step`` counted: tokens, stats, paging stats,
    micro-steps, the kernels' launches, the engine, and the decode_step
    calls made while the engine was built and while it ran."""
    from repro_torch.serve import (KVStoreTenant, ServeEngine,
                                   VectorSearchTenant)
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return api.decode_step(*a)

    eng = ServeEngine(api._replace(decode_step=counted), params, cfg,
                      _graphs=None if graphs else False)
    built = calls[0]
    if tenants:
        kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=1,
                                          store_blocks=12))
        kv.preload(12)
        vec = eng.add_tenant(VectorSearchTenant(
            n_slots=1, visits_per_step=2, data_blocks=6))
        kv.submit("sequential", n_steps=24)
        kv.submit("read_heavy", n_steps=24)
        vec.submit(n_steps=24)
    rids = [eng.submit(p, 9, arrival_step=2 * i).rid
            for i, p in enumerate(prompts)]
    ds.reset_launches()
    vd.reset_launches()
    outs = eng.run(max_steps=300)
    torch.cuda.synchronize()
    launches = {**ds.LAUNCHES, **vd.LAUNCHES}
    return dict(tokens=[outs[r] for r in rids], stats=eng.stats(),
                paging=eng.paging_stats(), micro=eng.decode_steps,
                launches=launches, engine=eng, built=built,
                ran=calls[0] - built)


@pytest.mark.parametrize("case", ["paged", "tenants", "rwkv6", "moe"])
def test_graph_engine_equals_eager_megastep(cuda, case):
    """The graphed engine against the eager megastep on the card: the
    same tokens (and the static-batch oracle's), stats, paging stats,
    micro-steps and kernel launches; ``decode_step`` runs while the
    graphs are captured (a warm-up and a capture of every step) and never
    on a replay; the graphs stay within prefill_chunk + 1."""
    from repro_torch.serve import reference_decode
    api, params, cfg, prompts = _graph_case(case)
    tenants = case == "tenants"
    eager = _graph_run(api, params, cfg, prompts, False, tenants)
    graphed = _graph_run(api, params, cfg, prompts, True, tenants)
    for a, b in zip(eager["tokens"], graphed["tokens"]):
        np.testing.assert_array_equal(b, a)
    for key in ("stats", "paging", "micro", "launches"):
        assert graphed[key] == eager[key], key
    B = cfg.max_batch
    for lo in range(0, len(prompts), B):
        want = reference_decode(api, params, prompts[lo:lo + B], 9,
                                cache_len=cfg.cache_len).cpu().numpy()
        for j in range(want.shape[0]):
            np.testing.assert_array_equal(graphed["tokens"][lo + j],
                                          want[j])
    eng = graphed["engine"]
    keys = eng.graphs.keys
    assert eng.graphs.captured and eng.n_graphs == len(keys)
    assert eng.n_graphs <= cfg.prefill_chunk + 1
    assert keys == tuple(range(0 if eng.paged else 1,
                               cfg.prefill_chunk + 1))
    assert graphed["built"] == 2 * sum(keys) and graphed["ran"] == 0
    assert eager["built"] == 0 and eager["ran"] == eager["micro"] > 0
    assert eager["engine"].graphs is None
    if tenants:
        assert graphed["launches"]["l2_distance"] > 0
        assert eng.paging_stats()["by_path"]["/serve/redis/read_heavy"][
            "fused_calls"] == 0
    if eng.paged:
        assert graphed["launches"]["duplex_kv_stream"] > 0
        eng.pool.check_invariants()


def test_capture_while_a_dead_engine_awaits_collection(cuda):
    """A graphed engine left in a dead reference cycle, then a new graphed
    engine built with the cycle collector running at nearly every
    allocation: the new engine's captures must not be broken by the old
    engine's graphs being destroyed mid-capture (CUDA refuses that; the
    capture collects first and keeps the collector off)."""
    import gc
    from repro_torch.serve import ServeEngine
    api, params, cfg, prompts = _graph_case("paged")
    old = ServeEngine(api, params, cfg)
    old.cycle = old
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = ServeEngine(api, params, cfg)
    finally:
        gc.set_threshold(*thresholds)
    assert eng.graphs.captured and eng.n_graphs == len(eng.graphs.keys)
    rids = [eng.submit(p, 9, arrival_step=2 * i).rid
            for i, p in enumerate(prompts)]
    outs = eng.run(max_steps=300)
    assert all(len(outs[r]) == 9 for r in rids)


def test_failed_capture_raises_without_fallback(cuda):
    """A ``decode_step`` that syncs with the host cannot be captured: the
    engine raises while it is built and never serves eagerly instead. In
    a process of its own, so that the failed capture leaves nothing
    behind in this one."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = """
import torch
from repro_torch.models import registry
from repro_torch.serve import EngineConfig, ServeEngine
api = registry.build("smollm-135m", smoke=True, device="cuda")
params = api.init(torch.Generator().manual_seed(0))

def syncing(params, cache, tokens, pos):
    tokens.sum().item()
    return api.decode_step(params, cache, tokens, pos)

try:
    ServeEngine(api._replace(decode_step=syncing), params, EngineConfig(
        max_batch=2, cache_len=32, block_tokens=4, hbm_blocks=6,
        device="cuda"))
except RuntimeError as exc:
    print("raised:", str(exc).splitlines()[0])
else:
    print("built")
"""
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("raised:"), out.stdout + out.stderr[-2000:]


# ---------------------------------------------------------------------------
# the tiered host pool and the fault layer on the card
# ---------------------------------------------------------------------------

def _tier_fault_run(api, params, prompts, graphs, plan, trace=None):
    """One SMOKE run on a ``ddr5:1,cxl:2`` host tier beside a KV-store
    tenant (its scopes prefer DDR5 and CXL, so blocks migrate), with a
    fault plan or without, under the sync watch. Returns the readings the
    graphed and eager runs must share, the engine, the static tensors
    before the run, and the sites of the syncs the run raised."""
    from repro_torch.core import faults as faults_lib
    from repro_torch.serve import EngineConfig, KVStoreTenant, ServeEngine
    fx = None if plan is None else faults_lib.FaultInjector(
        faults_lib.parse_fault_plan(plan), seed=5)
    eng = ServeEngine(api, params, EngineConfig(
        max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=10,
        pool_blocks=64, prefill_chunk=3, max_queue=16, megastep=4,
        pipeline_depth=2, tiers="ddr5:1,cxl:2", faults=fx, trace=trace,
        device="cuda"), _graphs=None if graphs else False)
    kv = eng.add_tenant(KVStoreTenant(n_slots=2, ops_per_step=2,
                                      store_blocks=12))
    kv.preload(12)
    kv.submit("gaussian", n_steps=24)
    kv.submit("sequential", n_steps=24, phase="read")
    reqs = [eng.submit(p, 9, arrival_step=2 * i)
            for i, p in enumerate(prompts)]
    static = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
              eng.pool.host_q, eng.pool.host_scale]
    ds.reset_launches()
    torch.cuda.synchronize()
    with sync_watch() as syncs:
        outs = eng.run(max_steps=400)
    torch.cuda.synchronize()
    readings = dict(
        served={i: outs[r.rid].tolist() for i, r in enumerate(reqs)
                if r.rid in outs},
        failed={i: r.error for i, r in enumerate(reqs)
                if r.rid in eng.failed},
        stats=eng.stats(), paging=eng.paging_stats(),
        ops=kv.ops_done, launches=dict(ds.LAUNCHES))
    return readings, eng, static, dict(syncs)


@pytest.mark.parametrize("plan", [
    None, "degrade:2@4+20=0.5,transient:1@6+40=0.4,poison:0@9,offline:2@14"])
def test_tiered_and_faulted_engines_graphed_equal_eager(cuda, plan):
    """Tiered placement, boundary migrations and (with a plan) every
    recoverable fault kind, graphed against eager on the card: the same
    survivors, failed records, stats and paging stats; survivors equal
    the static-batch oracle; the static tensors are the same objects
    after the run; and the graphed run raises no device-to-host sync."""
    from repro_torch.models import registry
    from repro_torch.serve import reference_decode
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 7)).astype(np.int32)
    eager, _, _, _ = _tier_fault_run(api, params, prompts, False, plan)
    graphed, eng, static, syncs = _tier_fault_run(api, params, prompts,
                                                  True, plan)
    assert graphed == eager
    assert syncs == {}
    now = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
           eng.pool.host_q, eng.pool.host_scale]
    assert all(a is b for a, b in zip(static, now))
    for lo in range(0, len(prompts), 3):
        want = reference_decode(api, params, prompts[lo:lo + 3], 9,
                                cache_len=64).cpu().numpy()
        for j in range(want.shape[0]):
            if lo + j in graphed["served"]:
                assert graphed["served"][lo + j] == want[j].tolist()
    tiers = graphed["paging"]["tiers"]
    assert tiers["tiered"] and tiers["migrations"] > 0
    assert graphed["launches"]["duplex_kv_stream"] > 0
    faults = graphed["stats"]["faults"]
    if plan is not None:
        assert faults["injected"] == 4 and faults["retried"] > 0
        assert faults["evacuated"] > 0
    eng.pool.check_invariants()


@pytest.mark.parametrize("plan", [
    None, "degrade:2@4+20=0.5,transient:1@6+40=0.4,poison:0@9,offline:2@14"])
def test_traced_graphed_engine_equals_untraced(cuda, plan):
    """The tracing plane on the graphed engine: the same readings (tokens,
    stats, paging, tier and fault stats, kernel launches) as untraced, no
    device-to-host sync, and channel tracks monotonic and disjoint."""
    from repro_torch.models import registry
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 7)).astype(np.int32)
    plain, _, _, _ = _tier_fault_run(api, params, prompts, True, plan)
    traced, eng, _, syncs = _tier_fault_run(api, params, prompts, True,
                                            plan, trace=True)
    assert traced == plain
    assert syncs == {}
    tr = eng.tracer
    assert {"plan", "dispatch", "reconcile"} <= {s[0] for s in tr.spans}
    for track, ivals in tr.timelines.items():
        end = -1.0
        for t0, dur, _, _ in ivals:
            assert t0 >= end - 1e-6, track
            end = t0 + dur
    if plan is not None:
        assert {"offline", "poison", "evacuation"} <= {
            i[2] for i in tr.instants if i[1] == "faults"}


def test_traced_engine_under_the_profiler(cuda):
    """A traced graphed engine served under the torch profiler: the same
    readings and device syncs (none) as an untraced one, each span and
    phase one ``engine/`` range on the host, inside the profiled window,
    and none of them on the device."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry
    from repro_torch.serve.trace import RANGE_PREFIX
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(
        0, api.cfg.vocab, (6, 7)).astype(np.int32)
    plain, _, _, plain_syncs = _tier_fault_run(api, params, prompts, True,
                                               None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, eng, _, syncs = _tier_fault_run(api, params, prompts, True,
                                                None, trace=True)
    assert traced == plain
    assert syncs == plain_syncs == {}
    res = prof.profiler.kineto_results
    events = [(e.name(), e.device_type(), e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in res.events()]
    ranges = [e for e in events if e[0].startswith(RANGE_PREFIX)]
    assert not [e for e in ranges if e[1] == DeviceType.CUDA]
    tr = eng.tracer
    assert Counter(e[0] for e in ranges) == Counter(
        RANGE_PREFIX + name for name, *_ in tr.spans + tr.phases)
    lo = res.trace_start_ns()
    hi = max(e[3] for e in events if not e[0].startswith(RANGE_PREFIX))
    assert all(lo <= e[2] <= e[3] <= hi for e in ranges)
    assert sum(e[1] == DeviceType.CUDA for e in events) > 0


# the CPU tests' tolerances (tests/test_torch_scheduler.py, which says why)
SIM_SUMMARY_RTOL, SIM_LOCKSTEP_RTOL = 1e-5, 5e-4


@pytest.mark.parametrize("case,policy", [
    ("decode", "hinted"), ("phased", "timeseries"), ("ddr5", "cfs"),
    ("open-loop", "threshold")])
def test_simulator_on_the_card(cuda, case, policy):
    """The simulator on the card: its step graphs equal its eager steps
    bit for bit, raise no device-to-host sync, and agree with the CPU."""
    from repro_torch.core import channel as ch
    from repro_torch.core import scheduler as sched
    from repro_torch.core.requests import StreamSpec
    from repro_torch.device import sync_watch
    sim = sched.SimConfig(steps=256, sequential=case == "phased",
                          closed_loop=case != "open-loop")
    if case == "phased":
        specs = [StreamSpec(name=f"p{i}", pattern="phased",
                            offered_gbps=8.0, read_fraction=0.5,
                            phase_steps=64, sequential=True)
                 for i in range(8)]
    else:
        specs = [StreamSpec(name=f"l{i}", pattern="llm_decode",
                            offered_gbps=15.0, phase_steps=32)
                 for i in range(8)]
    channel = ch.DDR5_LOCAL if case == "ddr5" else ch.CXL_512
    with sync_watch() as syncs:
        graphed = sched.simulate(channel, specs, policy, sim=sim)
    assert syncs == {}
    assert graphed.moved_read.device.type == "cuda"
    eager = sched.simulate(channel, specs, policy, sim=sim, _graphs=False)
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    cpu = sched.simulate(channel, specs, policy, sim=sim, device="cpu")
    got, want = sched.summarize(graphed), sched.summarize(cpu)
    lockstep = case == "phased"
    rtol = SIM_LOCKSTEP_RTOL if lockstep else SIM_SUMMARY_RTOL
    assert got["switches"] == want["switches"]
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=rtol, abs=1e-9), key
    if not lockstep:
        assert torch.equal(graphed.weights.cpu(), cpu.weights)


# ---------------------------------------------------------------------------
# crash-consistent snapshots and restore on the card
# ---------------------------------------------------------------------------

def _snap_engine(api, params, d, plan, graphs=True):
    from repro_torch.core import faults as faults_lib
    from repro_torch.serve import EngineConfig, ServeEngine
    fx = faults_lib.FaultInjector(
        faults_lib.parse_fault_plan(plan) if plan else [])
    return ServeEngine(api, params, EngineConfig(
        max_batch=3, cache_len=64, block_tokens=4, hbm_blocks=6,
        prefill_chunk=3, max_queue=8, megastep=4, pipeline_depth=2,
        faults=fx, snapshot_every=2, snapshot_dir=str(d), device="cuda"),
        _graphs=None if graphs else False)


def _snap_signature(eng):
    done = sorted(eng.completed)
    ps = eng.paging_stats()
    return ([eng.completed[r].generated for r in done],
            [(eng.completed[r].admitted_step, eng.completed[r].done_step)
             for r in done],
            {k: ps[k] for k in ("duplex_us", "serial_us", "page_ins",
                                "page_outs", "kernel_calls", "by_path")},
            dict(eng.stats()["faults"]))


def test_crash_restore_on_the_card(cuda, tmp_path):
    """SMOKE smollm-135m on the step graphs with a cut every 2 megasteps:
    a run killed by ``crash:@9`` at depth 2 (a megastep in flight) and
    restored into a fresh graphed engine gives the uncrashed run's
    tokens, timing, billing and fault stats; the cuts launch the CUDA
    ``quant_stream`` for their flushes; the restore writes the static
    tensors in place; the pool's final bytes equal the uncrashed run's;
    and outside the snapshot module, the checkpoint writer and the pool's
    state copies the host never syncs."""
    import inspect

    from repro_torch.checkpoint import sharded
    from repro_torch.core.faults import CrashFault
    from repro_torch.models import registry
    from repro_torch.serve import kv_pool, snapshot
    api = registry.build("smollm-135m", smoke=True, device="cuda")
    params = api.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(77).integers(
        0, api.cfg.vocab, (4, 6)).astype(np.int32)

    def submit(eng):
        for i in range(4):
            eng.submit(prompts[i], 10, arrival_step=2 * i)

    def allowed(site):
        name, _, line = site.split(" < ")[0].partition(":")
        spans = {"snapshot.py": [snapshot], "sharded.py": [sharded],
                 "kv_pool.py": [kv_pool.PagedKVPool.snapshot_state,
                                kv_pool.PagedKVPool.load_state]}
        for obj in spans.get(name, []):
            src, first = inspect.getsourcelines(obj)
            if first <= int(line) < first + len(src):
                return True
        return False

    ref = _snap_engine(api, params, tmp_path / "ref", None)
    submit(ref)
    ds.reset_launches()
    with sync_watch() as syncs:
        ref.run(max_steps=600)
    assert all(allowed(s) for s in syncs), dict(syncs)
    assert ds.LAUNCHES["quant_stream"] >= 1
    assert ref.stats()["snapshot"]["snapshots_taken"] > 0
    want = _snap_signature(ref)
    final = [t.clone() for t in (ref.pool.hbm, ref.pool.host_q,
                                 ref.pool.host_scale)]

    dead = _snap_engine(api, params, tmp_path / "crash", "crash:@9")
    submit(dead)
    with pytest.raises(CrashFault):
        dead.run(max_steps=600)
    torch.cuda.synchronize()
    del dead

    eng = _snap_engine(api, params, tmp_path / "crash", "crash:@9")
    static = [*eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
              eng.pool.host_q, eng.pool.host_scale]
    with sync_watch() as syncs:
        info = eng.restore()
        eng.run(max_steps=600)
    torch.cuda.synchronize()
    assert info["restored_step"] > 0
    assert all(allowed(s) for s in syncs), dict(syncs)
    assert _snap_signature(eng) == want
    assert all(a is b for a, b in zip(static, [
        *eng._dev.values(), *eng.cache.values(), eng.pool.hbm,
        eng.pool.host_q, eng.pool.host_scale]))
    for a, b in zip((eng.pool.hbm, eng.pool.host_q, eng.pool.host_scale),
                    final):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)
    eng.pool.check_invariants()


def test_sharded_engine_on_the_card(cuda, monkeypatch):
    """SMOKE smollm-135m on a (2, 2) mesh of logical ranks on the card,
    each rank on its own step graphs, against the flat graphed engine:
    the same tokens and admission/done steps; the graphed sharded run
    equals the eager one in stats, paging stats (``ici`` among them) and
    kernel launches; no host sync but the readback, one per dispatched
    megastep; every rank within prefill_chunk + 1 graphs; ICI bytes on
    both axes; the pool shards' invariants hold."""
    import dataclasses

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import ServeEngine, ShardedServeEngine
    from repro_torch.serve import engine as engine_mod
    api, params, cfg, prompts = _graph_case("paged")
    # 4 HBM blocks: a shard of two rows pages both ways (with 6 it never
    # evicts: each shard gets the config's whole hbm_blocks)
    cfg = dataclasses.replace(cfg, max_batch=4, hbm_blocks=4)
    waits = [0]
    real = engine_mod._Readback.wait

    def counted(self):
        waits[0] += 1
        return real(self)

    monkeypatch.setattr(engine_mod._Readback, "wait", counted)

    def run(eng):
        rids = [eng.submit(p, 9, arrival_step=2 * i).rid
                for i, p in enumerate(prompts)]
        ds.reset_launches()
        waits[0] = 0
        with sync_watch() as syncs:
            outs = eng.run(max_steps=300)
        torch.cuda.synchronize()
        return dict(tokens=[outs[r].tolist() for r in rids],
                    timing=[(eng.completed[r].admitted_step,
                             eng.completed[r].done_step) for r in rids],
                    stats=eng.stats(), paging=eng.paging_stats(),
                    launches=dict(ds.LAUNCHES), syncs=dict(syncs),
                    waits=waits[0])

    flat = run(ServeEngine(api, params, cfg))
    mesh = make_debug_mesh(2, devices=[torch.device("cuda", 0)] * 4)
    graphed_eng = ShardedServeEngine(api, params, cfg, mesh=mesh)
    graphed = run(graphed_eng)
    eager = run(ShardedServeEngine(api, params, cfg, mesh=mesh,
                                   _graphs=False))
    assert graphed["tokens"] == flat["tokens"]
    assert graphed["timing"] == flat["timing"]
    for key in ("tokens", "timing", "stats", "paging", "launches", "waits"):
        assert eager[key] == graphed[key], key
    assert graphed["syncs"] == {}
    assert graphed["waits"] == graphed["stats"]["host_dispatches"]
    assert all(0 < len(rk.graphs) <= cfg.prefill_chunk + 1
               for rk in graphed_eng.ranks)
    paths = graphed["paging"]["by_path"]
    assert paths["/serve/ici/model"]["bytes"] > 0
    assert paths["/serve/ici/data"]["bytes"] > 0
    assert graphed["launches"]["duplex_kv_stream"] > 0
    graphed_eng.pool.check_invariants()


def _wkv_grad_inputs(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    B, S, H, hs = shape
    r, k, v, n, d = (torch.randn(shape, generator=g) for _ in range(5))
    w = torch.exp(-torch.exp(-1.0 + n))
    u = 0.5 * torch.randn((H, hs), generator=g)
    return [x.to(device) for x in (r, k, v, w, u, d)]


@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (1, 77, 2, 16),
                                   (1, 100, 2, 128), (2, 33, 2, 32),
                                   (1, 1, 1, 64), (1, 7, 2, 64),
                                   (1, 64, 2, 64), (2, 65, 2, 64),
                                   (1, 137, 2, 64), (1, 203, 2, 16),
                                   (1, 203, 1, 128)])
def test_wkv6_backward_matches_plain_version(cuda, shape):
    """The backward kernel against ``ref.wkv6_backward``, each gradient
    within 1e-4 of its largest magnitude: ragged S, no multiple of the
    kernel's 64-step segment or 8-step sub-chunk; S = 1; one sub-chunk
    less a step; one segment and a step more; a last segment of two
    sub-chunks (137), whose successor's checkpoint takes a slot the last
    never uses; hs 16 and 128 (four slices of rows) at S = 203."""
    from repro_torch.kernels import rwkv6_scan as rs
    x = _wkv_grad_inputs(shape, sum(shape), cuda)
    before = rs.LAUNCHES["wkv6_backward"]
    got = rs.wkv6_backward(*x)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["wkv6_backward"] == before + 1
    want = ref.wkv6_backward(*x)
    for name, a, b in zip("r k v w u".split(), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-4 * scale, name


def test_wkv6_function_through_the_kernels(cuda):
    """Under autograd ``ops.wkv6`` runs the forward and the backward
    kernel once each, with the plain loop's gradients; under no_grad
    only the forward kernel."""
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.models.rwkv6 import wkv_scan
    x = _wkv_grad_inputs((2, 64, 2, 64), 5, cuda)
    leaves = [t.clone().requires_grad_(True) for t in x[:5]]
    rs.reset_launches()
    out = ops.wkv6(*leaves, chunk=64)
    got = torch.autograd.grad(out, leaves, x[5])
    assert rs.LAUNCHES == {"wkv6": 1, "wkv6_backward": 1}
    plain = [t.clone().requires_grad_(True) for t in x[:5]]
    want = torch.autograd.grad(wkv_scan(*plain)[0], plain, x[5])
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    with torch.no_grad():
        ops.wkv6(*leaves, chunk=64)
    assert rs.LAUNCHES == {"wkv6": 2, "wkv6_backward": 1}


def test_wkv6_backward_geometry_on_the_card(cuda):
    """The kernel's own geometry (``wkv6_backward_geometry``, from its
    ``BwdShape``) is the one the wrapper budgets and sizes its scratch
    by (``rwkv6_scan.backward_geometry``), within the card's 227 KB."""
    import ctypes

    from repro_torch.kernels import rwkv6_scan as rs
    lib = rs._load()
    keys = ("threads", "rows", "cols", "sub", "seg", "slices", "stages",
            "smem_bytes")
    for hs in rs.HEAD_SIZES:
        buf = (ctypes.c_longlong * len(keys))()
        assert lib.wkv6_backward_geometry(hs, buf) == 0
        want = rs.backward_geometry(hs)
        assert dict(zip(keys, buf)) == {k: want[k] for k in keys}
        assert want["smem_bytes"] <= rs.SMEM_LIMIT
    assert lib.wkv6_backward_geometry(48, buf) != 0


def test_wkv6_function_across_segments(cuda):
    """``ops.wkv6`` under autograd over three segments of the backward
    (S = 192), called twice as two layers would be: one ``wkv6_backward``
    launch a call, and within 1e-4 of the plain loop's gradients."""
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.models.rwkv6 import wkv_scan
    x = _wkv_grad_inputs((2, 192, 2, 64), 11, cuda)
    leaves = [t.clone().requires_grad_(True) for t in x[:5]]
    rs.reset_launches()
    out = ops.wkv6(*leaves, chunk=64)
    out = ops.wkv6(out, *leaves[1:], chunk=64)
    got = torch.autograd.grad(out, leaves, x[5])
    assert rs.LAUNCHES == {"wkv6": 2, "wkv6_backward": 2}
    plain = [t.clone().requires_grad_(True) for t in x[:5]]
    mid = wkv_scan(*plain)[0]
    want = torch.autograd.grad(wkv_scan(mid, *plain[1:])[0], plain, x[5])
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):

    """No silent gradient: every kernel wrapper raises when autograd
    would record it, on CUDA tensors too."""
    from repro_torch.kernels import rwkv6_scan as rs
    q = torch.randn((1, 16, 2, 64), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn((1, 16, 1, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        fa.flash_attention(q, kv, kv)
    x = torch.randn((1, 16, 32), device=cuda).to(torch.bfloat16)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="quant_stream has no backward"):
        ds.quant_stream(x)
    qs = torch.randn((2, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="l2_distance has no backward"):
        vd.l2_distance(qs, x.detach())
    r = torch.rand((1, 16, 1, 16), device=cuda, requires_grad=True)
    u = torch.rand((1, 16), device=cuda)
    with pytest.raises(RuntimeError, match="wkv6 has no backward"):
        rs.wkv6(r, r.detach(), r.detach(), r.detach(), u)


def test_moe_train_step_on_the_card(cuda):
    """One ``make_train_step`` of mixtral-8x7b SMOKE on the card: every
    leaf gets a finite gradient (the expert products go through
    ``layers._BmmF32``: autograd has no derivative of ``torch.bmm`` with
    ``out_dtype``), and the step moves the parameters."""
    from repro_torch.launch.steps import make_grads_step, make_train_step
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    api = registry.build("mixtral-8x7b", smoke=True, device="cuda")
    params = api.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, api.cfg.vocab, (2, 16)))
             .to(cuda) for k in ("tokens", "labels")}
    grads, metrics = make_grads_step(api)(params, batch)
    assert torch.isfinite(metrics["loss"])
    for g in nn.tree_leaves(grads):
        assert torch.isfinite(g.float()).all()
    assert grads["layers"]["moe"]["w_gate"].abs().max() > 0
    new, state, m = make_train_step(api)(params, adamw_init(params), batch)
    assert int(state["step"]) == 1 and torch.isfinite(m["grad_norm"])
    assert not torch.equal(new["layers"]["moe"]["w_up"],
                           params["layers"]["moe"]["w_up"])


def test_rwkv_train_step_reaches_every_leaf_on_the_card(cuda):
    """rwkv6-7b SMOKE's gradient on the card through the wkv6 kernels:
    every leaf finite and not all zero, each of ``mu``'s five rows too,
    and within 1e-3 of each leaf's largest magnitude of the gradient
    through the plain loop (f32 weights, TF32 off)."""
    import dataclasses

    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    from repro_torch.models import registry
    from repro_torch.models import rwkv6 as W
    torch.backends.cuda.matmul.allow_tf32 = False
    api = registry.build("rwkv6-7b", smoke=True, device="cuda")
    cfg = dataclasses.replace(api.cfg, dtype=torch.float32)
    api = registry._rwkv_api("rwkv6-7b", cfg, "cuda")
    params = api.init(torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
             .to(cuda) for k in ("tokens", "labels")}
    rs.reset_launches()
    _, _, got = value_and_grad(api.loss_fn, params, batch, torch.float32)
    assert rs.LAUNCHES == {"wkv6": cfg.num_layers,
                           "wkv6_backward": cfg.num_layers}
    plain = lambda p, b: (nn.cross_entropy(W.forward(
        p, cfg, b["tokens"], use_kernel=False)[0], b["labels"]), {})
    _, _, want = value_and_grad(plain, params, batch, torch.float32)
    for a, b in zip(nn.tree_leaves(got), nn.tree_leaves(want)):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
    mu = got["layers"]["tm"]["mu"]
    assert (mu.abs().amax(dim=(0, 2)) > 0).all()


def test_wkv6_ops_fake_shapes_and_flops_equal_the_kernels(cuda):
    """The ``repro_torch::wkv6`` / ``wkv6_backward`` ops on the card: the
    fake implementations give the kernels' output shapes and dtypes, and
    ``FlopCounterMode`` counts each op's formula once per call, the same
    count as on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import rwkv6_scan as rs
    shape = (2, 200, 3, 64)
    x = _wkv_grad_inputs(shape, 11, cuda)
    rs.reset_launches()
    with FlopCounterMode(display=False) as fc:
        out = torch.ops.repro_torch.wkv6(*x[:5])
        grads = torch.ops.repro_torch.wkv6_backward(*x)
    torch.cuda.synchronize()
    assert rs.LAUNCHES == {"wkv6": 1, "wkv6_backward": 1}
    want = ops.wkv6_flops(*shape) + ops.wkv6_backward_flops(*shape)
    assert fc.get_total_flops() == want
    with FakeTensorMode() as mode:
        fx = [mode.from_tensor(t) for t in x]
        with FlopCounterMode(display=False) as ffc:
            fout = torch.ops.repro_torch.wkv6(*fx[:5])
            fgrads = torch.ops.repro_torch.wkv6_backward(*fx)
    assert ffc.get_total_flops() == want
    for a, b in zip((fout, *fgrads), (out, *grads)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.device == b.device


def test_remat_keeps_rwkv6_gradients_and_recomputes_wkv6(cuda, monkeypatch):
    """rwkv6-7b SMOKE in f32 on the card with ``runconfig``'s remat and
    without: every gradient leaf within 1e-6 of its largest magnitude of
    the other's (the recompute launches the same kernel on the same
    inputs); ``wkv6`` launched 2 x layers with remat and layers without,
    ``wkv6_backward`` layers both ways (``chip_smoke.remat_on_card``'s
    gates)."""
    import dataclasses

    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import layers as nn
    from repro_torch.models import registry, runconfig
    # TF32 off for this test only (monkeypatch puts the setting back)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    api = registry.build("rwkv6-7b", smoke=True, device="cuda")
    cfg = dataclasses.replace(api.cfg, dtype=torch.float32)
    api = registry._rwkv_api("rwkv6-7b", cfg, "cuda")
    L = cfg.num_layers
    params = api.init(torch.Generator("cuda").manual_seed(4))
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             .to(cuda) for k in ("tokens", "labels")}
    got = {}
    for remat in (True, False):
        rs.reset_launches()
        with runconfig.options(remat=remat):
            _, _, grads = value_and_grad(api.loss_fn, params, batch,
                                         torch.float32)
        torch.cuda.synchronize()
        got[remat] = (grads, dict(rs.LAUNCHES))
    assert got[True][1] == {"wkv6": 2 * L, "wkv6_backward": L}
    assert got[False][1] == {"wkv6": L, "wkv6_backward": L}
    for a, b in zip(nn.tree_leaves(got[True][0]),
                    nn.tree_leaves(got[False][0])):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
