"""Public entry points for the port's kernels.

Mirror of ``repro/kernels/ops.py``. Each dispatches on the device of the
tensors it is given: a CPU tensor goes to the plain version in
``kernels/ref.py``; any other tensor goes to the CUDA kernel in
``kernels/duplex_stream.py``, ``kernels/vector_distance.py``,
``kernels/flash_attention.py`` or ``kernels/rwkv6_scan.py``, which
launches or raises. There is no
fallback from the kernel to the plain version. ``wkv6`` is the one
kernel with a gradient: under autograd on a CUDA tensor it goes through
``WKV6Function``, whose backward is the CUDA ``wkv6_backward``. Both are
``torch.library`` custom ops (``repro_torch::wkv6``,
``repro_torch::wkv6_backward``) with fake shapes, a FLOP formula that
``torch.utils.flop_counter`` counts whatever implements the op, and a
DTensor sharding rule (``register_sharding_rules``), so the dry-run
traces the recurrence as one op a layer.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import duplex_stream as _ds
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rs
from repro_torch.kernels import vector_distance as _vd


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def duplex_kv_stream(in_q, in_scale, out_x, *, fused: bool = True,
                     stage_blocks: int = 1):
    """Fused duplex page-in/page-out transform.

    ``fused=False`` runs the phase-separated baseline: the two
    single-direction kernels back to back (identical math). ``N`` must be
    a multiple of ``stage_blocks``, the pool's staging depth (callers pad
    the streams with zero pages)."""
    N = in_q.shape[0]
    if N % stage_blocks:
        raise ValueError(
            f"duplex stream length {N} is not a multiple of the staging "
            f"depth {stage_blocks}; pad the streams")
    if _on_cpu(in_q):
        return ref.duplex_kv_stream(in_q, in_scale, out_x)
    if fused:
        return _ds.duplex_kv_stream(in_q, in_scale, out_x)
    in_deq = _ds.dequant_stream(in_q, in_scale)
    out_q, out_scale = _ds.quant_stream(out_x)
    return in_deq, out_q, out_scale


def dequant_kv_stream(in_q, in_scale):
    """Single-direction page-in transform (no page-out stream to fuse)."""
    if _on_cpu(in_q):
        return ref.dequantize_int8(in_q, in_scale)
    return _ds.dequant_stream(in_q, in_scale)


def quant_kv_stream(out_x):
    """Single-direction page-out transform (no page-in stream to fuse)."""
    if _on_cpu(out_x):
        return ref.quantize_int8(out_x)
    return _ds.quant_stream(out_x)


def l2_distance(queries, blocks):
    """Batched query-to-block squared L2 distances (vector-search tenant):
    queries (Q, D), blocks (N, T, D) bf16 -> (N, Q, T) f32."""
    if _on_cpu(queries):
        return ref.l2_distance(queries, blocks)
    return _vd.l2_distance(queries, blocks)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, prefix_len: int = 0,
                    q_block: int = 128, kv_block: int = 128):
    """Blockwise attention. q: (B, S, H, hd); k, v: (B, S, KV, hd) ->
    (B, S, H, hd). ``q_block``/``kv_block`` are the reference's
    divisibility contract, checked on every device so the CPU and the
    card refuse the same shapes; the CUDA kernel picks its own tiles."""
    S = q.shape[1]
    qb, kb = min(q_block, S), min(kv_block, S)
    if S % qb or S % kb:
        raise ValueError(f"S={S} must be divisible by blocks ({qb},{kb})")
    if _on_cpu(q):
        return ref.attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)


# ---------------------------------------------------------------------------
# wkv6 and wkv6_backward as torch.library custom ops
# ---------------------------------------------------------------------------

def _traced(t) -> bool:
    """A DTensor or a fake tensor (a dry-run's, or any ``FakeTensorMode``'s):
    shapes flow through, and the recurrence is one op, not S Python
    steps."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(t):
        return True
    if type(t).__name__ == "DTensor":
        from torch.distributed.tensor import DTensor
        return isinstance(t, DTensor)
    return False


@torch.library.custom_op("repro_torch::wkv6", mutates_args=(),
                         device_types=("cpu", "cuda"))
def wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The recurrence as an op: the plain version for a CPU tensor, the
    CUDA kernel (``rwkv6_scan.wkv6``) for a CUDA one."""
    if _on_cpu(r):
        return ref.wkv6(r, k, v, w, u)[0]
    return _rs.wkv6(r, k, v, w, u)


@wkv6_op.register_fake
def _wkv6_fake(r, k, v, w, u):
    return torch.empty_like(r)


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=(),
                         device_types=("cpu", "cuda"))
def wkv6_backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, dout: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """The gradient (dr, dk, dv, dw, du): the plain version for a CPU
    tensor, the CUDA kernel (``rwkv6_scan.wkv6_backward``) for a CUDA
    one."""
    if _on_cpu(r):
        return tuple(ref.wkv6_backward(r, k, v, w, u, dout))
    return tuple(_rs.wkv6_backward(r, k, v, w, u, dout))


@wkv6_backward_op.register_fake
def _wkv6_backward_fake(r, k, v, w, u, dout):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u))


def wkv6_flops(B: int, S: int, H: int, hs: int) -> int:
    """f32 operations of the forward recurrence: 5 hs^2 + 5 hs a (b, t,
    h) (the state update, the output's sums and the bonus term)."""
    return (5 * hs * hs + 5 * hs) * B * S * H


def wkv6_backward_flops(B: int, S: int, H: int, hs: int) -> int:
    """f32 operations of its gradient: 14 hs^2 + 16 hs a (b, t, h)."""
    return (14 * hs * hs + 16 * hs) * B * S * H


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _wkv6_flop_formula(r_shape, *_args, out_shape=None, **_kw):
    return wkv6_flops(*r_shape)


@register_flop_formula(torch.ops.repro_torch.wkv6_backward)
def _wkv6_backward_flop_formula(r_shape, *_args, out_shape=None, **_kw):
    return wkv6_backward_flops(*r_shape)


_SHARDING_RULES = []


def register_sharding_rules() -> None:
    """Give DTensor its rules for the repo's custom ops (``wkv6``,
    ``wkv6_backward``, ``models.ssm``'s ``ssd_scan`` pair): batch over
    the data axes, heads over the tensor axis, or replicated. Called by
    the dry-run before it distributes anything (importing
    ``torch.distributed.tensor`` costs seconds, so ``ops`` does not do it
    at import); idempotent."""
    if _SHARDING_RULES:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R, P = Replicate(), Partial()
    S0, S2 = Shard(0), Shard(2)

    @register_sharding(torch.ops.repro_torch.wkv6.default)
    def _wkv6_rule(r, k, v, w, u):
        return [([R], [R] * 5),
                ([S0], [S0] * 4 + [R]),
                ([S2], [S2] * 4 + [S0])]

    @register_sharding(torch.ops.repro_torch.wkv6_backward.default)
    def _wkv6_backward_rule(r, k, v, w, u, dout):
        return [([R] * 5, [R] * 6),
                ([S0] * 4 + [P], [S0] * 4 + [R, S0]),
                ([S2] * 4 + [S0], [S2] * 4 + [S0, S2])]

    from repro_torch.models import ssm
    ssm.register_sharding_rules(register_sharding)
    _SHARDING_RULES.append(True)


class WKV6Function(torch.autograd.Function):
    """``wkv6`` with its gradient: the ``repro_torch::wkv6`` op forward
    and the ``repro_torch::wkv6_backward`` op backward (on a CUDA tensor
    the two CUDA kernels, on the CPU their plain versions ``ref.wkv6`` /
    ``ref.wkv6_backward``, on a DTensor or a fake tensor their sharding
    rules and fake shapes). Saves r, k, v, w, u. Inputs f32 (B, S, H, hs)
    and u (H, hs), contiguous."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return torch.ops.repro_torch.wkv6(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dout):
        r, k, v, w, u = ctx.saved_tensors
        dout = dout.float().contiguous()
        return torch.ops.repro_torch.wkv6_backward(r, k, v, w, u, dout)


def wkv6(r, k, v, w, u, *, chunk: int = 128):
    """The WKV6 recurrence from a zero state. r, k, v, w: (B, S, H, hs)
    (w in (0, 1)); u: (H, hs) -> out (B, S, H, hs) f32. ``chunk`` is the
    reference's divisibility contract (``S % min(chunk, S) == 0``),
    checked on every device; the CUDA kernel has no such limit and walks
    time in its own chunks. Inputs are taken in f32, as the reference's
    kernel upcasts them.

    A real CPU tensor runs the plain loop, which autograd differentiates
    itself (the gradients the CPU tests hold against ``jax.grad``). A
    CUDA tensor, a DTensor or a fake tensor goes through the
    ``repro_torch::wkv6`` op: through ``WKV6Function`` when autograd
    records the call (grad mode on, an input that requires grad), so its
    backward is the ``wkv6_backward`` op, else straight to the op, and
    nothing is saved."""
    S = r.shape[1]
    ch = min(chunk, S)
    if S % ch:
        raise ValueError(f"S={S} must be divisible by chunk={ch}")
    r, k, v, w, u = (t.float().contiguous() for t in (r, k, v, w, u))
    if _on_cpu(r) and not _traced(r):
        return ref.wkv6(r, k, v, w, u)[0]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return WKV6Function.apply(r, k, v, w, u)
    return torch.ops.repro_torch.wkv6(r, k, v, w, u)
