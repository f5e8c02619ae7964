"""Mamba2 (SSD) block — the state-space substrate of zamba2-7b: the port
of ``repro/models/ssm.py``.

Per-head scalar decay A, input-dependent (dt, B, C) with a
softplus-discretized dt, a short causal depthwise conv on the input
stream, SiLU gating, grouped B/C. State h in R^{heads x head_dim x N}.

The time recurrence is a Python loop over the sequence in f32 (the
reference's ``lax.scan``) for the full sequence, and one O(1) state update
at decode. No Pallas kernel is on this path in the reference, so none is
here; the dry-run traces the loop as one ``repro_torch::ssd_scan`` op
(``_ssd_scan``).

``mamba2_apply`` with a cache returns new ``conv`` and ``ssm`` leaves and
never writes its input: the serving engine keeps the rows that did not
move.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.models import layers as nn


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64          # N
    head_dim: int = 64         # P
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_out(self) -> int:
        return (2 * self.d_inner + 2 * self.n_groups * self.d_state
                + self.num_heads)


def mamba2_init(generator: torch.Generator, spec: Mamba2Spec,
                lead: tuple = ()) -> dict:
    """Random weights with the reference's distributions, stacked over
    ``lead``, drawn on the generator's device: projections N(0, 1/fan_in),
    conv taps 0.1 N(0, 1), conv bias 0, ``A_log`` log(linspace(1, 16, H)),
    ``dt_bias`` 0 and ``D`` 1 (those three in f32 whatever ``spec.dtype``
    is), norm scale 1."""
    g = generator
    d, di, H, dt = spec.d_model, spec.d_inner, spec.num_heads, spec.dtype
    K, C = spec.conv_width, spec.conv_dim

    def per_head(values):
        return values.expand(*lead, H).clone()

    return {
        "in_proj": nn.dense_init(g, lead, d, spec.proj_out, dt),
        "conv_w": (0.1 * torch.randn((*lead, K, C), generator=g,
                                     device=g.device)).to(dt),
        "conv_b": torch.zeros((*lead, C), dtype=dt),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H))),
        "dt_bias": per_head(torch.zeros(H)),
        "D": per_head(torch.ones(H)),
        "norm": nn.rmsnorm_init(lead, di, dt),
        "out_proj": nn.dense_init(g, lead, di, d, dt),
    }


def mamba2_param_count(spec: Mamba2Spec) -> int:
    d, di, H = spec.d_model, spec.d_inner, spec.num_heads
    return (d * spec.proj_out + spec.conv_width * spec.conv_dim
            + spec.conv_dim + 3 * H + di + di * d)


def _causal_conv(x, w, b, last_window=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); last_window:
    (B, K-1, C). The taps are summed in ``x.dtype`` in order of i, as the
    reference's Python ``sum``. Returns (out, the new window)."""
    K = w.shape[0]
    if last_window is None:
        pad = torch.zeros_like(x[:, :K - 1])
    else:
        pad = last_window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, C)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return out + b, xp[:, -(K - 1):]


def _split_proj(spec: Mamba2Spec, proj):
    di, G, N = spec.d_inner, spec.n_groups, spec.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * G * N]
    dt = proj[..., di + di + 2 * G * N:]
    return z, xbc, dt


def _ssd_loop(xh, Bmat, Cmat, dt, A_log, D, h):
    """The SSD recurrence from state ``h``, a loop over time in f32."""
    S, H = xh.shape[1], xh.shape[2]
    rep = H // Bmat.shape[2]
    A = -torch.exp(A_log)                            # (H,) negative
    x, Bf, Cf = xh.float(), Bmat.float(), Cmat.float()
    ys = []
    for t in range(S):
        x_t, dt_t = x[:, t], dt[:, t]                # (B,H,P), (B,H)
        decay = torch.exp(dt_t * A)
        # jnp.repeat along an axis repeats each element: repeat_interleave
        Bh = torch.repeat_interleave(Bf[:, t], rep, dim=1)   # (B,H,N)
        Ch = torch.repeat_interleave(Cf[:, t], rep, dim=1)
        upd = dt_t[..., None, None] * x_t[..., :, None] * Bh[..., None, :]
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch) + D[None, :, None]
                  * x_t)
    return torch.stack(ys, dim=1), h


def _ssd_scan(spec: Mamba2Spec, xh, Bmat, Cmat, dt, A_log, D, state=None):
    """The SSD recurrence, a loop over time in f32.

    xh: (B, S, H, P); Bmat/Cmat: (B, S, G, N); dt: (B, S, H) post-softplus.
    h <- exp(dt*A)*h + dt*(x (x) B);  y = h.C + D*x. Returns (y (B, S, H,
    P), the final state (B, H, P, N)).

    A real tensor runs the loop itself (its numerics and autograd are the
    model's). A DTensor or a fake tensor (the dry-run) goes through the
    ``repro_torch::ssd_scan`` op instead: one op a layer with fake
    shapes, a FLOP formula, a backward op and a DTensor sharding rule,
    where the loop would take S Python steps of DTensor dispatch (hours
    at ``prefill_32k``). The op's real implementation is the same loop,
    and its backward the loop's vector-Jacobian product."""
    h = state
    if h is None:
        h = torch.zeros((xh.shape[0], xh.shape[2], xh.shape[3],
                         spec.d_state), dtype=torch.float32,
                        device=xh.device)
    from repro_torch.kernels.ops import _traced
    if _traced(xh):
        return torch.ops.repro_torch.ssd_scan(xh, Bmat, Cmat, dt, A_log, D,
                                              h)
    return _ssd_loop(xh, Bmat, Cmat, dt, A_log, D, h)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _ssd_scan_op(xh: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                 dt: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                 state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    y, h = _ssd_loop(xh, Bmat, Cmat, dt, A_log, D, state)
    return y, h.clone() if h is state else h


@_ssd_scan_op.register_fake
def _ssd_scan_fake(xh, Bmat, Cmat, dt, A_log, D, state):
    return (xh.new_empty(xh.shape, dtype=torch.float32),
            torch.empty_like(state))


@torch.library.custom_op("repro_torch::ssd_scan_backward", mutates_args=())
def _ssd_scan_backward_op(
        xh: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
        dt: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
        state: torch.Tensor, dy: torch.Tensor, dh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor]:
    _, vjp = torch.func.vjp(_ssd_loop, xh, Bmat, Cmat, dt, A_log, D, state)
    return vjp((dy, dh))


@_ssd_scan_backward_op.register_fake
def _ssd_scan_backward_fake(xh, Bmat, Cmat, dt, A_log, D, state, dy, dh):
    return tuple(torch.empty_like(t)
                 for t in (xh, Bmat, Cmat, dt, A_log, D, state))


def _ssd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ssd_backward(ctx, dy, dh):
    saved = ctx.saved_tensors
    y_like = saved[0].new_empty(saved[0].shape, dtype=torch.float32)
    dy = torch.zeros_like(y_like) if dy is None else dy
    dh = torch.zeros_like(saved[6]) if dh is None else dh
    return torch.ops.repro_torch.ssd_scan_backward(*saved, dy, dh)


torch.library.register_autograd("repro_torch::ssd_scan", _ssd_backward,
                                setup_context=_ssd_setup)


def ssd_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """Operations of the recurrence: 6 per state element a step (decay,
    the two products and the sum of the update, and the read-out's
    product and sum) and 2 per output element (the skip)."""
    return (6 * N + 2) * B * S * H * P


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flop_formula(x_shape, *args, out_shape=None, **_kw):
    return ssd_flops(*x_shape, args[5][-1])


@register_flop_formula(torch.ops.repro_torch.ssd_scan_backward)
def _ssd_backward_flop_formula(x_shape, *args, out_shape=None, **_kw):
    # twice the forward's: every product of the forward has two partials
    return 2 * ssd_flops(*x_shape, args[5][-1])


def register_sharding_rules(register_sharding) -> None:
    """DTensor rules for the ``ssd_scan`` pair (``kernels.ops.
    register_sharding_rules`` calls this): batch over the data axes, or
    heads over the tensor axis when B and C have one group (every head
    reads them whole), or replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    R, P = Replicate(), Partial()
    S0, S1, S2 = Shard(0), Shard(1), Shard(2)

    @register_sharding(torch.ops.repro_torch.ssd_scan.default)
    def _fwd(xh, Bmat, Cmat, dt, A_log, D, state):
        rules = [([R, R], [R] * 7),
                 ([S0, S0], [S0] * 4 + [R, R, S0])]
        if Bmat.shape[2] == 1:
            rules.append(([S2, S1], [S2, R, R, S2, S0, S0, S1]))
        return rules

    @register_sharding(torch.ops.repro_torch.ssd_scan_backward.default)
    def _bwd(xh, Bmat, Cmat, dt, A_log, D, state, dy, dh):
        rules = [([R] * 7, [R] * 9),
                 ([S0] * 4 + [P, P, S0], [S0] * 4 + [R, R, S0, S0, S0])]
        if Bmat.shape[2] == 1:
            rules.append(([S2, P, P, S2, S0, S0, S1],
                          [S2, R, R, S2, S0, S0, S1, S2, S1]))
        return rules


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_apply(params, x, spec: Mamba2Spec, cache=None):
    """x: (B, S, D) -> (B, S, D), new cache. ``cache`` = {"conv": (B, K-1,
    C), "ssm": (B, H, P, N)} for incremental decode (S=1), returned anew
    (the input is not written); None for the full sequence, and the new
    cache is then None."""
    B, S, _ = x.shape
    H, P, G, N = spec.num_heads, spec.head_dim, spec.n_groups, spec.d_state
    di = spec.d_inner
    proj = x @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(spec, proj)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 None if cache is None else cache["conv"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xh = xbc[..., :di].reshape(B, S, H, P)
    Bmat = xbc[..., di:di + G * N].reshape(B, S, G, N)
    Cmat = xbc[..., di + G * N:].reshape(B, S, G, N)
    dt = softplus(dt_raw.float() + params["dt_bias"])      # (B,S,H)
    y, new_ssm = _ssd_scan(spec, xh, Bmat, Cmat, dt, params["A_log"],
                           params["D"], None if cache is None
                           else cache["ssm"])
    y = y.reshape(B, S, di).to(x.dtype)
    y = nn.rmsnorm(params["norm"], y)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]
    if cache is None:
        return out, None
    return out, {"conv": new_conv, "ssm": new_ssm}


def mamba2_cache_init(spec: Mamba2Spec, batch: int, lead: tuple = (),
                      device: torch.device | str = "cpu") -> dict:
    return {
        "conv": torch.zeros((*lead, batch, spec.conv_width - 1,
                             spec.conv_dim), dtype=spec.dtype, device=device),
        "ssm": torch.zeros((*lead, batch, spec.num_heads, spec.head_dim,
                            spec.d_state), dtype=torch.float32,
                           device=device),
    }
