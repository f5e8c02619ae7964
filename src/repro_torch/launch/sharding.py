"""Sharding rules: param/optimizer/batch/cache PartitionSpecs per family
(the port of ``repro/launch/sharding.py``, rules verbatim).

Strategy: 2D FSDP x TP for dense params — d_model-ish dims shard over the
``data`` axis (FSDP), head/ffn/vocab dims over ``model`` (TP); MoE expert
dims shard over ``model`` when there are enough experts (kimi-k2: 384/16)
and over the ffn dim otherwise (mixtral: 8 experts, Megatron-style
expert-TP). The ``pod`` axis is pure DP by default; archs whose params
exceed one pod's memory (kimi-k2, mixtral) extend FSDP over ``pod`` too.

Rules are (regex over the param path) -> PartitionSpec template, resolved
against the mesh at hand. Anything unmatched replicates (and is listed).
Stacked layer params (paths under ``layers/`` etc.) get a leading
``None`` for the layer dimension.

A spec is a ``PartitionSpec``: a tuple, one entry a tensor dim (None, an
axis name, or a tuple of axis names), so specs compare entry for entry
with the reference's. Trees are the port's nested dicts, walked in
sorted-key order (``jax.tree``'s); a path joins the keys with ``/``.
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``
(``runconfig.placements``: a dim over several axes must list them in mesh
order, where DTensor's and JAX's split orders agree). A mesh is a
``DeviceMesh``, an ``AbstractMesh`` or anything with a ``shape`` dict.
"""

from __future__ import annotations

import re

from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.runconfig import placements


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: ``P("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# archs whose parameters must shard across pods as well (capacity)
FSDP_OVER_POD = frozenset({"kimi-k2-1t-a32b", "mixtral-8x7b"})

# Sub-GB models are collective-bound under 16-wide TP; they run pure-DP:
# the model axis folds into data-parallel batch, params replicate, and
# the only collective left is the gradient all-reduce.
PURE_DP = frozenset({"smollm-135m"})


def parallelism(api, mesh):
    """(fsdp_axes, tensor_axis_or_None, dp_axes) for this arch x mesh."""
    multi_pod = "pod" in axis_names(mesh)
    if api.arch_id in PURE_DP:
        dp = (("pod", "data", "model") if multi_pod
              else ("data", "model"))
        return None, None, dp
    F = (("pod", "data") if multi_pod and api.arch_id in FSDP_OVER_POD
         else ("data",))
    return F, "model", data_axes(mesh)


_STACKED = re.compile(r"^(layers|enc_layers|dec_layers)/")


def _param_rules(F, T, moe_expert_sharded: bool):
    """Ordered (regex, spec) rules. F = fsdp axes tuple, T = tensor axis."""
    if moe_expert_sharded:
        moe_up = P(T, F, None)          # (E, D, FF): experts over model
        moe_down = P(T, None, F)        # (E, FF, D)
    else:
        moe_up = P(None, F, T)          # experts replicated, FF over model
        moe_down = P(None, T, F)
    return [
        (r"embed$", P(T, F)),
        (r"(lm_)?head$", P(F, T)),
        (r"attn/w[qkv]$", P(F, T)),
        (r"attn/wo$", P(T, F)),
        (r"attn/b[qkv]$", P(T)),
        (r"(mlp|cm)/(w_gate|w_up|w_in|wk)$", P(F, T)),
        (r"(mlp|cm)/(w_down|w_out|wv)$", P(T, F)),
        (r"mlp/b_in$", P(T)),
        (r"cm/wr$", P(F, T)),
        (r"moe/router$", P(F, None)),
        (r"moe/(w_gate|w_up)$", moe_up),
        (r"moe/w_down$", moe_down),
        # rwkv6 time-mix
        (r"tm/(wr|wk|wv|wg)$", P(F, T)),
        (r"tm/wo$", P(T, F)),
        (r"tm/w_a$", P(F, None)),
        (r"tm/w_b$", P(None, T)),
        # mamba2
        (r"block/in_proj$", P(F, T)),
        (r"block/out_proj$", P(T, F)),
        (r"block/conv_w$", P(None, T)),
        (r"block/conv_b$", P(T)),
        (r"block/norm/scale$", P(T)),
    ]


def _cache_rules(DP, T):
    """Decode-cache sharding preferences: batch over DP, head-ish dims
    over model, with the ring/time axis as the model-sharding fallback
    (the "alt" dim) when KV heads don't divide the model axis (GQA kv=8
    on a 16-wide TP axis: the cache then shards sequence-parallel).
    Non-divisible dims are replicated by ``cache_specs``."""
    return [
        # (regex, preferred spec, alt dim for T if preferred T dim fails)
        (r"(^|/)(k|v)$", P(None, DP, None, T, None), 2),    # (L,B,W,KV,hd)
        (r"(^|/)pos$", P(None, DP, None), None),            # (L,B,W)
        (r"cross_(k|v)$", P(None, DP, None, T, None), 2),   # (L,B,Senc,KV,hd)
        (r"^wkv$", P(None, DP, T, None, None), None),       # (L,B,H,hs,hs)
        (r"^(tm|cm)_last$", P(None, DP, None), None),       # (L,B,D)
        (r"mamba/conv$", P(None, DP, None, T), None),       # (L,B,K-1,C)
        (r"mamba/ssm$", P(None, DP, T, None, None), None),  # (L,B,H,P,N)
    ]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix)


def _leaf_paths(tree):
    return list(_paths(tree)), list(tree_leaves(tree))


def _match(rules, path):
    for regex, spec in rules:
        if re.search(regex, path):
            return spec
    return None


def _fit(spec: P, rank: int, stacked: bool) -> P:
    parts = list(spec)
    if stacked:
        parts = [None] + parts
    if len(parts) > rank:      # scalar-ish leaves
        parts = parts[:rank]
    return P(*parts)


def _part_axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _divisible(leaf, dim, part, mesh) -> bool:
    size = axis_size(mesh, _part_axes(part))
    return size <= 1 or leaf.shape[dim] % size == 0


def param_specs(api, params_shape, mesh) -> tuple[dict, list[str]]:
    """PartitionSpec tree for a model's params. Returns (tree, unmatched)."""
    F, T, _dp = parallelism(api, mesh)
    moe = getattr(api.cfg, "moe", None)
    expert_sharded = bool(T and moe
                          and moe.num_experts >= mesh_shape(mesh)[T])
    rules = _param_rules(F, T, expert_sharded)

    paths, leaves = _leaf_paths(params_shape)
    specs, unmatched = [], []
    for path, leaf in zip(paths, leaves):
        spec = _match(rules, path)
        stacked = bool(_STACKED.match(path))
        if spec is None:
            unmatched.append(path)
            specs.append(P())
            continue
        fitted = list(_fit(spec, len(leaf.shape), stacked))
        for dim in range(len(fitted)):
            if fitted[dim] is not None and not _divisible(
                    leaf, dim, fitted[dim], mesh):
                fitted[dim] = None       # replicate non-divisible dims
        specs.append(P(*fitted))
    return tree_unflatten(params_shape, specs), unmatched


def _dp_if_divisible(batch_dim: int, mesh, DP):
    """Largest prefix of the dp axes that divides the batch (graceful
    degradation: ('data','model') -> ('data',) -> None)."""
    for k in range(len(DP), 0, -1):
        axes = DP[:k]
        if batch_dim % axis_size(mesh, axes) == 0:
            return axes
    return None


def batch_specs(batch_shape, mesh, api=None) -> dict:
    """Training/prefill inputs: shard the batch dim over the dp axes."""
    DP = parallelism(api, mesh)[2] if api is not None else data_axes(mesh)

    def one(leaf):
        dp = _dp_if_divisible(leaf.shape[0], mesh, DP)
        return P(dp, *([None] * (len(leaf.shape) - 1)))

    return tree_map(one, batch_shape)


def cache_specs(api, cache_shape, mesh) -> dict:
    """Decode-cache shardings: rule preferences + divisibility enforcement.

    Argument shardings must divide exactly; any dim that doesn't is
    replicated — except the model axis on KV heads, which falls back to
    the ring/sequence axis (fallback recorded in the rule table)."""
    DP = data_axes(mesh)
    T = "model"
    rules = _cache_rules(DP, T)
    paths, leaves = _leaf_paths(cache_shape)
    out = []
    for path, leaf in zip(paths, leaves):
        matched = None
        for regex, spec, alt_dim in rules:
            if re.search(regex, path):
                matched = (spec, alt_dim)
                break
        if matched is None:
            out.append(P())
            continue
        spec, alt_dim = matched
        parts = list(spec)[: len(leaf.shape)]
        parts += [None] * (len(leaf.shape) - len(parts))
        for dim in range(len(parts)):
            if parts[dim] is not None and not _divisible(
                    leaf, dim, parts[dim], mesh):
                failed_t = parts[dim] == T
                parts[dim] = None
                if (failed_t and alt_dim is not None
                        and parts[alt_dim] is None
                        and _divisible(leaf, alt_dim, T, mesh)):
                    parts[alt_dim] = T   # sequence-parallel cache fallback
        out.append(P(*parts))
    return tree_unflatten(cache_shape, out)


def decode_input_specs(inputs, api, mesh) -> dict:
    """{"cache","tokens","pos"} sharding specs for serve_step."""
    DP = data_axes(mesh)
    cache = cache_specs(api, inputs["cache"], mesh)
    B = inputs["tokens"].shape[0]
    dp = _dp_if_divisible(B, mesh, DP)
    return {"cache": cache, "tokens": P(dp), "pos": P(dp)}


def named(tree_specs, mesh):
    """Each spec of ``tree_specs`` as DTensor placements on ``mesh`` (a
    ``DeviceMesh``): the port's ``NamedSharding`` tree."""
    return tree_map(lambda s: placements(s, mesh), tree_specs)
