"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8
[arXiv:2501.kimi2; paper-table]."""

from repro_torch.models.layers import MoESpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "kimi-k2-1t-a32b"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab=163840,
    moe=MoESpec(num_experts=384, top_k=8), rope_theta=50_000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=1,
    d_ff=32, vocab=256,
    moe=MoESpec(num_experts=8, top_k=4), tie_embeddings=False,
)
