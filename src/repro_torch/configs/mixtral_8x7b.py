"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""

from repro_torch.models.layers import MoESpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "mixtral-8x7b"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab=32000, window=4096,
    moe=MoESpec(num_experts=8, top_k=2), rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab=256, window=16,
    moe=MoESpec(num_experts=4, top_k=2), tie_embeddings=False,
)
