"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""

from repro_torch.models.hybrid import HybridConfig

ARCH_ID = "zamba2-7b"

FULL = HybridConfig(
    name=ARCH_ID,
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, attn_every=6,
)

SMOKE = HybridConfig(
    name=ARCH_ID + "-smoke",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=8, attn_every=2,
)
