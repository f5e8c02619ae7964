"""llama3.2-3b — small llama3 dense GQA LM [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama3.2-3b"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=256, vocab=256, rope_theta=500_000.0, tie_embeddings=True,
)
