"""stablelm-3b — dense MHA LM [hf:stabilityai/stablelm-2-1_6b; unverified]."""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "stablelm-3b"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab=50304, tie_embeddings=False,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=160, vocab=256, tie_embeddings=False,
)
