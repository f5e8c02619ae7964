"""smollm-135m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "smollm-135m"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab=49152, tie_embeddings=True,
)

# Reduced same-family config for CPU smoke tests (GQA 3:1 ratio preserved).
SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
    d_ff=128, vocab=256, tie_embeddings=True,
)
