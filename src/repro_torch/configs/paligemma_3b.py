"""paligemma-3b — SigLIP + gemma VLM [arXiv:2407.07726].

The SigLIP vision tower is a STUB, as in the reference: callers supply
256 precomputed patch embeddings which occupy the sequence prefix under
prefix-LM masking (bidirectional within the prefix)."""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "paligemma-3b"

NUM_PATCHES = 256     # 224px / 14px patches -> 16x16

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256, prefix_len=NUM_PATCHES,
    embed_scale=True, tie_embeddings=True,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=192, vocab=256, head_dim=16, prefix_len=8,
    embed_scale=True, tie_embeddings=True,
)
