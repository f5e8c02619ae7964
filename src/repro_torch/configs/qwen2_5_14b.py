"""qwen2.5-14b — dense GQA LM with QKV bias [hf:Qwen/Qwen2.5-0.5B]."""

from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2.5-14b"

FULL = LMConfig(
    name=ARCH_ID,
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False,
)

SMOKE = LMConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=80, num_heads=5, num_kv_heads=1,
    d_ff=224, vocab=256, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False,
)
