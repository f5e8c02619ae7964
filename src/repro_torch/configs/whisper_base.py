"""whisper-base — enc-dec audio backbone; conv frontend stubbed
[arXiv:2212.04356]. The encoder takes precomputed frame embeddings."""

from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-base"

FULL = EncDecConfig(
    name=ARCH_ID,
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab=51865,
)

SMOKE = EncDecConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab=256,
)
