"""rwkv6-7b — "Finch" attention-free LM, data-dependent decay
[arXiv:2404.05892]."""

from repro_torch.models.rwkv6 import RWKVConfig

ARCH_ID = "rwkv6-7b"

FULL = RWKVConfig(
    name=ARCH_ID,
    num_layers=32, d_model=4096, d_ff=14336, vocab=65536, head_size=64,
)

SMOKE = RWKVConfig(
    name=ARCH_ID + "-smoke",
    num_layers=2, d_model=64, d_ff=224, vocab=256, head_size=16,
    decay_lora=8,
)
