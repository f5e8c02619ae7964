from repro_torch.data.pipeline import (
    DataConfig, SyntheticLMData, make_batch, device_batch,
)
