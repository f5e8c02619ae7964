from repro_torch.runtime.train import Trainer, TrainConfig, FaultInjector
from repro_torch.runtime.serve import DecodeServer, OffloadedKVCache, \
    ServeConfig
