from repro_torch.runtime.train import Trainer, TrainConfig, FaultInjector
