from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401
