"""Model and training configs (the ``repro.configs.base`` dataclasses).

Only the fields the ported families read are kept; dtype strings map to
torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "mlp"
    num_layers: int = 2
    d_model: int = 128
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    dtype: str = "float32"
    num_classes: int = 0
    input_dim: int = 0           # mlp family: feature-vector input width

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule knobs (defaults as in the JAX package)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # only float32 slots are ported
    schedule: str = "constant"        # the only schedule ported (the
                                      # reference defaults to paper_steps)
    warmup_steps: int = 0
