"""Model and training configs (the ``repro.configs.base`` dataclasses).

Only the fields the ported families read are kept, with the reference's
defaults, except ``family``, which defaults to the port's first family,
``mlp``.  Dtype strings map to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "model"
    family: str = "mlp"          # mlp | hybrid | dense
    # backbone -----------------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 256
    act: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"      # rope (the only one a ported family uses)
    max_seq_len: int = 4096
    # attention pattern ---------------------------------------------------
    sliding_window: int = 0      # 0 -> full causal
    local_global_ratio: int = 0  # N: every (N+1)-th layer global (gemma3 5)
    # ssm (hybrid) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 128         # SSD chunk length
    # hybrid (zamba2-style shared attention block) -------------------------
    shared_attn_every: int = 0   # 0 -> no shared attention block
    # numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    logits_chunk: int = 0        # 0 -> materialize logits; else chunked
    # classifier head for MCAL labeling tasks --------------------------------
    num_classes: int = 0         # 0 -> plain LM head over vocab
    input_dim: int = 0           # mlp family: feature-vector input width

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
