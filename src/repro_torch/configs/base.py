"""Model and training configs (the ``repro.configs.base`` dataclasses).

Only the fields the ported families and the mesh read are kept, with the
reference's defaults, except ``family``, which defaults to the port's
first family, ``mlp``.  Dtype strings map to torch dtypes.  ``sharding``
names the policy ``distributed.sharding`` maps the logical axes with;
the MoE's ``moe_route``, ``moe_ffn_mode`` and ``moe_gather_dtype`` pick
its routes over a mesh.
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
    family: str = "mlp"          # mlp | hybrid | dense | ssm | moe | vlm |
                                 # audio
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
    pos_embed: str = "rope"      # rope | learned (whisper)
    max_seq_len: int = 4096
    # attention pattern ---------------------------------------------------
    sliding_window: int = 0      # 0 -> full causal
    local_global_ratio: int = 0  # N: every (N+1)-th layer global (gemma3 5)
    # ssm (ssm, hybrid) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 128         # SSD chunk length
    # hybrid (zamba2-style shared attention block) -------------------------
    shared_attn_every: int = 0   # 0 -> no shared attention block
    # moe -------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    num_shared_experts: int = 0  # kimi-style always-on shared expert(s)
    moe_gather_dtype: str = "bf16"  # "int8" halves the expert-shard
                                    # all-gather (lossy)
    moe_route: str = "replicate_psum"  # | "a2a" (token-routing EP)
    moe_ffn_mode: str = "gather"       # | "psum" (local-F partial sums)
    # enc-dec (whisper; stub frontend: precomputed frame embeddings) -------
    encoder_layers: int = 0
    encoder_tokens: int = 0      # stub frontend output length (whisper 1500)
    # vlm (stub frontend: precomputed patch embeddings) ---------------------
    frontend: str = ""           # "" | vit_stub
    frontend_tokens: int = 0     # patch tokens prepended to the text sequence
    # numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "layer"         # none | layer: recompute each layer in the
                                 # backward (torch.utils.checkpoint)
    logits_chunk: int = 0        # 0 -> materialize logits; else chunked
    # sharding --------------------------------------------------------------
    sharding: str = "fsdp_tp"    # a distributed.sharding.POLICIES key
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
    """Optimizer / schedule knobs (defaults as in the JAX package).
    ``grad_compression="int8_ef"`` is honoured by
    ``training.compressed_dp``'s step alone."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # memory levers for giant models
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8
    factored_second_moment: bool = False
    # schedule: the paper trains 200 epochs with 10x LR drops at 80/120/160/180
    schedule: str = "paper_steps"     # paper_steps | cosine | constant
    warmup_steps: int = 0
    total_steps: int = 1000
    # distributed tricks
    grad_compression: str = "none"    # none | int8_ef
    grad_accum: int = 1
    accum_dtype: str = "float32"      # grad-accumulation carry dtype
