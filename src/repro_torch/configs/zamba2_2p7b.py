"""zamba2-2.7b — Mamba2 backbone + shared attention blocks
(``repro.configs.zamba2_2p7b``).
[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Shared transformer block applied every 6 mamba layers."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_kernel=4,
    shared_attn_every=6,
    logits_chunk=16384,
    sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv_kernel=4,
    ssm_chunk=16,
    shared_attn_every=2,
    remat="none",
)
