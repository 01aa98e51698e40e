"""mamba2-1.3b — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]  48L d_model=2048 vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim 64 -> 64 ssm heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # attention-free
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_kernel=4,
    logits_chunk=16384,
    sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    ssm_state=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv_kernel=4,
    ssm_chunk=16,
    remat="none",
)
