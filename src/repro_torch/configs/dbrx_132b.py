"""dbrx-132b — fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (kv=8)
d_ff=10752 (per expert) vocab=100352.

The reference's ``seq_shard_train`` setting is left out: the port's
training step does not shard activations yet."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    moe_capacity_factor=1.25,
    logits_chunk=16384,
    sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    remat="none",
)
