"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 + 1 shared expert.
[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (kv=8) d_ff=2048
(per expert) vocab=163840.

As in the reference, Kimi K2's dense first layer is modeled as MoE like the
rest (param delta ~0.03%) and attention follows the assigned GQA spec.  At
about 2 TB of bf16 expert weights the full config needs the sharded MoE
routes, which the port does not have yet; its smoke config (with the shared
expert) runs on one device.

The reference's ``sharding`` and ``seq_shard_train`` settings are left
out: the port runs on one card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_capacity_factor=1.25,
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    num_shared_experts=1,
    remat="none",
)
