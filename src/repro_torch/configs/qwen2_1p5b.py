"""qwen2-1.5b — dense GQA with QKV bias.
[arXiv:2407.10671; hf]  28L d_model=1536 12H (kv=2) d_ff=8960 vocab=151936.

The reference's ``sharding`` setting is left out: the port runs on one
card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    num_layers=3,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    qkv_bias=True,
    remat="none",
)
