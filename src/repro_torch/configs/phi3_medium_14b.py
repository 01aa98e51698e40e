"""phi3-medium-14b — dense, RoPE SwiGLU GQA.
[arXiv:2404.14219; unverified]  40L d_model=5120 40H (kv=10) d_ff=17920
vocab=100352.

The reference's ``sharding`` setting is left out: the port runs on one
card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    remat="none",
)
