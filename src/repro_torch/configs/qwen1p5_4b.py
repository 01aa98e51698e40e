"""qwen1.5-4b — dense, QKV bias, kv == heads (MHA).
[hf:Qwen/Qwen1.5-0.5B; hf]  40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    logits_chunk=16384,
    sharding="fsdp_tp",
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    remat="none",
)
