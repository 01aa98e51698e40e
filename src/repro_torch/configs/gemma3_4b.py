"""gemma3-4b — dense GQA, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]  34L d_model=2560 8H (kv=4)
d_ff=10240 vocab=262144.  Every 6th layer is global; local layers use a
1024-token sliding window.  Tied embeddings (the 262k vocab dominates).

The reference's ``sharding`` setting is left out: the port runs on one
card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    tie_embeddings=True,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=True,
    sliding_window=8,
    local_global_ratio=5,
    remat="none",
)
