"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2 backbone.
[arXiv:2404.16821; hf]  48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553.
The ViT frontend is a stub: the batch carries precomputed patch
embeddings ``patch_embeds`` (B, 1024, d_model), prepended to the text.
Vocab padded 92553 -> 92672 (multiple of 256) for even sharding; padding
ids are never produced.

The reference's ``sharding`` setting is left out: the port runs on one
card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92672,   # 92553 padded to a multiple of 256
    frontend="vit_stub",
    frontend_tokens=1024,
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vit_stub",
    frontend_tokens=8,
    remat="none",
)
