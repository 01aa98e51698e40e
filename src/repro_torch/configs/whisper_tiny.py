"""whisper-tiny — encoder-decoder audio backbone (conv frontend STUB).
[arXiv:2212.04356; unverified]  4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  LayerNorm + GELU + learned positions.  The batch carries
precomputed frame embeddings ``audio_frames`` (B, 1500, 384).  Vocab padded
51865 -> 51872 (a multiple of 16).  max_seq_len covers the reference's
decode_32k cell (beyond Whisper's native 448-token decoder).

The reference's ``sharding`` setting is left out: the port runs on one
card."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51872,   # 51865 padded to a multiple of 16
    norm="layernorm",
    act="gelu",
    pos_embed="learned",
    encoder_tokens=1500,
    max_seq_len=32768,
    remat="layer",
    logits_chunk=16384,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=3,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    norm="layernorm",
    act="gelu",
    pos_embed="learned",
    encoder_tokens=16,
    max_seq_len=128,
    remat="none",
)
