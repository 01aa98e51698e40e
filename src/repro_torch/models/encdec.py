"""Whisper-style encoder-decoder, the ``audio`` family
(``repro.models.encdec``): whisper-tiny.  The conv frontend is a stub: the
batch carries precomputed frame embeddings ``audio_frames`` (B,
encoder_tokens, D).

LayerNorm + GELU + learned positions, as the Whisper architecture.  The
encoder runs non-causal self-attention over the frames; each decoder layer
runs causal self-attention, cross-attention to the encoder output, and the
MLP.  Plain functions over the port's flat ``{path: tensor}`` params
(nested on entry, as the reference indexes them), the stacked layers as a
Python loop.  The encoder's self-attention, the decoder's and the
cross-attention (Tq the prompt, Tk the frames) go through
``kernels.ops.attention``, so on a CUDA device each is one
``flash_attention`` launch a layer (at whisper-tiny's hd 64; with grad the
backward kernel once each too); the decode step's attention over the caches
stays on ``layers.decode_attention``, as in the reference.

``forward`` is differentiable; under ``cfg.remat`` each decoder layer is
recomputed in the backward, as the reference checkpoints its decoder scan
body (its encoder scan is not checkpointed).  ``prefill`` returns the
self-attention cache ``k``/``v`` and the cross-attention cache ``xk``/``xv``
(each layer's projections of the encoder output); ``decode_step`` writes
the new token's keys and values into the cache it is given, in place, and
returns it (the reference's engine donates the cache to the step).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models import transformer as tf
from repro_torch.models.param import ParamSpec

FAMILIES = ("audio",)


def _xattn_specs(cfg: ModelConfig, nl: int) -> Dict:
    hd = cfg.resolved_head_dim
    bf16 = torch.bfloat16
    return {
        "norm": L.norm_specs(cfg, stacked=nl),
        "wq": ParamSpec((nl, cfg.d_model, cfg.num_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "heads", None)),
        "wk": ParamSpec((nl, cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "kv", None)),
        "wv": ParamSpec((nl, cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=("layers", "embed", "kv", None)),
        "wo": ParamSpec((nl, cfg.num_heads, hd, cfg.d_model), dtype=bf16,
                        logical=("layers", "heads", None, "embed")),
    }


def specs(cfg: ModelConfig) -> Dict:
    """The encoder's and decoder's layers stacked on leading
    ``encoder_layers`` / ``num_layers`` axes, learned positions for both,
    an untied ``lm_head`` unless the embedding is tied."""
    ne, nd = cfg.encoder_layers, cfg.num_layers
    bf16 = torch.bfloat16
    sp = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), scale=1.0,
                           dtype=bf16, logical=("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.encoder_tokens, cfg.d_model), scale=0.02,
                             dtype=bf16, logical=("seq", "embed")),
        "dec_pos": ParamSpec((cfg.max_seq_len, cfg.d_model), scale=0.02,
                             dtype=bf16, logical=("seq", "embed")),
        "encoder": {
            "attn": tf.attention_specs(cfg, ne),
            "mlp_norm": L.norm_specs(cfg, stacked=ne),
            "mlp": L.mlp_specs(cfg, stacked=ne),
        },
        "decoder": {
            "attn": tf.attention_specs(cfg, nd),
            "xattn": _xattn_specs(cfg, nd),
            "mlp_norm": L.norm_specs(cfg, stacked=nd),
            "mlp": L.mlp_specs(cfg, stacked=nd),
        },
        "enc_final_norm": L.norm_specs(cfg),
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=bf16,
                                  logical=("embed", "vocab"))
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=bf16, logical=("embed", None))
    return sp


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btd,dnh->btnh", x, w)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("btnh,nhd->btd", o, w)


def _cross_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    xn = L.apply_norm(cfg, p["norm"], x)
    out = ops.attention(_proj(xn, p["wq"]), enc_k, enc_v, causal=False,
                        kv_chunk=min(512, enc_k.shape[1]))
    return _out(out, p["wo"])


def _enc_kv(p: Dict, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def _enc_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    q, kk, vv = tf._qkv(cfg, p["attn"], h, positions)
    out = ops.attention(q, kk, vv, causal=False,
                        kv_chunk=min(512, h.shape[1]))
    h = h + _out(out, p["attn"]["wo"])
    return h + L.apply_mlp(cfg, p["mlp"],
                           L.apply_norm(cfg, p["mlp_norm"], h))


def encode(cfg: ModelConfig, params: Dict,
           audio_frames: torch.Tensor) -> torch.Tensor:
    """audio_frames (B, encoder_tokens, D) stub frame embeddings -> the
    encoder output (B, encoder_tokens, D) in the config's dtype.
    ``params`` is the nested tree."""
    dt = cfg.torch_dtype
    x = audio_frames.to(dt) + params["enc_pos"].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.encoder_layers):
        x = _enc_layer(cfg, tf._layer(params["encoder"], i), x, positions)
    return L.apply_norm(cfg, params["enc_final_norm"], x)


def _dec_layer(cfg: ModelConfig, p: Dict, h: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor,
               with_cache: bool = False):
    q, kk, vv = tf._qkv(cfg, p["attn"], h, positions)
    ck = min(h.shape[1],
             L.pick_kv_chunk(h.shape[0], h.shape[1], cfg.num_heads))
    out = ops.attention(q, kk, vv, causal=True, kv_chunk=ck)
    h = h + _out(out, p["attn"]["wo"])
    ek, ev = _enc_kv(p["xattn"], enc_out)
    h = h + _cross_attn(cfg, p["xattn"], h, ek, ev)
    h = h + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], h))
    if not with_cache:
        return h, None
    dt = cfg.torch_dtype
    return h, {"k": kk.to(dt), "v": vv.to(dt), "xk": ek.to(dt),
               "xv": ev.to(dt)}


def _decode_blocks(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                   enc_out: torch.Tensor, positions: torch.Tensor,
                   with_cache: bool = False):
    """The decoder layers over x; with ``with_cache`` also the stacked
    caches {"k", "v"} (L, B, T, Hk, hd) and {"xk", "xv"} (L, B,
    encoder_tokens, Hk, hd)."""
    if not with_cache:
        for i in range(cfg.num_layers):
            def body(h, p=tf._layer(params["decoder"], i)):
                return _dec_layer(cfg, p, h, enc_out, positions)[0]
            x = L.remat(cfg, body, x)
        return x, None
    caches = []
    for i in range(cfg.num_layers):
        x, c = _dec_layer(cfg, tf._layer(params["decoder"], i), x, enc_out,
                          positions, with_cache=True)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches])
               for k in ("k", "v", "xk", "xv")}


def _embed_dec(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
               offset: int) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    pos = offset + torch.arange(tokens.shape[1], device=x.device)
    return x + params["dec_pos"][pos].to(x.dtype)


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  audio_frames: Optional[torch.Tensor], with_cache: bool):
    if audio_frames is None:
        raise ValueError("the audio family needs the batch's audio_frames "
                         "(B, encoder_tokens, d_model)")
    tree = P.nest(params)
    enc_out = encode(cfg, tree, audio_frames)
    x = _embed_dec(cfg, tree, tokens, 0)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _decode_blocks(cfg, tree, x, enc_out, positions, with_cache)
    return L.apply_norm(cfg, tree["final_norm"], x), caches


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            audio_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) and audio_frames (B, encoder_tokens, D) -> the
    decoder's final hidden states (B, T, D); differentiable."""
    return _forward_impl(cfg, params, tokens, audio_frames, False)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            audio_frames: Optional[torch.Tensor] = None):
    """Forward that also returns the caches {"k", "v", "xk", "xv"} in the
    config's dtype."""
    return _forward_impl(cfg, params, tokens, audio_frames, True)


def cache_specs(cfg: ModelConfig, batch: int,
                seq_len: int) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)}: the ``seq_len`` self-attention cache and the
    cross-attention cache over the encoder's frames."""
    hd, nl, dt = cfg.resolved_head_dim, cfg.num_layers, cfg.torch_dtype
    kv = (nl, batch, seq_len, cfg.num_kv_heads, hd)
    xkv = (nl, batch, cfg.encoder_tokens, cfg.num_kv_heads, hd)
    return {"k": (kv, dt), "v": (kv, dt), "xk": (xkv, dt), "xv": (xkv, dt)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> Dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in cache_specs(cfg, batch, seq_len).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache with this token's keys and values written in, in place)."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = _embed_dec(cfg, tree, tokens, cache_len)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    for i in range(cfg.num_layers):
        p = tf._layer(tree["decoder"], i)
        q, kk, vv = tf._qkv(cfg, p["attn"], x, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[:, cache_len:cache_len + T] = kk.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + T] = vv.to(v_cache.dtype)
        out = L.decode_attention(q, k_cache, v_cache, kv_len=cache_len + 1)
        x = x + _out(out, p["attn"]["wo"])
        # cross-attention against the cached encoder projections
        xn = L.apply_norm(cfg, p["xattn"]["norm"], x)
        xq = _proj(xn, p["xattn"]["wq"])
        xk, xv = cache["xk"][i], cache["xv"][i]
        xout = L.decode_attention(xq, xk, xv, kv_len=xk.shape[1])
        x = x + _out(xout, p["xattn"]["wo"])
        x = x + L.apply_mlp(cfg, p["mlp"],
                            L.apply_norm(cfg, p["mlp_norm"], x))
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :]), cache
