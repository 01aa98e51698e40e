"""Decoder-only transformer (``repro.models.transformer``): the ``dense``
family, and the parts the hybrid family's shared block uses (attention
parameter specs, the QKV projection with RoPE, token embedding, the LM
head).

One config-driven implementation of the reference's dense path: GQA
attention with an optional QKV bias and RoPE, a sliding window, gemma3's
local:global interleave (every ``local_global_ratio + 1``-th layer global,
the others windowed) by per-layer flags, and the SwiGLU (or GELU) MLP.
Plain functions over the port's flat ``{path: tensor}`` params (nested on
entry, as the reference indexes them), inference only: the stacked layers
run as a Python loop, with no remat.  Attention goes through
``kernels.ops.attention``, so on a CUDA device every forward, prefill and
pool pass runs the ``flash_attention`` kernel (one launch a layer), with
``window=0`` on global layers and ``window=cfg.sliding_window`` on local
ones, the choice the reference's ``jax.lax.cond`` makes.  Decode stays on
``layers.decode_attention``, as in the reference.  ``decode_step`` writes
the new token's keys and values into the cache it is given, in place, and
returns it (the reference's engine donates the cache to the step).  The
``moe`` and ``vlm`` families are not ported: the registry refuses them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.param import ParamSpec


def attention_specs(cfg: ModelConfig, nl: int) -> Dict:
    """Attention params; nl == 0 -> unstacked (single shared block)."""
    hd = cfg.resolved_head_dim
    s = (nl,) if nl else ()
    bf16 = torch.bfloat16
    sp = {
        "norm": L.norm_specs(cfg, stacked=nl),
        "wq": ParamSpec(s + (cfg.d_model, cfg.num_heads, hd), dtype=bf16),
        "wk": ParamSpec(s + (cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16),
        "wv": ParamSpec(s + (cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16),
        "wo": ParamSpec(s + (cfg.num_heads, hd, cfg.d_model), dtype=bf16),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec(s + (cfg.num_heads, hd), init="zeros",
                             dtype=bf16)
        sp["bk"] = ParamSpec(s + (cfg.num_kv_heads, hd), init="zeros",
                             dtype=bf16)
        sp["bv"] = ParamSpec(s + (cfg.num_kv_heads, hd), init="zeros",
                             dtype=bf16)
    return sp


def specs(cfg: ModelConfig) -> Dict:
    """The dense family's parameter specs: the layers stacked on a leading
    ``num_layers`` axis, an untied ``lm_head`` unless the embedding is
    tied."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet")
    nl = cfg.num_layers
    bf16 = torch.bfloat16
    sp = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), scale=1.0,
                           dtype=bf16),
        "blocks": {
            "attn": attention_specs(cfg, nl),
            "mlp_norm": L.norm_specs(cfg, stacked=nl),
            "mlp": L.mlp_specs(cfg, stacked=nl),
        },
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=bf16)
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=bf16)
    return sp


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> q (B, T, H, hd), k and v (B, T, Hk, hd)."""
    xn = L.apply_norm(cfg, p["norm"], x)
    q = torch.einsum("btd,dnh->btnh", xn, p["wq"])
    kk = torch.einsum("btd,dnh->btnh", xn, p["wk"])
    vv = torch.einsum("btd,dnh->btnh", xn, p["wv"])
    if cfg.qkv_bias:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    if cfg.pos_embed == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        kk = L.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def lm_head_weight(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def logits_fn(cfg: ModelConfig, params: Dict,
              hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ lm_head_weight(cfg, params)


# ---------------------------------------------------------------------------
# the dense family: blocks, forward, prefill, decode
# ---------------------------------------------------------------------------


def _layer_flags(cfg: ModelConfig) -> List[bool]:
    """is_global per layer (gemma3's 5:1 pattern; all global otherwise)."""
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio + 1
        return [(i % r) == (r - 1) for i in range(cfg.num_layers)]
    return [True] * cfg.num_layers


def _window(cfg: ModelConfig, is_global: bool) -> int:
    """The layer's attention window: 0 on the global layers of a
    local:global model, the config's window on every other layer."""
    if cfg.local_global_ratio and cfg.sliding_window and is_global:
        return 0
    return cfg.sliding_window


def _block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
           positions: torch.Tensor, is_global: bool, kv_chunk: int = 1024,
           with_cache: bool = False):
    q, kk, vv = _qkv(cfg, p["attn"], x, positions)
    T = x.shape[1]
    ck = min(kv_chunk, T, L.pick_kv_chunk(x.shape[0], T, cfg.num_heads))
    out = ops.attention(q, kk, vv, causal=True,
                        window=_window(cfg, is_global), kv_chunk=ck)
    x = x + torch.einsum("btnh,nhd->btd", out, p["attn"]["wo"])
    x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x))
    cache = {"k": kk.to(cfg.torch_dtype), "v": vv.to(cfg.torch_dtype)} \
        if with_cache else None
    return x, cache


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked block params (views, no copies)."""
    return P.tree_map(lambda a: a[i], blocks)


def _scan_blocks(cfg: ModelConfig, tree: Dict, x: torch.Tensor,
                 positions: torch.Tensor, with_cache: bool = False):
    """The reference's layer scan as a loop over the stacked layers; with
    ``with_cache`` also the stacked K/V cache (L, B, T, Hk, hd)."""
    caches = []
    for i, flag in enumerate(_layer_flags(cfg)):
        x, c = _block(cfg, _layer(tree["blocks"], i), x,
                      positions=positions, is_global=flag,
                      with_cache=with_cache)
        caches.append(c)
    if not with_cache:
        return x, None
    return x, {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  with_cache: bool):
    tree = P.nest(params)
    x = embed_tokens(cfg, tree, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _scan_blocks(cfg, tree, x, positions, with_cache)
    return L.apply_norm(cfg, tree["final_norm"], x), caches


@torch.no_grad()
def forward(cfg: ModelConfig, params: Dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> final hidden states (B, T, D)."""
    return _forward_impl(cfg, params, tokens, with_cache=False)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor):
    """Forward that also returns the stacked KV cache {"k", "v"}
    (L, B, T, Hk, hd) in the config's dtype."""
    return _forward_impl(cfg, params, tokens, with_cache=True)


def cache_specs(cfg: ModelConfig, batch: int,
                seq_len: int) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)} of a ``seq_len`` KV cache."""
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> Dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in cache_specs(cfg, batch, seq_len).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache (L, B, S, Hk, hd) with this token written in, in place)."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = embed_tokens(cfg, tree, tokens)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    for i, flag in enumerate(_layer_flags(cfg)):
        p = _layer(tree["blocks"], i)
        q, kk, vv = _qkv(cfg, p["attn"], x, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[:, cache_len:cache_len + T] = kk.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + T] = vv.to(v_cache.dtype)
        out = L.decode_attention(q, k_cache, v_cache, kv_len=cache_len + 1,
                                 window=_window(cfg, flag))
        x = x + torch.einsum("btnh,nhd->btd", out, p["attn"]["wo"])
        x = x + L.apply_mlp(cfg, p["mlp"],
                            L.apply_norm(cfg, p["mlp_norm"], x))
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return logits_fn(cfg, tree, hidden[:, -1:, :]), cache
