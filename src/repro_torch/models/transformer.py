"""The parts of the decoder-only transformer (``repro.models.transformer``)
that the hybrid family uses: attention parameter specs, the QKV
projection with RoPE, token embedding and the LM head.  The dense / MoE /
VLM forward is not ported yet."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
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
