"""Zamba2-style hybrid (``repro.models.hybrid``): a Mamba2 backbone plus one
weight-SHARED attention + MLP block applied every ``shared_attn_every``
layers.

``num_layers`` mamba2 blocks are grouped into ``num_layers //
shared_attn_every`` super-blocks; the shared block (causal attention +
SwiGLU MLP, one set of weights) runs at the start of each.  Each application
keeps its own KV cache for decode (weights shared, caches not).

Plain functions over the port's flat ``{path: tensor}`` params (nested on
entry, as the reference indexes them).  Attention and the SSD scan go
through ``kernels.ops``, so on a CUDA device they run the
``flash_attention`` and ``ssd_scan`` kernels.  ``forward`` is
differentiable, each super-block recomputed in the backward under
``cfg.remat``: on the CPU through the plain versions, on a CUDA device
through the kernels' backward kernels (``flash_attention_bwd``,
``ssd_scan_bwd``).  ``decode_step`` writes the
new token's keys, values and states into the cache it is given, in place,
and returns it (the reference's engine donates the cache to the step, so
no caller keeps the old one).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import param as P
from repro_torch.models import transformer as tf
from repro_torch.models.param import ParamSpec


def _n_apps(cfg: ModelConfig) -> int:
    if not (cfg.shared_attn_every > 0
            and cfg.num_layers % cfg.shared_attn_every == 0):
        raise ValueError("hybrid: num_layers must be a multiple of "
                         f"shared_attn_every > 0, got {cfg.num_layers} and "
                         f"{cfg.shared_attn_every}")
    return cfg.num_layers // cfg.shared_attn_every


def specs(cfg: ModelConfig) -> Dict:
    sp = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), scale=1.0,
                           dtype=torch.bfloat16, logical=("vocab", "embed")),
        "mamba_blocks": mamba2.block_specs(cfg, cfg.num_layers),
        "shared": {
            "attn": tf.attention_specs(cfg, 0),
            "mlp_norm": L.norm_specs(cfg),
            "mlp": L.mlp_specs(cfg),
        },
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  dtype=torch.bfloat16,
                                  logical=("embed", "vocab"))
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=torch.bfloat16,
                                   logical=("embed", None))
    return sp


# the mamba2 block that also returns its final SSM and conv states (the
# SSD kernel returns the final state); ``mamba2.mamba_block`` is this
# function's output alone, so forward and prefill compute alike
_run_mamba_with_state = mamba2.mamba_block_with_state


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  with_cache: bool):
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    na, per = _n_apps(cfg), cfg.shared_attn_every
    attn_caches, ssm_states = [], []
    if not with_cache:
        # one application of the shared block and its group of mamba2
        # blocks, recomputed in the backward under cfg.remat (the
        # reference's checkpointed scan body)
        def group(h, a):
            h = tf._block(cfg, tree["shared"], h, positions=positions,
                          is_global=True)[0]
            for j in range(per):
                h = mamba2.mamba_block(
                    cfg, tf._layer(tree["mamba_blocks"], a * per + j), h)
            return h
        for a in range(na):
            x = L.remat(cfg, group, x, a)
        return L.apply_norm(cfg, tree["final_norm"], x), None
    for a in range(na):
        # the shared block is the dense family's block (causal, no
        # window), one set of weights at every application
        x, attn_cache = tf._block(cfg, tree["shared"], x,
                                  positions=positions, is_global=True,
                                  with_cache=True)
        attn_caches.append(attn_cache)
        for j in range(per):
            p = tf._layer(tree["mamba_blocks"], a * per + j)
            x, st = _run_mamba_with_state(cfg, p, x)
            ssm_states.append(st)
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    attn = {k: torch.stack([c[k] for c in attn_caches]) for k in ("k", "v")}
    ssm = {k: torch.stack([s[k] for s in ssm_states]).unflatten(0, (na, per))
           for k in ("ssm", "conv")}
    return hidden, (attn, ssm)


def forward(cfg: ModelConfig, params: Dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> final hidden states (B, T, D); differentiable
    (on a CUDA device through the backward kernels)."""
    return _forward_impl(cfg, params, tokens, with_cache=False)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor):
    """Forward that also returns the caches: {"attn": {"k", "v"}
    (apps, B, T, Hk, hd), "ssm": {"ssm" (apps, per, B, H, hd, N) fp32,
    "conv" (apps, per, B, K-1, d_inner)}}."""
    hidden, (attn, ssm) = _forward_impl(cfg, params, tokens, with_cache=True)
    return hidden, {"attn": attn, "ssm": ssm}


def cache_specs(cfg: ModelConfig, batch: int,
                seq_len: int) -> Dict[str, Dict[str, Tuple]]:
    """{part: {leaf: (shape, dtype)}} of a ``seq_len`` cache."""
    na, per = _n_apps(cfg), cfg.shared_attn_every
    hd = cfg.resolved_head_dim
    H, shd, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    K, di = cfg.ssm_conv_kernel, cfg.ssm_d_inner
    kv = ((na, batch, seq_len, cfg.num_kv_heads, hd), cfg.torch_dtype)
    return {
        "attn": {"k": kv, "v": kv},
        "ssm": {
            "ssm": ((na, per, batch, H, shd, N), torch.float32),
            "conv": ((na, per, batch, K - 1, di), cfg.torch_dtype),
        },
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> Dict:
    return {part: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in leaves.items()}
            for part, leaves in cache_specs(cfg, batch, seq_len).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache with this token written in, in place)."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = tf.embed_tokens(cfg, tree, tokens)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    shared = tree["shared"]
    na, per = _n_apps(cfg), cfg.shared_attn_every
    for a in range(na):
        q, kk, vv = tf._qkv(cfg, shared["attn"], x, positions)
        k_cache, v_cache = cache["attn"]["k"][a], cache["attn"]["v"][a]
        k_cache[:, cache_len:cache_len + T] = kk.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + T] = vv.to(v_cache.dtype)
        out = L.decode_attention(q, k_cache, v_cache, kv_len=cache_len + 1)
        x = x + torch.einsum("btnh,nhd->btd", out, shared["attn"]["wo"])
        x = x + L.apply_mlp(cfg, shared["mlp"],
                            L.apply_norm(cfg, shared["mlp_norm"], x))
        for j in range(per):
            p = tf._layer(tree["mamba_blocks"], a * per + j)
            state = {k: cache["ssm"][k][a, j] for k in ("ssm", "conv")}
            x, new = mamba2.mamba_block_decode(cfg, p, x, state)
            for k in ("ssm", "conv"):
                cache["ssm"][k][a, j] = new[k]
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :]), cache
