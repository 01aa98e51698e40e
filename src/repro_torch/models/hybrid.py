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

Under ``fsdp_tp_seq`` and ``seq_serve`` the sequence is split over "model"
(``transformer.seq_split``): each rank computes its block of positions,
the shared block attending from them over the keys and values gathered
along the axis (``flash_attention`` at ``q_offset``), each Mamba layer
with its conv halo and incoming state (``mamba2._split_ssd``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import whole_tree
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


def _shared(tree: Dict, mesh):
    """The shared block's params at their use: over a mesh, its
    attention's and MLP's tensor-parallel dims this rank's blocks (the
    dense block's rule), the rest gathered."""
    return shd.layer(tree["shared"], None, mesh, tf._TP_KEEP) \
        if mesh is not None else tree["shared"]


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  with_cache: bool, mesh=None, max_seq=None,
                  whole: bool = True):
    tree = P.nest(params)
    x = tf.embed_tokens(cfg, tree, tokens, mesh=mesh)
    split = tf.cache_split(mesh, max_seq or x.shape[1], cfg.num_kv_heads) \
        if with_cache else None
    seq = tf.seq_split(cfg, mesh, x.shape[1])
    x = tf.seq_block(x, seq)
    # this rank's positions of the sequence, RoPE offset to them
    positions = (0 if seq is None else seq.start) + torch.arange(
        x.shape[1], device=x.device)
    na, per = _n_apps(cfg), cfg.shared_attn_every
    attn_caches, ssm_states, lay = [], [], None
    if not with_cache:
        # one application of the shared block and its group of mamba2
        # blocks, recomputed in the backward under cfg.remat (the
        # reference's checkpointed scan body)
        # (the weights gathered inside it, over a mesh)
        def group(h, a):
            h = tf._block(cfg, _shared(tree, mesh), h,
                          positions=positions, is_global=True, mesh=mesh,
                          seq=seq)[0]
            for j in range(per):
                h = mamba2.mamba_block(cfg, mamba2.mamba_layer(
                    tree["mamba_blocks"], a * per + j, mesh), h, mesh, seq)
            return h
        for a in range(na):
            x = L.remat(cfg, group, x, a)
        hidden = L.apply_norm(cfg, whole_tree(tree["final_norm"], mesh), x)
        return tf.seq_whole(hidden, seq, whole), None
    for a in range(na):
        # the shared block is the dense family's block (causal, no
        # window), one set of weights at every application
        x, attn_cache = tf._block(cfg, _shared(tree, mesh), x,
                                  positions=positions, is_global=True,
                                  with_cache=True, mesh=mesh, seq=seq,
                                  split=split)
        attn_caches.append(attn_cache)
        for j in range(per):
            p = mamba2.mamba_layer(tree["mamba_blocks"], a * per + j, mesh)
            lay = lay or mamba2.state_layouts(cfg, p, x.shape[0], mesh)
            x, st = mamba2.mamba_block_with_state(cfg, p, x, mesh, seq)
            ssm_states.append(mamba2.to_cache(mamba2.last_states(st, seq),
                                              lay, mesh))
    hidden = tf.seq_whole(
        L.apply_norm(cfg, whole_tree(tree["final_norm"], mesh), x), seq,
        whole)
    attn = {k: torch.stack([c[k] for c in attn_caches]) for k in ("k", "v")}
    ssm = {k: torch.stack([s[k] for s in ssm_states]).unflatten(0, (na, per))
           for k in ("ssm", "conv")}
    return hidden, (attn, ssm)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            mesh=None, whole: bool = True) -> torch.Tensor:
    """tokens (B, T) -> final hidden states (B, T, D); differentiable
    (on a CUDA device through the backward kernels).  With a ``mesh`` the
    batch is this rank's rows, the shared block and each mamba2 mixer
    compute on the rank's heads and columns where the policy splits them,
    and storage dims are gathered at their use; under ``fsdp_tp_seq`` or
    ``seq_serve`` each rank computes its block of positions, the hidden
    states gathered after the final norm, or left as this rank's with
    ``whole=False`` (the loss's)."""
    return _forward_impl(cfg, params, tokens, with_cache=False, mesh=mesh,
                         whole=whole)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            mesh=None, max_seq=None):
    """Forward that also returns the caches: {"attn": {"k", "v"}
    (apps, B, T, Hk, hd), "ssm": {"ssm" (apps, per, B, H, hd, N) fp32,
    "conv" (apps, per, B, K-1, d_inner)}}; over a ``mesh`` this rank's
    block of a ``max_seq`` cache (:func:`cache_specs`)."""
    hidden, (attn, ssm) = _forward_impl(cfg, params, tokens,
                                        with_cache=True, mesh=mesh,
                                        max_seq=max_seq)
    return hidden, {"attn": attn, "ssm": ssm}


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                mesh=None) -> Dict[str, Dict[str, Tuple]]:
    """{part: {leaf: (shape, dtype)}} of a ``seq_len`` cache; over a
    ``mesh`` this rank's block: the attention caches' positions, or their
    kv heads where the sequence leaves "model" (``transformer.
    cache_split``), and the states' heads and conv columns
    (``mamba2.cache_specs``)."""
    na, per = _n_apps(cfg), cfg.shared_attn_every
    S, Hk = tf.cache_block(mesh, seq_len, cfg.num_kv_heads)
    kv = ((na, batch, S, Hk, cfg.resolved_head_dim), cfg.torch_dtype)
    ssm = {k: ((na, per) + shape[1:], dtype) for k, (shape, dtype)
           in mamba2.cache_specs(cfg, batch, seq_len, mesh).items()}
    return {"attn": {"k": kv, "v": kv}, "ssm": ssm}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda", mesh=None) -> Dict:
    return {part: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in leaves.items()}
            for part, leaves
            in cache_specs(cfg, batch, seq_len, mesh).items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int, mesh=None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache with this token written in, in place).  With a ``mesh`` the
    tokens and the caches are this rank's rows and blocks."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = tf.embed_tokens(cfg, tree, tokens, mesh=mesh)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    shared = _shared(tree, mesh)
    split = tf.cache_split(mesh, max_seq, cfg.num_kv_heads)
    na, per = _n_apps(cfg), cfg.shared_attn_every
    lay = None
    for a in range(na):
        x = x + tf._decode_attention(cfg, shared["attn"], x, positions,
                                     cache["attn"]["k"][a],
                                     cache["attn"]["v"][a], cache_len, 0,
                                     mesh, split)
        x = x + tf._mlp(cfg, shared["mlp"],
                        L.apply_norm(cfg, shared["mlp_norm"], x), mesh)
        for j in range(per):
            p = mamba2.mamba_layer(tree["mamba_blocks"], a * per + j, mesh)
            lay = lay or mamba2.state_layouts(cfg, p, x.shape[0], mesh)
            state = mamba2.from_cache(
                {k: cache["ssm"][k][a, j] for k in ("ssm", "conv")}, lay,
                mesh)
            x, new = mamba2.mamba_block_decode(cfg, p, x, state, mesh)
            new = mamba2.to_cache(new, lay, mesh)
            for k in ("ssm", "conv"):
                cache["ssm"][k][a, j] = new[k]
    hidden = L.apply_norm(cfg, whole_tree(tree["final_norm"], mesh), x)
    return tf.logits_fn(cfg, tree, hidden[:, -1:, :], mesh), cache
