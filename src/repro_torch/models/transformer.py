"""Decoder-only transformer (``repro.models.transformer``): the ``dense``,
``moe`` and ``vlm`` families, and the parts the hybrid family's shared
block uses (attention parameter specs, the QKV projection with RoPE, token
embedding, the LM head).

One config-driven implementation of the reference's decoder: GQA
attention with an optional QKV bias and RoPE, a sliding window, gemma3's
local:global interleave (every ``local_global_ratio + 1``-th layer global,
the others windowed) by per-layer flags, the SwiGLU (or GELU) MLP or the
capacity-routed MoE block (``moe``), and the stub patch-embedding frontend
(``vlm``: precomputed patch embeddings prepended to the text, positions
running over both).  Plain functions over the port's flat ``{path:
tensor}`` params (nested on entry, as the reference indexes them): the
stacked layers run as a Python loop.  ``forward`` is differentiable (the
LM loss trains through it, each layer recomputed in the backward under
``cfg.remat``); ``prefill`` and ``decode_step`` run without grad.
Attention goes through ``kernels.ops.attention``, so on a CUDA device
every forward, prefill and pool pass runs the ``flash_attention`` kernel
(one launch a layer; with grad its backward kernel once a layer too),
with ``window=0`` on global layers and ``window=cfg.sliding_window`` on
local ones, the choice the reference's ``jax.lax.cond`` makes.  Decode
stays on ``layers.decode_attention``, as in the reference.
``decode_step`` writes the new token's keys and values into the cache it
is given, in place, and returns it (the reference's engine donates the
cache to the step).

The MoE block is the reference's single-device path (``_moe_local``):
fp32 router, top-k experts by probability (ties to the lower index, as
``jax.lax.top_k``), capacity slots by a running count over the token-major
copies, the overflow dropped, ``k`` scatters into an (E, cap + 1, D)
buffer, the expert SwiGLU as batched products, and an fp32 combine over
``j = 0..k-1``.  The sharded routes (``_moe_a2a``, the gather and psum
routes of ``_expert_ffn``) are not ported: :func:`moe_block` raises where
the reference would take them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def moe_specs(cfg: ModelConfig, nl: int) -> Dict:
    """The MoE block's params: an fp32 router, the experts' SwiGLU weights
    in the model dtype, and Kimi's always-on shared expert(s) as one MLP."""
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    sp = {
        "router": ParamSpec((nl, D, E), dtype=torch.float32),
        "w_gate": ParamSpec((nl, E, D, Fe), dtype=bf16),
        "w_up": ParamSpec((nl, E, D, Fe), dtype=bf16),
        "w_down": ParamSpec((nl, E, Fe, D), dtype=bf16),
    }
    if cfg.num_shared_experts:
        sp["shared"] = L.mlp_specs(cfg, stacked=nl,
                                   d_ff=cfg.num_shared_experts * cfg.d_ff)
    return sp


FAMILIES = ("dense", "moe", "vlm")


def specs(cfg: ModelConfig) -> Dict:
    """The decoder's parameter specs: the layers stacked on a leading
    ``num_layers`` axis, an untied ``lm_head`` unless the embedding is
    tied."""
    if cfg.family not in FAMILIES:
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
            "mlp": moe_specs(cfg, nl) if cfg.family == "moe"
            else L.mlp_specs(cfg, stacked=nl),
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


def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings (B, T, D); with ``patch_embeds`` (B, P, D) those
    are cast to the embedding's dtype and prepended (the VLM's stub
    frontend)."""
    x = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def lm_head_weight(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def logits_fn(cfg: ModelConfig, params: Dict,
              hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ lm_head_weight(cfg, params)


# ---------------------------------------------------------------------------
# MoE block (the reference's single-device path)
# ---------------------------------------------------------------------------


def _expert_ffn(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert FFN over bucketed tokens buf (E, cap, D): the
    ``ecd,edf->ecf`` products as batched matmuls, the gate's silu in
    fp32 (the local branch of the reference's ``_expert_ffn``)."""
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, p["w_down"])


def _bucket_by(ids: torch.Tensor, n_buckets: int, cap: int):
    """Scatter positions for copies with bucket ``ids`` (invalid ==
    n_buckets): each copy's slot is the count of earlier copies in its
    bucket.  Returns (bucket, slot, keep): copies at slot < cap are kept,
    the rest go to bucket 0, slot ``cap`` (the trash slot)."""
    # bucket-major, so the running count is a scan along the inner dim
    # (along the outer one PyTorch's CUDA scan took 13 ms at dbrx's 65,536
    # copies)
    onehot = F.one_hot(ids.long(), n_buckets + 1).T.contiguous()
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(0) - 1
    keep = (ids < n_buckets) & (pos < cap)
    zero = torch.zeros((), dtype=ids.dtype, device=ids.device)
    return (torch.where(keep, ids, zero),
            torch.where(keep, pos, torch.full_like(pos, cap)), keep)


def _route(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """x (n, D) -> (top_p, top_e) (n, k): the fp32 router's softmax, its
    top ``k`` experts in descending probability with ties to the lower
    index (``jax.lax.top_k``'s order, which ``torch.topk`` on CUDA does
    not promise; a stable descending sort keeps it), and their
    probabilities renormalized to sum to 1."""
    k = min(cfg.experts_per_token, cfg.num_experts)
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens: ceil(n k / E * cf), at most
    n k and at least min(n k, 16)."""
    nk = n * min(cfg.experts_per_token, cfg.num_experts)
    cap = int(math.ceil(nk / cfg.num_experts * cfg.moe_capacity_factor))
    return max(min(cap, nk), min(nk, 16))


def _slots(cfg: ModelConfig, top_e: torch.Tensor):
    """Each copy's (expert, slot, kept) over the token-major flat (n k,)
    order, each (n, k), and the capacity."""
    n, k = top_e.shape
    cap = capacity(cfg, n)
    dest_e, dest_c, keep = _bucket_by(top_e.reshape(-1), cfg.num_experts,
                                      cap)
    return (dest_e.reshape(n, k), dest_c.reshape(n, k), keep.reshape(n, k),
            cap)


def _moe_local(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The MoE over x (n, D) on one device, every expert local."""
    n, D = x.shape
    top_p, top_e = _route(cfg, p, x)
    dest_e, dest_c, keep, cap = _slots(cfg, top_e)
    # dispatch: k scatters of (n, D); kept slots are unique, so each holds
    # its copy exactly, and the trash slot only sums zeros
    buf = torch.zeros((cfg.num_experts, cap + 1, D), dtype=x.dtype,
                      device=x.device)
    for j in range(top_e.shape[1]):
        vals = torch.where(keep[:, j, None], x, torch.zeros_like(x))
        buf.index_put_((dest_e[:, j], dest_c[:, j]), vals, accumulate=True)
    out_buf = _expert_ffn(p, buf[:, :cap])                 # (E, cap, D)
    # combine in fp32, j = 0..k-1 in order, then cast
    out = torch.zeros((n, D), dtype=torch.float32, device=x.device)
    for j in range(top_e.shape[1]):
        rows = out_buf[dest_e[:, j], torch.clamp(dest_c[:, j], max=cap - 1)]
        w = torch.where(keep[:, j], top_p[:, j],
                        torch.zeros_like(top_p[:, j])).float()
        out = out + rows.float() * w[:, None]
    return out.to(x.dtype)


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), plus the shared expert where the config
    has one.  ``mesh`` (anything with ``axis_names`` and
    ``devices.shape``, as a JAX mesh) of more than one device is where the
    reference shards the experts: not ported, so it raises."""
    if mesh is not None and math.prod(mesh.devices.shape) > 1:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        raise NotImplementedError(
            f"the sharded MoE routes (a2a, gather, psum) over mesh {sizes} "
            f"are not ported: the port's MoE runs on one device")
    B, S, D = x.shape
    out = _moe_local(cfg, p, x.reshape(B * S, D)).reshape(B, S, D)
    if cfg.num_shared_experts:
        out = out + L.apply_mlp(cfg, p["shared"], x)
    return out


def _ffn(cfg: ModelConfig, p: Dict, xn: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward half: the MoE block or the MLP."""
    if cfg.family == "moe":
        return moe_block(cfg, p, xn)
    return L.apply_mlp(cfg, p, xn)


# ---------------------------------------------------------------------------
# the decoder: blocks, forward, prefill, decode
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
    x = x + _ffn(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x))
    cache = {"k": kk.to(cfg.torch_dtype), "v": vv.to(cfg.torch_dtype)} \
        if with_cache else None
    return x, cache


def _layer(blocks: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked block params (views, no copies)."""
    return P.tree_map(lambda a: a[i], blocks)


def _scan_blocks(cfg: ModelConfig, tree: Dict, x: torch.Tensor,
                 positions: torch.Tensor, with_cache: bool = False):
    """The reference's layer scan as a loop over the stacked layers, each
    recomputed in the backward under ``remat`` (``L.remat``); with
    ``with_cache`` also the stacked K/V cache (L, B, T, Hk, hd)."""
    if not with_cache:
        for i, flag in enumerate(_layer_flags(cfg)):
            def body(h, p=_layer(tree["blocks"], i), flag=flag):
                return _block(cfg, p, h, positions=positions,
                              is_global=flag)[0]
            x = L.remat(cfg, body, x)
        return x, None
    caches = []
    for i, flag in enumerate(_layer_flags(cfg)):
        x, c = _block(cfg, _layer(tree["blocks"], i), x,
                      positions=positions, is_global=flag, with_cache=True)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor], with_cache: bool):
    tree = P.nest(params)
    x = embed_tokens(cfg, tree, tokens, patch_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _scan_blocks(cfg, tree, x, positions, with_cache)
    return L.apply_norm(cfg, tree["final_norm"], x), caches


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, T) [and patch_embeds (B, P, D)] -> final hidden states
    (B, P + T, D); differentiable (the training loss's forward)."""
    return _forward_impl(cfg, params, tokens, patch_embeds,
                         with_cache=False)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None):
    """Forward that also returns the stacked KV cache {"k", "v"}
    (L, B, P + T, Hk, hd) in the config's dtype."""
    return _forward_impl(cfg, params, tokens, patch_embeds,
                         with_cache=True)


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
        x = x + _ffn(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x))
    hidden = L.apply_norm(cfg, tree["final_norm"], x)
    return logits_fn(cfg, tree, hidden[:, -1:, :]), cache
