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

Over a mesh (a ``sharding.MeshView`` with a policy) each layer computes
where the policy places the work, as GSPMD does for the reference: a
weight dim split over "model" under ``tp`` / ``fsdp_tp`` is
tensor-parallel (``sharding.tp_dims``), so q, k and v come from this
rank's heads of ``wq`` / ``wk`` / ``wv``, attention runs on those heads
(each rank given the kv heads its q heads read where kv stays whole), and
the products with ``wo`` and ``w_down`` are summed over "model" after
them; the MLP takes its ``w_gate`` / ``w_up`` columns and ``w_down`` rows;
the embedding looks up this rank's vocabulary rows and sums over "model";
the head gives this rank's logits (gathered for decode).  Dims whose axis
splits the rows (``embed`` over "data" under ``fsdp_tp``, every dim under
``fsdp``, every dim over "model" under ``fsdp_tp_seq``) are gathered at
their use.  Under ``fsdp_tp_seq`` and ``seq_serve`` the sequence is split
over "model" (:func:`seq_split`): each rank computes its block of
positions, attends from them over the keys and values gathered along the
axis (the ``flash_attention`` kernel at ``q_offset``; ``seq_serve``'s
sliding-window layers exchange a halo instead), and the MoE's islands
take its rows' whole sequence.  Every sum is ``collectives.psum``
with a summing backward: the sharded step's loss is the sum of the ranks'
losses, so each collective is its exact transpose.  A serving cache is
split as the reference's ``("layers", "cache_batch", "cache_seq", "kv",
None)`` lays it out (``sharding.cache_pspec``): each rank holds its rows
and its block of positions, or, where the sequence does not divide
"model", its kv heads; a prefill writes its own block, and decode over a
split sequence is flash-decode (each rank's block of the cache gives a
partial state, the states merged across the sequence's axes in block
order, the position's owner writing the token's K/V), over split kv heads
each rank's query heads attend to their own kv heads.

The MoE block (``_moe_local``): fp32 router, top-k experts by
probability (ties to the lower index, as ``jax.lax.top_k``), capacity
slots by a running count over the token-major copies, the overflow
dropped, ``k`` scatters into an (E, cap + 1, D) buffer, the expert SwiGLU
as batched products, and an fp32 combine over ``j = 0..k-1``.  Over a
mesh of ranks (:func:`moe_sharded`) it takes the reference's sharded
routes: replicate + psum (experts over "model", the shares summed),
token-routing ``_moe_a2a`` on ``all_to_all``, and ``_expert_ffn``'s
gather route (bf16 or int8) and psum route over "data", through the
differentiable collectives of ``distributed.collectives``.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models.param import ParamSpec


def attention_specs(cfg: ModelConfig, nl: int) -> Dict:
    """Attention params; nl == 0 -> unstacked (single shared block)."""
    hd = cfg.resolved_head_dim
    s, a = ((nl,), ("layers",)) if nl else ((), ())
    bf16 = torch.bfloat16
    sp = {
        "norm": L.norm_specs(cfg, stacked=nl),
        "wq": ParamSpec(s + (cfg.d_model, cfg.num_heads, hd), dtype=bf16,
                        logical=a + ("embed", "heads", None)),
        "wk": ParamSpec(s + (cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=a + ("embed", "kv", None)),
        "wv": ParamSpec(s + (cfg.d_model, cfg.num_kv_heads, hd), dtype=bf16,
                        logical=a + ("embed", "kv", None)),
        "wo": ParamSpec(s + (cfg.num_heads, hd, cfg.d_model), dtype=bf16,
                        logical=a + ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec(s + (cfg.num_heads, hd), init="zeros",
                             dtype=bf16, logical=a + ("heads", None))
        sp["bk"] = ParamSpec(s + (cfg.num_kv_heads, hd), init="zeros",
                             dtype=bf16, logical=a + ("kv", None))
        sp["bv"] = ParamSpec(s + (cfg.num_kv_heads, hd), init="zeros",
                             dtype=bf16, logical=a + ("kv", None))
    return sp


def moe_specs(cfg: ModelConfig, nl: int) -> Dict:
    """The MoE block's params: an fp32 router, the experts' SwiGLU weights
    in the model dtype, and Kimi's always-on shared expert(s) as one MLP."""
    E, D, Fe = cfg.num_experts, cfg.d_model, cfg.d_ff
    bf16 = torch.bfloat16
    sp = {
        "router": ParamSpec((nl, D, E), dtype=torch.float32,
                            logical=("layers", "embed", None)),
        "w_gate": ParamSpec((nl, E, D, Fe), dtype=bf16,
                            logical=("layers", "expert", "embed",
                                     "expert_mlp")),
        "w_up": ParamSpec((nl, E, D, Fe), dtype=bf16,
                          logical=("layers", "expert", "embed",
                                   "expert_mlp")),
        "w_down": ParamSpec((nl, E, Fe, D), dtype=bf16,
                            logical=("layers", "expert", "expert_mlp",
                                     "embed")),
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
                           dtype=bf16, logical=("vocab", "embed")),
        "blocks": {
            "attn": attention_specs(cfg, nl),
            "mlp_norm": L.norm_specs(cfg, stacked=nl),
            "mlp": moe_specs(cfg, nl) if cfg.family == "moe"
            else L.mlp_specs(cfg, stacked=nl),
        },
        "final_norm": L.norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=bf16,
                                  logical=("embed", "vocab"))
    if cfg.num_classes:
        sp["cls_head"] = ParamSpec((cfg.d_model, cfg.num_classes),
                                   dtype=bf16, logical=("embed", None))
    return sp


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> q (B, T, H, hd), k and v (B, T, Hk, hd); this rank's
    heads where ``wq`` / ``wk`` / ``wv`` are blocks (``sharding.Local``)."""
    w = {k: shd.local(v) for k, v in p.items() if k != "norm"}
    xn = L.apply_norm(cfg, p["norm"], x)
    q = torch.einsum("btd,dnh->btnh", xn, w["wq"])
    kk = torch.einsum("btd,dnh->btnh", xn, w["wk"])
    vv = torch.einsum("btd,dnh->btnh", xn, w["wv"])
    if cfg.qkv_bias:
        q, kk, vv = q + w["bq"], kk + w["bk"], vv + w["bv"]
    if cfg.pos_embed == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        kk = L.apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None,
                 mesh=None) -> torch.Tensor:
    """Token embeddings (B, T, D); with ``patch_embeds`` (B, P, D) those
    are cast to the embedding's dtype and prepended (the VLM's stub
    frontend).  Over ``mesh`` the embedding takes the rule
    (``sharding.block``): a vocabulary split over "model" looks up this
    rank's rows (zero for other tokens) and sums over the axis, exactly."""
    x = lookup(params["embed"], tokens, mesh)
    if cfg.tie_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def lookup(embed, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rows of the (V, D) table ``embed`` for ``tokens``; over
    ``mesh`` under the rule (``sharding.block``): a vocabulary split over
    "model" looks up this rank's rows (zero for other tokens) and sums
    over the axis, exactly."""
    w = shd.block(embed, mesh)
    if not isinstance(w, shd.Local):
        return w[tokens.long()]
    v0 = shd.block_start(w.spec[0], w.t.shape[0], mesh)
    idx = tokens.long() - v0
    mine = (idx >= 0) & (idx < w.t.shape[0])
    x = w.t[idx.clamp(0, w.t.shape[0] - 1)]
    return _tp_sum(torch.where(mine[..., None], x, torch.zeros_like(x)),
                   w, 0, mesh)


def lm_head_weight(cfg: ModelConfig, params: Dict,
                   mesh=None) -> torch.Tensor:
    """The (D, V) head: the tied embedding's transpose or ``lm_head``,
    gathered whole over ``mesh`` where it is sharded."""
    if cfg.tie_embeddings:
        return shd.whole(params["embed"], mesh).T
    return shd.whole(params["lm_head"], mesh)


def lm_head_block(cfg: ModelConfig, params: Dict, mesh=None):
    """The (D, V) head under the rule (``sharding.block``): a
    ``sharding.Local`` of this rank's vocabulary columns where the
    vocabulary is tensor-parallel, else the whole head."""
    if not cfg.tie_embeddings:
        return shd.block(params["lm_head"], mesh)
    w = shd.block(params["embed"], mesh)
    if isinstance(w, shd.Local):
        return shd.Local(w.t.T, shd.P(*reversed(w.spec)))
    return w.T


def logits_fn(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """hidden (..., D) -> logits (..., V); over ``mesh`` each rank's
    vocabulary block of them, gathered in vocabulary order."""
    w = lm_head_block(cfg, params, mesh)
    if not isinstance(w, shd.Local):
        return hidden @ w
    out = hidden @ w.t
    return shd.gather(out, (None,) * (out.ndim - 1) + (w.spec[1],), mesh)


def _tp_sum(x: torch.Tensor, w, dim: int, mesh) -> torch.Tensor:
    """``x`` summed over the axes weight ``w``'s ``dim`` is split over
    where ``w`` is a block (``sharding.Local``); ``x`` itself otherwise.
    The sum's backward sums too (the sharded step's convention)."""
    if isinstance(w, shd.Local):
        for a in shd._axes(w.spec[dim]):
            x = C.psum(x, C.Axis.of(mesh, a), varying=True)
    return x


def _mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor, mesh=None
         ) -> torch.Tensor:
    """``L.apply_mlp`` on this rank's columns of ``w_gate`` / ``w_up`` and
    rows of ``w_down`` where they are blocks, summed over their axis
    before the down bias."""
    return L.apply_mlp(cfg, {k: shd.local(v) for k, v in p.items()}, x,
                       reduce=lambda y: _tp_sum(y, p["w_down"], 0, mesh))


def _kv_for_heads(p: Dict, kk: torch.Tensor, vv: torch.Tensor, mesh,
                  num_heads: int):
    """k and v (B, T, Hk, hd) for this rank's query heads where ``wq`` is
    split and ``wk`` whole: the kv heads those query heads read (a
    contiguous run where each is read by as many of them, so that the
    local heads stay a GQA grouping; one per query head otherwise)."""
    wq = p["wq"]
    if not isinstance(wq, shd.Local) or isinstance(p["wk"], shd.Local):
        return kk, vv
    H_loc, Hk = wq.t.shape[1], kk.shape[2]
    h0 = shd.block_start(wq.spec[1], H_loc, mesh)
    G = num_heads // Hk
    idx = [(h0 + j) // G for j in range(H_loc)]
    n = idx[-1] - idx[0] + 1
    if H_loc % n == 0 and idx == [idx[0] + j // (H_loc // n)
                                  for j in range(H_loc)]:
        return kk.narrow(2, idx[0], n), vv.narrow(2, idx[0], n)
    sel = torch.tensor(idx, device=kk.device)
    return kk.index_select(2, sel), vv.index_select(2, sel)


# ---------------------------------------------------------------------------
# MoE block (the reference's single-device path)
# ---------------------------------------------------------------------------


class _Int8Gather(torch.autograd.Function):
    """The int8 gather route's ``custom_vjp``: forward, each rank
    quantizes its shard against a per-expert scale maxed over the axis
    and the int8 payload is all-gathered; backward, the unquantized
    cotangent reduce-scattered (the tiled all-gather's transpose)."""

    @staticmethod
    def forward(ctx, w, dim, axis):
        ctx.dim, ctx.axis, ctx.dtype = dim, axis, w.dtype
        wf = w.float()
        smax = C.all_reduce_max(
            torch.amax(torch.abs(wf), dim=(1, 2), keepdim=True), axis)
        scale = smax / 127.0 + 1e-12
        q8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        qg = C._gather(q8, dim, axis)
        return (qg.float() * scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return (C._reduce_scatter(g, ctx.dim, ctx.axis).to(ctx.dtype),
                None, None)


def _expert_ffn(cfg: ModelConfig, p: Dict, buf: torch.Tensor,
                data: Optional[C.Axis] = None) -> torch.Tensor:
    """SwiGLU expert FFN over bucketed tokens buf (E_loc, cap, D): the
    ``ecd,edf->ecf`` products as batched matmuls, the gate's silu in fp32.

    With the expert FFN dim F sharded over ``data``, the reference's two
    routes: ``gather`` all-gathers the F shards before use (in int8 with
    ``moe_gather_dtype="int8"``), ``psum`` computes with the local F slice
    and sums the partial down-projections over ``data`` in fp32 (valid
    only where every ``data`` rank holds the same tokens, as the
    reference notes)."""
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    if data is not None and cfg.moe_ffn_mode == "gather":
        if cfg.moe_gather_dtype == "int8":
            w_gate = _Int8Gather.apply(w_gate, 2, data)
            w_up = _Int8Gather.apply(w_up, 2, data)
            w_down = _Int8Gather.apply(w_down, 1, data)
        else:
            w_gate = C.all_gather(w_gate, 2, data)
            w_up = C.all_gather(w_up, 2, data)
            w_down = C.all_gather(w_down, 1, data)
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(buf.dtype) * u
    out_buf = torch.bmm(h, w_down)
    if data is not None and cfg.moe_ffn_mode == "psum":
        # the sum feeds each rank's own combine: its transpose sums too
        out_buf = C.psum(out_buf.float(), data, varying=True).to(buf.dtype)
    return out_buf


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


def _cap(nk: int, buckets: int, cf: float) -> int:
    """ceil(nk / buckets * cf), at most nk and at least min(nk, 16)."""
    cap = int(math.ceil(nk / buckets * cf))
    return max(min(cap, nk), min(nk, 16))


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens: ceil(n k / E * cf), at most
    n k and at least min(n k, 16)."""
    nk = n * min(cfg.experts_per_token, cfg.num_experts)
    return _cap(nk, cfg.num_experts, cfg.moe_capacity_factor)


def _slots(cfg: ModelConfig, top_e: torch.Tensor, e0: int = 0,
           n_local: Optional[int] = None):
    """Each copy's (local expert, slot, kept) over the token-major flat
    (n k,) order, each (n, k), and the capacity; experts outside
    [e0, e0 + n_local) go to the trash bucket."""
    n, k = top_e.shape
    n_local = cfg.num_experts if n_local is None else n_local
    cap = capacity(cfg, n)
    flat = top_e.reshape(-1) - e0
    mine = (flat >= 0) & (flat < n_local)
    flat = torch.where(mine, flat, torch.full_like(flat, n_local))
    dest_e, dest_c, keep = _bucket_by(flat, n_local, cap)
    return (dest_e.reshape(n, k), dest_c.reshape(n, k), keep.reshape(n, k),
            cap)


def _combine(out_buf, top_p, dest_e, dest_c, keep, cap, n, D, device):
    """The fp32 combine over j = 0..k-1, in order."""
    out = torch.zeros((n, D), dtype=torch.float32, device=device)
    for j in range(top_p.shape[1]):
        rows = out_buf[dest_e[:, j], torch.clamp(dest_c[:, j], max=cap - 1)]
        w = torch.where(keep[:, j], top_p[:, j],
                        torch.zeros_like(top_p[:, j])).float()
        out = out + rows.float() * w[:, None]
    return out


def _moe_local(cfg: ModelConfig, p: Dict, x: torch.Tensor, e0: int = 0,
               n_local: Optional[int] = None,
               data: Optional[C.Axis] = None) -> torch.Tensor:
    """The MoE over x (n, D) with the local experts [e0, e0 + n_local)
    (every expert by default), their FFN dim over ``data`` when given."""
    n, D = x.shape
    n_local = cfg.num_experts if n_local is None else n_local
    top_p, top_e = _route(cfg, p, x)
    dest_e, dest_c, keep, cap = _slots(cfg, top_e, e0, n_local)
    # dispatch: k scatters of (n, D); kept slots are unique, so each holds
    # its copy exactly, and the trash slot only sums zeros
    buf = torch.zeros((n_local, cap + 1, D), dtype=x.dtype, device=x.device)
    for j in range(top_e.shape[1]):
        vals = torch.where(keep[:, j, None], x, torch.zeros_like(x))
        buf.index_put_((dest_e[:, j], dest_c[:, j]), vals, accumulate=True)
    out_buf = _expert_ffn(cfg, p, buf[:, :cap], data)    # (E_loc, cap, D)
    out = _combine(out_buf, top_p, dest_e, dest_c, keep, cap, n, D, x.device)
    return out.to(x.dtype)


def _moe_a2a(cfg: ModelConfig, p: Dict, x: torch.Tensor, model: C.Axis,
             data: Optional[C.Axis]) -> torch.Tensor:
    """Token-routing expert parallelism: each copy travels over ``model``
    to the rank owning its expert (all-to-all), is computed there, and
    travels back.  x (n_loc, D): this rank's own tokens."""
    n, D = x.shape
    tp = model.size
    e_loc = cfg.num_experts // tp
    cf = cfg.moe_capacity_factor
    top_p, top_e = _route(cfg, p, x)
    k = top_e.shape[1]
    # dispatch: bucket the copies by destination rank
    flat_e = top_e.reshape(-1)
    cap_s = _cap(n * k, tp, cf)
    dest_r, dest_c, keep = _bucket_by(flat_e // e_loc, tp, cap_s)
    le = torch.where(keep, flat_e % e_loc, torch.full_like(flat_e, e_loc))
    kr, kc, km, lek = (t.reshape(n, k) for t in (dest_r, dest_c, keep, le))
    send_x = torch.zeros((tp, cap_s + 1, D), dtype=x.dtype, device=x.device)
    send_le = torch.full((tp * (cap_s + 1),), e_loc, dtype=flat_e.dtype,
                         device=x.device)
    for j in range(k):
        vals = torch.where(km[:, j, None], x, torch.zeros_like(x))
        send_x.index_put_((kr[:, j], kc[:, j]), vals, accumulate=True)
        send_le.scatter_reduce_(0, kr[:, j] * (cap_s + 1) + kc[:, j],
                                lek[:, j], reduce="amin")
    send_x = send_x[:, :cap_s]
    send_le = send_le.reshape(tp, cap_s + 1)[:, :cap_s]
    recv_x = C.all_to_all(send_x, model)
    recv_le = C._a2a(send_le, model)
    # local expert compute on the received copies
    m = tp * cap_s
    cap_e = _cap(m, max(e_loc, 1), cf)
    be, bc, bkeep = _bucket_by(recv_le.reshape(m), e_loc, cap_e)
    rx = recv_x.reshape(m, D)
    buf = torch.zeros((e_loc, cap_e + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((be, bc), torch.where(bkeep[:, None], rx,
                                         torch.zeros_like(rx)),
                   accumulate=True)
    out_buf = _expert_ffn(cfg, p, buf[:, :cap_e], data)
    # route the results back
    ret = out_buf[be, torch.clamp(bc, max=cap_e - 1)]
    ret = torch.where(bkeep[:, None], ret, torch.zeros_like(ret))
    back = C.all_to_all(ret.reshape(tp, cap_s, D), model)
    out = _combine(back, top_p, kr, kc, km, cap_s, n, D, x.device)
    return out.to(x.dtype)


def moe_sharded(cfg: ModelConfig, p: Dict, x: torch.Tensor, mesh, *,
                force: bool = False) -> torch.Tensor:
    """The reference's sharded MoE (its ``shard_map`` islands) on this
    rank of ``mesh`` (a ``DeviceMesh`` over "data" and/or "model", "pod"):
    ``p`` (the routed params) and ``x`` (B, S, D) are whole, the same on
    every rank, and so is the result.  Experts split over "model"; their
    FFN dim over "data" where "data" has more than one rank; the tokens'
    rows over the batch axes ("pod", "data"), and over "model" too on the
    ``a2a`` route.  Routes, as the reference picks them: ``a2a``
    (``cfg.moe_route``, with tokens divisible over every token axis) or
    replicate + psum, where each "model" rank combines its own experts'
    share and the shares sum over "model".  ``force`` takes every
    collective of the configured route even over axes of one rank (a
    one-rank mesh then runs the routes, not the local block).  Gradients
    are the reference's: each split input's gradient is assembled whole
    again, and a whole input used by several ranks sums theirs."""
    B, S, D = x.shape
    names = tuple(mesh.mesh_dim_names)
    axes = {a: C.Axis.of(mesh, a) for a in names}
    size = {a: axes[a].size for a in names}
    tp = size.get("model", 1)
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{tp} model ranks")
    e_loc = cfg.num_experts // tp
    present = [a for a in ("pod", "data") if a in names]
    batch = [a for a in present if force or size[a] > 1]
    data = "data" if "data" in names and (force or size["data"] > 1)         else None
    n_rows = B * S
    shards = math.prod(size[a] for a in batch)
    a2a = (cfg.moe_route == "a2a" and "model" in names
           and (force or tp > 1) and n_rows % (tp * shards) == 0)
    tok = batch + (["model"] if a2a else [])

    def enter(t, split):
        """``t`` replicated over the mesh axes ``split`` does not use,
        then split: ``{dim: [axis, ...]}`` (major axis first)."""
        used = {a for axs in split.values() for a in axs}
        for a in names:
            if a not in used and size[a] > 1:
                t = C.replicate(t, axes[a])
        for dim, axs in split.items():
            for a in axs:
                t = C.split(t, dim, axes[a])
        return t

    w_split = {0: ["model"] if "model" in names else [],
               2: [data] if data else []}
    wd_split = {0: w_split[0], 1: w_split[2]}
    pl = {"router": enter(p["router"], {}),
          "w_gate": enter(p["w_gate"], w_split),
          "w_up": enter(p["w_up"], w_split),
          "w_down": enter(p["w_down"], wd_split)}
    xl = enter(x.reshape(n_rows, D), {0: tok})
    dax = axes[data] if data else None
    if a2a:
        out = _moe_a2a(cfg, pl, xl, axes["model"], dax)
    else:
        m = axes.get("model")
        e0 = m.rank * e_loc if m is not None else 0
        out = _moe_local(cfg, pl, xl, e0, e_loc, dax)
        if m is not None and (force or tp > 1):
            out = C.psum(out, m)
    for a in reversed(tok):
        out = C.gather(out, 0, axes[a])
    return out.reshape(B, S, D)


def moe_rows(cfg: ModelConfig, p: Dict, x: torch.Tensor,
             view: "shd.MeshView", seq: Optional["SeqSplit"] = None
             ) -> torch.Tensor:
    """The routed MoE inside a sharded model (:class:`shd.MeshView`): ``x``
    (B, S, D) is this rank's rows (split over ``view.rows``), and the
    expert weights come as the policy stores them, each this rank's block
    (a :class:`shd.Local`; the layer's rule takes them as the island's
    own, ``_MOE_KEEP``) or whole.  The reference's ``shard_map`` islands,
    computed on those rows: the tokens' rows over the batch axes ("pod",
    "data"; over "model" too on the ``a2a`` route), experts over "model",
    their FFN dim over "data", which the ``gather`` route gathers (in int8
    with ``moe_gather_dtype="int8"``) and the ``psum`` route computes on;
    rows and weights are moved into that split only where the stored one
    differs (gathered over the axes that differ, then this rank's block
    taken).  The result is this rank's rows.  Over a sequence split
    (``seq``) ``x`` is this rank's block of positions: the islands split
    the flat (row, position) tokens in the reference's order, so the rows'
    whole sequence is gathered along the split's axis first and this
    rank's positions taken from the result.

    Gradients follow the sharded step's convention (the loss is the sum
    of the ranks' losses): every collective's backward is its exact
    transpose, so the replicate + psum route's sum over "model" sums its
    cotangents too, where :func:`moe_sharded` (whole ``x`` on every rank)
    keeps them."""
    if seq is not None:
        x = C.all_gather(x, 1, seq.axis)
    B, Sq, D = x.shape
    names = view.mesh_dim_names
    axes = {a: C.Axis.of(view, a) for a in names}
    size = {a: axes[a].size for a in names}
    tp = size.get("model", 1)
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{tp} model ranks")
    e_loc = cfg.num_experts // tp
    batch = [a for a in ("pod", "data") if view.active(a)]
    data = "data" if view.active("data") else None
    model = "model" if view.active("model") else None
    n_rows = B * Sq * math.prod(size[a] for a in view.rows)
    shards = math.prod(size[a] for a in batch)
    a2a = (cfg.moe_route == "a2a" and model is not None
           and n_rows % (tp * shards) == 0)
    want = batch + (["model"] if a2a else [])
    xf = shd.rows_to(x.reshape(B * Sq, D), view.rows, want, view)

    def expert_w(w, f_dim):
        """An expert weight (E, D, F) or (E, F, D) split as the routes
        take it: experts over "model", F over "data"."""
        w = w if isinstance(w, shd.Local) else shd.Local(w, shd.P())
        target = [model, None, None]
        target[f_dim] = data
        return shd.relayout(w.t, w.spec, target, view)

    pl = {"router": shd.whole(p["router"], view),
          "w_gate": expert_w(p["w_gate"], 2),
          "w_up": expert_w(p["w_up"], 2),
          "w_down": expert_w(p["w_down"], 1)}
    dax = axes[data] if data else None
    if a2a:
        out = _moe_a2a(cfg, pl, xf, axes["model"], dax)
    else:
        m = axes[model] if model else None
        out = _moe_local(cfg, pl, xf, m.rank * e_loc if m else 0, e_loc,
                         dax)
        if m is not None:
            out = C.psum(out, m, varying=True)
    out = shd.rows_to(out, want, view.rows, view).reshape(B, Sq, D)
    if seq is not None:
        out = out.narrow(1, seq.start, Sq // seq.axis.size)
    return out


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              mesh=None, seq: Optional["SeqSplit"] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), plus the shared expert where the config
    has one.  Inside a sharded model (a :class:`shd.MeshView`) the routed
    part runs on the rank's rows (:func:`moe_rows`; its positions over a
    sequence split ``seq``); on a ``mesh`` of more
    than one rank with ``x`` whole it runs sharded (:func:`moe_sharded`);
    a mesh of one device is the local block, bit for bit, as in the
    reference."""
    B, Sq, D = x.shape
    if isinstance(mesh, shd.MeshView):
        out = moe_rows(cfg, p, x, mesh, seq)
        if cfg.num_shared_experts:
            out = out + _mlp(cfg, p["shared"], x, mesh)
        return out
    sizes = {}
    if mesh is not None:
        from repro_torch.distributed.sharding import mesh_axis_sizes
        sizes = mesh_axis_sizes(mesh)
    if math.prod(sizes.values()) > 1:
        if not hasattr(mesh, "mesh_dim_names"):
            raise ValueError(
                f"the sharded MoE routes over mesh {sizes} run on ranks: "
                f"pass the DeviceMesh of an initialized process group "
                f"(launch.mesh)")
        out = moe_sharded(cfg, p, x, mesh)
    else:
        out = _moe_local(cfg, p, x.reshape(B * Sq, D)).reshape(B, Sq, D)
    if cfg.num_shared_experts:
        out = out + L.apply_mlp(cfg, p["shared"], x)
    return out


def _ffn(cfg: ModelConfig, p: Dict, xn: torch.Tensor,
         mesh=None, seq: Optional["SeqSplit"] = None) -> torch.Tensor:
    """The block's feed-forward half: the MoE block or the MLP."""
    if cfg.family == "moe":
        return moe_block(cfg, p, xn, mesh, seq)
    return _mlp(cfg, p, xn, mesh)


# the block params a layer takes under the policy's rule (``shd.layer``'s
# ``keep``, each path with the axes its consumer moves itself): the
# attention's and MLP's tensor-parallel dims stay this rank's blocks; the
# MoE's routed experts reach its shard_map island as stored (``moe_rows``)
_TP_KEEP = {"attn": (), "mlp": ()}
_MOE_KEEP = {**_TP_KEEP, **{f"mlp.{k}": ("pod", "data", "model")
                            for k in ("w_gate", "w_up", "w_down")}}


def _keep(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """The block params a layer takes under the rule (``shd.layer``)."""
    return _MOE_KEEP if cfg.family == "moe" else _TP_KEEP


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


class SeqSplit(NamedTuple):
    """A sequence split over "model": this rank's positions [start, start
    + total / axis size) of ``total`` along ``axis``; ``halo``: its
    sliding-window layers may exchange a halo (``seq_serve``, the
    reference's ``use_halo``) rather than gather."""
    axis: C.Axis
    start: int
    total: int
    halo: bool


# the policies whose activations' sequence is split over "model"
SEQ_POLICIES = ("seq_serve", "fsdp_tp_seq")


def splits_seq(policy: Optional[str], model: int, T: int) -> bool:
    """Whether ``policy`` splits a ``T``-position sequence over a "model"
    axis of ``model`` ranks: it splits the activations' sequence
    (``SEQ_POLICIES``) and ``model`` divides ``T``."""
    return policy in SEQ_POLICIES and T % model == 0


def seq_split(cfg: ModelConfig, mesh, T: int) -> Optional[SeqSplit]:
    """The split of a ``T``-position sequence on ``mesh`` (a
    ``MeshView``): a decoder's positions (a VLM's patches included), or
    whisper's encoder frames.  It applies where the mesh's policy (the
    config's without one) splits the activations' sequence over "model"
    (``seq_serve``, ``fsdp_tp_seq``), the axis takes collectives (more
    than one rank, or forced: one block at offset 0) and divides ``T``.
    None otherwise (whisper's 1,500 frames stay whole over 16 ranks), and
    decode (T = 1) never splits.  Every token family splits: the dense,
    MoE and VLM decoders here, the Mamba2 blocks (``mamba2``), zamba2's
    (``hybrid``) and whisper's encoder and decoder (``encdec``)."""
    if not isinstance(mesh, shd.MeshView) \
            or "model" not in mesh.mesh_dim_names:
        return None
    if not mesh.active("model"):
        return None
    policy = mesh.policy or cfg.sharding
    ax = C.Axis.of(mesh, "model")
    if not splits_seq(policy, ax.size, T):
        return None
    return SeqSplit(ax, ax.rank * (T // ax.size), T, policy == "seq_serve")


def seq_block(x: torch.Tensor, seq: Optional[SeqSplit]) -> torch.Tensor:
    """This rank's block of the positions of x (B, T, ...) over a sequence
    split (all of them without one)."""
    return x if seq is None else x.narrow(1, seq.start,
                                          seq.total // seq.axis.size)


def seq_whole(hidden: torch.Tensor, seq: Optional[SeqSplit],
              whole: bool = True) -> torch.Tensor:
    """The ranks' blocks of positions gathered along the split's axis (an
    all-gather, whose backward reduce-scatters), or this rank's block
    where ``whole`` is False."""
    if seq is None or not whole:
        return hidden
    return C.all_gather(hidden, 1, seq.axis)


def _seq_attention(cfg: ModelConfig, q, kk, vv, seq: SeqSplit, window: int,
                   mesh, kv_chunk: int):
    """Attention over a sequence split along "model": under ``seq_serve``
    a sliding-window layer exchanges a window-sized halo
    (``halo_window_attention``) where the window fits in a shard (the
    reference's ``use_halo``) and no gradient is wanted (the exchange has
    none); any other layer gathers K and V over "model" (an all-gather,
    whose backward reduce-scatters) and attends from this rank's positions
    (``q_offset``).  Both go through ``ops.attention``: the
    ``flash_attention`` kernel pair on a card."""
    T_loc = q.shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, kk, vv))
    if seq.halo and window and cfg.sliding_window <= T_loc and not grad:
        from repro_torch.serving.halo_attention import halo_window_attention
        return halo_window_attention(q, kk, vv, window=window, mesh=mesh,
                                     axis="model")
    K, V = C.all_gather(kk, 1, seq.axis), C.all_gather(vv, 1, seq.axis)
    return ops.attention(q, K, V, causal=True, window=window,
                         q_offset=seq.start, kv_chunk=kv_chunk)


# the reference's logical axes of a KV cache (its ``cache_specs``)
KV_LOGICAL = ("layers", "cache_batch", "cache_seq", "kv", None)


class CacheSplit(NamedTuple):
    """How a serving KV cache splits on a mesh (``shd.cache_pspec`` of
    :data:`KV_LOGICAL`): its positions over the mesh axes ``axes`` (major
    first; this rank holds [start, start + size)) and its kv heads over
    ``kv``; either may be empty."""
    axes: Tuple[str, ...]
    start: int
    size: int
    kv: Tuple[str, ...] = ()


def cache_split(mesh, seq_len: Optional[int], kv_heads: int,
                logical: Tuple = KV_LOGICAL) -> Optional[CacheSplit]:
    """How a cache of ``seq_len`` positions and ``kv_heads`` kv heads
    laid out as ``logical`` says splits on ``mesh`` (a ``MeshView``): the
    reference's greedy rule, under which the sequence takes the policy's
    ``cache_seq`` axes that divide it and the kv heads take "model" where
    the sequence left it.  None where the cache is whole."""
    if not isinstance(mesh, shd.MeshView):
        return None
    if seq_len is None:
        raise ValueError("a cache on a mesh splits by its whole length: "
                         "pass max_seq")
    spec = shd.cache_pspec(mesh, (1, 1, seq_len, kv_heads, 1), logical)
    axes, kv = shd._axes(spec[2]), shd._axes(spec[3])
    if not axes and not kv:
        return None
    size = seq_len // math.prod(mesh.sizes()[a] for a in axes)
    return CacheSplit(axes, shd.block_start(axes, size, mesh), size, kv)


def _own(t: torch.Tensor, split: Optional[CacheSplit],
         T: int) -> torch.Tensor:
    """This rank's positions of a (B, T, ...) cache entry (all of them
    where the split leaves the sequence whole)."""
    if split is None or not split.axes:
        return t
    lo = min(split.start, T)
    return t.narrow(1, lo, max(min(T, split.start + split.size) - lo, 0))


def kv_as_cached(wk, kk: torch.Tensor, vv: torch.Tensor, mesh,
                 kv: Tuple[str, ...]):
    """k and v (B, T, Hk or its block, hd), computed on ``wk``'s heads,
    with the kv heads a cache split over the axes ``kv`` holds: this
    rank's where ``kv`` names axes, every head otherwise (moved only where
    the two splits differ)."""
    have = (None, None, wk.spec[1] if isinstance(wk, shd.Local) else None,
            None)
    want = (None, None, tuple(kv) or None, None)
    return (shd.relayout(kk, have, want, mesh),
            shd.relayout(vv, have, want, mesh))


def _cache_of(cfg: ModelConfig, pa: Dict, kk: torch.Tensor,
              vv: torch.Tensor, mesh, seq: Optional[SeqSplit],
              split: Optional[CacheSplit], T: int) -> Dict:
    """A layer's cache entries from its k and v (B, T or T_loc, Hk, hd),
    in the config's dtype: the kv heads the split holds
    (:func:`kv_as_cached`) at this rank's positions.  Over a split
    sequence those are its block of them: narrowed from the whole prompt,
    or, after a sequence-split prefill, moved by an all-to-all from the
    ranks that computed them; otherwise the whole prompt (a split
    prefill's gathered)."""
    kk, vv = kv_as_cached(pa["wk"], kk, vv, mesh, split.kv if split else ())
    out = []
    for t in (kk, vv):
        if seq is not None and split is not None \
                and split.axes == ("model",):
            M, T_loc = seq.axis.size, t.shape[1]
            t = C.repartition(t, 1, [(r * T_loc, (r + 1) * T_loc)
                                     for r in range(M)],
                              [(r * split.size, min(T, (r + 1) * split.size))
                               for r in range(M)], seq.axis)
        else:
            if seq is not None:
                t = C.gather(t, 1, seq.axis)
            t = _own(t, split, T)
        out.append(t.to(cfg.torch_dtype))
    return {"k": out[0], "v": out[1]}


def _block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
           positions: torch.Tensor, is_global: bool, kv_chunk: int = 1024,
           with_cache: bool = False, mesh=None,
           seq: Optional[SeqSplit] = None,
           split: Optional[CacheSplit] = None):
    pa = p["attn"]
    q, kk, vv = _qkv(cfg, pa, x, positions)
    T = x.shape[1] if seq is None else seq.total
    ck = min(kv_chunk, T, L.pick_kv_chunk(x.shape[0], T, cfg.num_heads))
    ka, va = _kv_for_heads(pa, kk, vv, mesh, cfg.num_heads)
    if seq is None:
        out = ops.attention(q, ka, va, causal=True,
                            window=_window(cfg, is_global), kv_chunk=ck)
    else:
        out = _seq_attention(cfg, q, ka, va, seq, _window(cfg, is_global),
                             mesh, ck)
    x = x + _tp_sum(torch.einsum("btnh,nhd->btd", out, shd.local(pa["wo"])),
                    pa["wo"], 0, mesh)
    x = x + _ffn(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x), mesh,
                 seq)
    cache = _cache_of(cfg, pa, kk, vv, mesh, seq, split, T) \
        if with_cache else None
    return x, cache


def _layer(blocks: Dict, i: int, mesh=None, keep=None) -> Dict:
    """Layer ``i`` of the stacked block params: views, no copies; over a
    ``mesh`` each sharded leaf's block gathered whole, but those under
    ``keep``, which take the policy's rule (``shd.layer``)."""
    if mesh is None:
        return P.tree_map(lambda a: a[i], blocks)
    return shd.layer(blocks, i, mesh, keep=keep)


def _scan_blocks(cfg: ModelConfig, tree: Dict, x: torch.Tensor,
                 positions: torch.Tensor, with_cache: bool = False,
                 mesh=None, seq: Optional[SeqSplit] = None,
                 split: Optional[CacheSplit] = None):
    """The reference's layer scan as a loop over the stacked layers, each
    recomputed in the backward under ``remat`` (``L.remat``); with
    ``with_cache`` also the stacked K/V cache (L, B, T, Hk, hd), this
    rank's positions of it over a ``split``.  A layer's weights are
    gathered inside the recomputed body, so the backward gathers them
    again rather than keeping every layer whole."""
    keep = _keep(cfg)
    if not with_cache:
        for i, flag in enumerate(_layer_flags(cfg)):
            def body(h, i=i, flag=flag):
                return _block(cfg, _layer(tree["blocks"], i, mesh, keep), h,
                              positions=positions, is_global=flag,
                              mesh=mesh, seq=seq)[0]
            x = L.remat(cfg, body, x)
        return x, None
    caches = []
    for i, flag in enumerate(_layer_flags(cfg)):
        x, c = _block(cfg, _layer(tree["blocks"], i, mesh, keep), x,
                      positions=positions, is_global=flag, with_cache=True,
                      mesh=mesh, seq=seq, split=split)
        caches.append(c)
    return x, {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}


def _forward_impl(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor], with_cache: bool,
                  mesh=None, max_seq: Optional[int] = None,
                  whole: bool = True):
    tree = P.nest(params)
    x = embed_tokens(cfg, tree, tokens, patch_embeds, mesh)
    split = cache_split(mesh, max_seq or x.shape[1], cfg.num_kv_heads) \
        if with_cache else None
    seq = seq_split(cfg, mesh, x.shape[1])
    x = seq_block(x, seq)
    # this rank's positions of the sequence, RoPE offset to them
    positions = (0 if seq is None else seq.start) + torch.arange(
        x.shape[1], device=x.device)
    x, caches = _scan_blocks(cfg, tree, x, positions, with_cache, mesh, seq,
                             split)
    hidden = L.apply_norm(cfg, shd.whole_tree(tree["final_norm"], mesh), x)
    return seq_whole(hidden, seq, whole), caches


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None,
            mesh=None, whole: bool = True) -> torch.Tensor:
    """tokens (B, T) [and patch_embeds (B, P, D)] -> final hidden states
    (B, P + T, D); differentiable (the training loss's forward).  With a
    ``mesh`` (``distributed.sharding.MeshView``) the batch is this rank's
    rows, each layer computes on the blocks of its tensor-parallel dims
    and gathers its storage dims, and under ``fsdp_tp_seq`` or
    ``seq_serve`` the sequence is split over "model" (:func:`seq_split`):
    the hidden states come back whole (gathered after the final norm), or
    with ``whole=False`` as this rank's positions (the loss's)."""
    return _forward_impl(cfg, params, tokens, patch_embeds,
                         with_cache=False, mesh=mesh, whole=whole)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            patch_embeds: Optional[torch.Tensor] = None, mesh=None,
            max_seq: Optional[int] = None):
    """Forward that also returns the stacked KV cache {"k", "v"}
    (L, B, P + T, Hk, hd) in the config's dtype.  Over a ``mesh`` that
    splits a cache of ``max_seq`` positions (default P + T;
    :func:`cache_split`), each rank's positions of it: (L, B, n, Hk, hd),
    its block's first n positions."""
    return _forward_impl(cfg, params, tokens, patch_embeds,
                         with_cache=True, mesh=mesh, max_seq=max_seq)


def cache_block(mesh, seq_len: int, kv_heads: int) -> Tuple[int, int]:
    """(positions, kv heads) of this rank's block of a ``seq_len`` cache
    of ``kv_heads`` kv heads on ``mesh`` (:func:`cache_split`)."""
    split = cache_split(mesh, seq_len, kv_heads)
    if split is None:
        return seq_len, kv_heads
    return split.size, kv_heads // math.prod(mesh.sizes()[a]
                                             for a in split.kv)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                mesh=None) -> Dict[str, Tuple]:
    """{leaf: (shape, dtype)} of a ``seq_len`` KV cache; over a ``mesh``
    this rank's block of it (``batch``: the rank's rows; its positions
    and kv heads as :func:`cache_split` splits them)."""
    S, Hk = cache_block(mesh, seq_len, cfg.num_kv_heads)
    shape = (cfg.num_layers, batch, S, Hk, cfg.resolved_head_dim)
    return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda", mesh=None) -> Dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype)
            in cache_specs(cfg, batch, seq_len, mesh).items()}


def cache_attention(q: torch.Tensor, wq, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kv_len, window: int, mesh,
                    split: Optional[CacheSplit], num_heads: int
                    ) -> torch.Tensor:
    """Single-token attention of q (B, 1, H or this rank's heads where
    ``wq``'s are split, hd) over this rank's block of a cache (B, S, Hk,
    hd) split as ``split`` says; the output in q's heads.  A cache split
    over kv heads is attended by the query heads that read them (q's own
    where ``wq`` splits alike); a split sequence is flash-decode (those
    query heads against this rank's positions, the states merged over
    the sequence's axes in block order); a whole cache gives this rank's
    query heads the kv heads they read."""
    if split is None:
        ka, va = _kv_for_heads({"wq": wq, "wk": None}, k_cache, v_cache,
                               mesh, num_heads)
        return L.decode_attention(q, ka, va, kv_len=kv_len, window=window)

    def heads(axes):
        return (None, None, tuple(axes) or None, None)
    have = shd._axes(wq.spec[1]) if isinstance(wq, shd.Local) else ()
    qa = shd.relayout(q, heads(have), heads(split.kv), mesh)
    if not split.axes:
        out = L.decode_attention(qa, k_cache, v_cache, kv_len=kv_len,
                                 window=window)
    else:
        st = L.decode_attention_partial(qa, k_cache, v_cache, kv_len=kv_len,
                                        k_start=split.start, window=window)
        hd = st.o.shape[-1]
        packed = torch.cat([st.o, st.m[..., None], st.l[..., None]],
                           dim=-1)[None]
        packed = shd.gather(packed, (split.axes,), mesh)
        out = L.merge_decode_states(L.DecodeState(
            packed[..., hd], packed[..., hd + 1], packed[..., :hd]), q.dtype)
    return shd.relayout(out, heads(split.kv), heads(have), mesh)


def _decode_attention(cfg: ModelConfig, pa: Dict, x: torch.Tensor,
                      positions: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cache_len: int, window: int,
                      mesh=None, split: Optional[CacheSplit] = None
                      ) -> torch.Tensor:
    """A layer's attention half for tokens x (B, T, D) at ``positions``
    from ``cache_len``: their K/V (the kv heads the cache holds) written
    into this rank's block of the cache (B, S, Hk, hd), in place, by the
    rank whose block holds each position; attention over the cache
    (:func:`cache_attention`); the product with ``wo`` summed over its
    heads' axis.  Returns the residual's update (B, T, D)."""
    q, kk, vv = _qkv(cfg, pa, x, positions)
    kk, vv = kv_as_cached(pa["wk"], kk, vv, mesh, split.kv if split else ())
    T, start = x.shape[1], split.start if split else 0
    lo = max(cache_len, start)
    hi = min(cache_len + T, start + k_cache.shape[1])
    if lo < hi:
        k_cache[:, lo - start:hi - start] = \
            kk[:, lo - cache_len:hi - cache_len].to(k_cache.dtype)
        v_cache[:, lo - start:hi - start] = \
            vv[:, lo - cache_len:hi - cache_len].to(v_cache.dtype)
    out = cache_attention(q, pa["wq"], k_cache, v_cache, cache_len + 1,
                          window, mesh, split, cfg.num_heads)
    return _tp_sum(torch.einsum("btnh,nhd->btd", out, shd.local(pa["wo"])),
                   pa["wo"], 0, mesh)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, cache_len: int, mesh=None,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) at position ``cache_len`` -> (logits (B, 1, V), the
    cache (L, B, S, Hk, hd) with this token written in, in place).  With
    a ``mesh`` the tokens and the cache are this rank's rows, and the
    cache its block of positions and kv heads where the mesh splits a
    cache of ``max_seq`` positions (:func:`cache_split`)."""
    tree = P.nest(params)
    cache_len = int(cache_len)
    x = embed_tokens(cfg, tree, tokens, mesh=mesh)
    T = x.shape[1]
    positions = cache_len + torch.arange(T, device=x.device)
    split = cache_split(mesh, max_seq, cfg.num_kv_heads)
    for i, flag in enumerate(_layer_flags(cfg)):
        p = _layer(tree["blocks"], i, mesh, _keep(cfg))
        x = x + _decode_attention(cfg, p["attn"], x, positions,
                                  cache["k"][i], cache["v"][i], cache_len,
                                  _window(cfg, flag), mesh, split)
        x = x + _ffn(cfg, p["mlp"], L.apply_norm(cfg, p["mlp_norm"], x),
                     mesh)
    hidden = L.apply_norm(cfg, shd.whole_tree(tree["final_norm"], mesh), x)
    return logits_fn(cfg, tree, hidden[:, -1:, :], mesh), cache
