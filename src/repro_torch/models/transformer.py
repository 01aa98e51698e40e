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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
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


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), plus the shared expert where the config
    has one.  On a ``mesh`` of more than one rank the routed part runs
    sharded (:func:`moe_sharded`); a mesh of one device is the local
    block, bit for bit, as in the reference."""
    B, S, D = x.shape
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
