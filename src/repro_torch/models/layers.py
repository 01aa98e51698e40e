"""Shared layers (``repro.models.layers``): norms, remat, rotary
embeddings, attention, MLPs, the scoring statistics behind MCAL's
M(.)/L(.), and the losses (materialized and vocab-chunked cross-entropy).

Tie rule: ``top1`` is ``torch.argmax``, which returns the first maximal
index — the rule ``lax.top_k`` follows.  ``torch.topk`` promises no order
among ties, so it is used for the top-2 VALUES only.

Matrix products whose reference asks for fp32 results
(``preferred_element_type=jnp.float32``) upcast their operands and multiply
in fp32 (TF32 is off); a bf16 x bf16 product is exact in fp32, so this is
the reference's arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            parts: int = 1) -> torch.Tensor:
    """RMS norm over the last dim.  Where ``x`` and ``weight`` are one of
    ``parts`` equal blocks of that dim, ``reduce`` sums the fp32 sum of
    squares over the blocks' ranks; the mean is that sum over the whole
    width either way (the reference's ``jnp.mean``: a sum, then a
    divide), so one block is the plain norm's bits."""
    dt = x.dtype
    xf = x.float()
    ss = torch.sum(xf * xf, dim=-1, keepdim=True)
    if reduce is not None:
        ss = reduce(ss)
    var = ss / (x.shape[-1] * parts)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(dt)


def apply_norm(cfg: ModelConfig, params: Dict, x: torch.Tensor
               ) -> torch.Tensor:
    """``params`` holds the norm's own leaves: ``scale`` (and ``bias``)."""
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def norm_specs(cfg: ModelConfig, stacked: int = 0) -> Dict:
    # rmsnorm multiplies by (1 + scale), so its scale starts at zero
    lead, ax = ((stacked,), ("layers",)) if stacked else ((), ())
    spec = {"scale": ParamSpec(lead + (cfg.d_model,),
                               init="zeros" if cfg.norm == "rmsnorm"
                               else "ones", dtype=torch.float32,
                               logical=ax + ("act_embed",))}
    if cfg.norm == "layernorm":
        spec["bias"] = ParamSpec(lead + (cfg.d_model,), init="zeros",
                                 dtype=torch.float32,
                                 logical=ax + ("act_embed",))
    return spec


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def remat(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward pass when the config asks
    for it (``remat`` "layer": ``torch.utils.checkpoint``, the counterpart
    of the reference's ``jax.checkpoint`` with nothing saveable) and grad
    is on; a plain call otherwise, so serving is unchanged."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  Rotates
    the two halves of hd (not interleaved pairs), as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., T, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention — plain torch, a loop over kv chunks
# ---------------------------------------------------------------------------


def pick_kv_chunk(batch: int, t_q: int, heads: int,
                  budget_bytes: float = 2e9, dp: int = 16) -> int:
    """KV-chunk length keeping the per-chunk f32 score tensor
    (B/dp, Tq, H, ckv) under ``budget_bytes`` (the reference's rule, kept
    so that the port chunks as the reference does)."""
    per_col = max(batch / dp, 1) * t_q * heads * 4
    ck = budget_bytes / max(per_col, 1)
    ck = 2 ** int(max(math.log2(max(ck, 128)), 7))
    return int(min(ck, 1024, max(t_q, 128)))


MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, kv_chunk: int, q_offset: int,
                     visible: MaskFn) -> torch.Tensor:
    """Online-softmax attention over kv chunks of ``kv_chunk`` keys, in the
    model layout: q (B, Tq, H, hd), k/v (B, Tk, Hk, hd), H % Hk == 0 (GQA
    reads kv head h // G).  ``visible(q_pos, k_pos)`` -> (Tq, ck) bool.

    The reference's arithmetic: q scaled in its own dtype, scores and the
    (m, l, o) state in fp32, a masked score is -1e30 (not -inf), p is cast
    to v's dtype before the PV product, and l is clamped at 1e-30.  The
    last chunk is padded with zero keys, as the reference pads it, so even
    a row that sees no key comes out as the reference's does."""
    B, Tq, H, hd = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = (q * scale).reshape(B, Tq, Hk, G, hd).float()
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    o = torch.zeros((B, Tq, Hk, G, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, Tq, Hk, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Tq, Hk, G), device=q.device)
    for base in range(0, max(Tk, 1), kv_chunk):
        kc = k[:, base:base + kv_chunk].float()
        vc = v[:, base:base + kv_chunk]
        if kc.shape[1] < kv_chunk:   # zero keys past Tk, as the reference
            pad = (0, 0, 0, 0, 0, kv_chunk - kc.shape[1])
            kc, vc = F.pad(kc, pad), F.pad(vc, pad)
        k_pos = base + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("btkgh,bskh->btkgs", qg, kc)
        ok = visible(q_pos, k_pos)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("btkgs,bskh->btkgh", p.to(v.dtype).float(),
                          vc.float())
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def attention_mask(Tk: int, *, causal: bool, window: int, kv_start: int,
                   window_alone: bool) -> MaskFn:
    """The mask of attention over ``Tk`` keys, as ``visible(q_pos, k_pos)``
    -> (Tq, ck) bool for absolute query and key positions: keys in
    [kv_start, Tk), no later key under ``causal``, and under ``window`` > 0
    none ``window`` or more positions back, with or without ``causal``
    where ``window_alone`` (the TPU kernel's rule,
    ``kernels.ref.flash_attention_ref``), only with it otherwise (the
    reference's ``blockwise_attention``).  One contract for the model's
    attention and the kernel's plain version; no model sets a window
    without ``causal``."""
    def visible(q_pos, k_pos):
        ok = ((k_pos < Tk) & (k_pos >= kv_start))[None, :].expand(
            q_pos.shape[0], -1)
        if causal:
            ok = ok & (q_pos[:, None] >= k_pos[None, :])
        if window > 0 and (causal or window_alone):
            ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
        return ok
    return visible


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_chunk: int = 1024,
                        scale: Optional[float] = None,
                        kv_start: int = 0) -> torch.Tensor:
    """Flash-style attention, O(Tq * kv_chunk) memory.

    q: (B, Tq, H, hd); k, v: (B, Tk, Hk, hd) with H % Hk == 0.
    ``q_offset`` is the absolute position of q[0]; keys at positions <
    ``kv_start`` are masked.  As in the reference, ``window`` applies only
    when ``causal`` is set (the TPU kernel applies it either way; see
    :func:`attention_mask`).
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    visible = attention_mask(k.shape[1], causal=causal, window=window,
                             kv_start=kv_start, window_alone=False)
    return online_attention(q, k, v, scale=scale, kv_chunk=kv_chunk,
                            q_offset=q_offset, visible=visible)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Union[torch.Tensor, int], window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention over a KV cache: q (B, 1, H, hd); k/v
    (B, S, Hk, hd); keys at positions >= ``kv_len`` are masked."""
    B, _, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else hd ** -0.5
    qg = (q * scale).reshape(B, Hk, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float())
    pos = torch.arange(S, device=q.device)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int64,
                             device=q.device).broadcast_to((B,))
    valid = pos[None, :] < kv_len[:, None]
    if window > 0:
        valid = valid & (pos[None, :] >= (kv_len - window)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


class DecodeState(NamedTuple):
    """One block of a sequence-split cache's attention state for a decoded
    token: the block's max score ``m`` and sum of exp(s - m) ``l``, each
    (B, Hk, G) fp32, and its output ``o`` (B, Hk, G, hd) fp32, already
    normalized by ``l`` (the plain softmax's arithmetic on the block)."""
    m: torch.Tensor
    l: torch.Tensor
    o: torch.Tensor


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             kv_len: Union[torch.Tensor, int],
                             k_start: int = 0, window: int = 0,
                             scale: Optional[float] = None) -> DecodeState:
    """:func:`decode_attention` over one block of a cache whose keys are
    at positions ``k_start`` .. ``k_start + S_blk``: q (B, 1, H, hd), k/v
    (B, S_blk, Hk, hd).  The state :func:`merge_decode_states` merges over
    the blocks (flash-decode); a block no key of which is visible has
    ``m`` -1e30 and weighs nothing."""
    B, _, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = scale if scale is not None else hd ** -0.5
    qg = (q * scale).reshape(B, Hk, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float())
    pos = k_start + torch.arange(S, device=q.device)
    kv_len = torch.as_tensor(kv_len, dtype=torch.int64,
                             device=q.device).broadcast_to((B,))
    valid = pos[None, :] < kv_len[:, None]
    if window > 0:
        valid = valid & (pos[None, :] >= (kv_len - window)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype).float(), v.float())
    return DecodeState(m, l, o)


def merge_decode_states(states: DecodeState, dtype: torch.dtype
                        ) -> torch.Tensor:
    """The blocks' states stacked on a leading dim (P, ...), in block
    order, merged in that order: each block's output weighted by
    l exp(m - max m) over the weights' sum -> (B, 1, H, hd) in ``dtype``.
    One block's weight is exactly 1, so a cache of one block gives
    :func:`decode_attention`'s bits."""
    mx = states.m.amax(dim=0)
    w = states.l * torch.exp(states.m - mx)
    den = w[0]
    for i in range(1, w.shape[0]):
        den = den + w[i]
    out = (w[0] / den)[..., None] * states.o[0]
    for i in range(1, w.shape[0]):
        out = out + (w[i] / den)[..., None] * states.o[i]
    B, Hk, G, hd = out.shape
    return out.reshape(B, 1, Hk * G, hd).to(dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, stacked: int = 0,
              d_ff: Optional[int] = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    lead, ax = ((stacked,), ("layers",)) if stacked else ((), ())
    bf16 = torch.bfloat16
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamSpec(lead + (cfg.d_model, d_ff), dtype=bf16,
                                logical=ax + ("embed", "mlp")),
            "w_up": ParamSpec(lead + (cfg.d_model, d_ff), dtype=bf16,
                              logical=ax + ("embed", "mlp")),
            "w_down": ParamSpec(lead + (d_ff, cfg.d_model), dtype=bf16,
                                logical=ax + ("mlp", "embed")),
        }
    return {
        "w_up": ParamSpec(lead + (cfg.d_model, d_ff), dtype=bf16,
                          logical=ax + ("embed", "mlp")),
        "b_up": ParamSpec(lead + (d_ff,), init="zeros", dtype=bf16,
                          logical=ax + ("mlp",)),
        "w_down": ParamSpec(lead + (d_ff, cfg.d_model), dtype=bf16,
                            logical=ax + ("mlp", "embed")),
        "b_down": ParamSpec(lead + (cfg.d_model,), init="zeros", dtype=bf16,
                            logical=ax + ("embed",)),
    }


def apply_mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
    """The MLP over x (..., D).  ``reduce`` takes the down-projection
    before its bias: the sum over ranks where ``p`` holds a rank's columns
    of ``w_gate`` / ``w_up`` (``b_up``) and its rows of ``w_down``."""
    reduce = reduce or (lambda y: y)
    if cfg.act == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        return reduce(h @ p["w_down"])
    h = x @ p["w_up"] + p["b_up"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return reduce(h @ p["w_down"]) + p["b_down"]


# ---------------------------------------------------------------------------
# vocab head: loss + MCAL scoring statistics
# ---------------------------------------------------------------------------


class ScoreStats(NamedTuple):
    """Per-row uncertainty statistics used by MCAL's M(.) / L(.)."""

    margin: torch.Tensor       # top1 - top2 logit gap
    entropy: torch.Tensor      # predictive entropy (nats)
    max_logprob: torch.Tensor  # log p(top1)  (least-confidence = 1 - exp(.))
    top1: torch.Tensor         # argmax index, int32


def map_stats(fn, stats: ScoreStats) -> ScoreStats:
    return ScoreStats(*(fn(a) for a in stats))


def score_stats_from_logits(logits: torch.Tensor) -> ScoreStats:
    """Reference implementation over materialized logits."""
    lf = logits.float()
    top2 = torch.topk(lf, 2, dim=-1).values
    lse = torch.logsumexp(lf, dim=-1)
    p = torch.exp(lf - lse[..., None])
    entropy = lse - torch.sum(p * lf, dim=-1)
    return ScoreStats(
        margin=top2[..., 0] - top2[..., 1],
        entropy=entropy,
        max_logprob=top2[..., 0] - lse,
        top1=torch.argmax(lf, dim=-1).to(torch.int32),
    )


def chunked_score_stats(hidden: torch.Tensor, w_vocab: torch.Tensor,
                        chunk: int = 8192) -> ScoreStats:
    """Online top-2/entropy/lse over vocab chunks without materializing
    (T, V) logits.  hidden: (..., D); w_vocab: (D, V)."""
    D, V = w_vocab.shape
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, D)
    T, dev = h2.shape[0], h2.device
    m = torch.full((T,), NEG_INF, device=dev)
    s = torch.zeros((T,), device=dev)
    u = torch.zeros((T,), device=dev)
    v1 = torch.full((T,), NEG_INF, device=dev)
    v2 = torch.full((T,), NEG_INF, device=dev)
    i1 = torch.zeros((T,), dtype=torch.int32, device=dev)
    for lo in range(0, V, chunk):
        wc = w_vocab[:, lo:lo + chunk]
        x = (h2 @ wc).float()
        if x.shape[1] < chunk:   # pad like the reference: NEG_INF columns
            x = torch.cat([x, torch.full((T, chunk - x.shape[1]), NEG_INF,
                                         device=dev)], dim=1)
        valid = torch.arange(lo, lo + chunk, device=dev) < V
        # online logsumexp + sum(x * e^x) for entropy
        m_new = torch.maximum(m, torch.max(x, dim=-1).values)
        corr = torch.exp(m - m_new)
        e = torch.exp(x - m_new[:, None])
        s = s * corr + torch.sum(e, dim=-1)
        u = u * corr + torch.sum(torch.where(valid[None, :], x, 0.0) * e,
                                 dim=-1)
        m = m_new
        # online top-2: new top2 of {v1, v2, c1, c2} given v1>=v2, c1>=c2
        c12 = torch.topk(x, 2, dim=-1).values
        c1, c2 = c12[:, 0], c12[:, 1]
        cidx = torch.argmax(x, dim=-1).to(torch.int32)
        i1 = torch.where(c1 > v1, cidx + lo, i1)
        v2 = torch.maximum(torch.minimum(v1, c1), torch.maximum(v2, c2))
        v1 = torch.maximum(v1, c1)
    lse = m + torch.log(torch.clamp(s, min=1e-30))
    entropy = lse - u / torch.clamp(s, min=1e-30)
    stats = ScoreStats(margin=v1 - v2, entropy=entropy, max_logprob=v1 - lse,
                       top1=i1)
    return map_stats(lambda a: a.reshape(lead), stats)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (token) cross-entropy, fp32; over the ``mask``ed positions
    where one is given."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def chunked_cross_entropy(hidden: torch.Tensor, w_vocab: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 16384,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Cross-entropy without materializing (T, V) logits
    (``repro.models.layers.chunked_cross_entropy``): the log-sum-exp
    accumulated over vocab chunks of ``chunk`` columns, the label's logit
    gathered on the fly, V padded with zero columns to whole chunks (each
    masked to -1e30).  Each chunk's product is a plain fp32 matmul (the
    reference's fp32-result einsum, outside any kernel), and under grad
    each chunk is recomputed in the backward (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint``), so no (T, chunk) logits tile is
    kept for it.  hidden (..., D), w_vocab (D, V), labels (...) ints."""
    D, V = w_vocab.shape
    nchunk = max(1, -(-V // chunk))
    if nchunk * chunk != V:
        w_vocab = F.pad(w_vocab, (0, nchunk * chunk - V))
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, D)
    lab = labels.reshape(-1).long()
    T, dev = h2.shape[0], h2.device

    def step(m, s, ll, i: int):
        wc = w_vocab[:, i * chunk:(i + 1) * chunk]
        x = h2.float() @ wc.float()
        col = i * chunk + torch.arange(chunk, device=dev)
        x = torch.where(col[None, :] < V, x, NEG_INF)
        m_new = torch.maximum(m, torch.amax(x, dim=-1))
        s_new = s * torch.exp(m - m_new) + torch.sum(
            torch.exp(x - m_new[:, None]), dim=-1)
        # the label's logit where it falls in this chunk (the reference
        # sums x over a one-hot; a gather gives the same bits)
        idx = lab - i * chunk
        inside = (idx >= 0) & (idx < chunk)
        hit = torch.gather(x, 1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
        ll_new = ll + torch.where(inside, hit, 0.0)
        return m_new, s_new, ll_new

    m = torch.full((T,), NEG_INF, device=dev)
    s = torch.zeros((T,), device=dev)
    ll = torch.zeros((T,), device=dev)
    grad = torch.is_grad_enabled() and (hidden.requires_grad
                                        or w_vocab.requires_grad)
    for i in range(nchunk):
        if grad:
            m, s, ll = torch.utils.checkpoint.checkpoint(
                step, m, s, ll, i, use_reentrant=False)
        else:
            m, s, ll = step(m, s, ll, i)
    nll = ((m + torch.log(torch.clamp(s, min=1e-30))) - ll).reshape(lead)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
