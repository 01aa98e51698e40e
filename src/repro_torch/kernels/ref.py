"""Plain PyTorch versions of the hand-written kernels (``repro.kernels.ref``).

Each is the kernel's function written with ordinary tensor ops: the CPU
path of its wrapper, and what ``chip_smoke.py`` holds the kernel against
on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, online_attention,
                                       score_stats_from_logits)
from repro_torch.models import mamba2


def margin_head_ref(hidden: torch.Tensor, w_vocab: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(T, D) x (D, V) -> (margin, entropy, max_logprob, top1)."""
    stats = score_stats_from_logits(hidden.float() @ w_vocab.float())
    return (stats.margin, stats.entropy, stats.max_logprob, stats.top1)


def _merge_states(a, b):
    """The CUDA kernel's merge of two online states (m, s, u, v1, v2, i1):
    symmetric, equal v1 going to the smaller index."""
    am, as_, au, av1, av2, ai1 = a
    bm, bs, bu, bv1, bv2, bi1 = b
    m = torch.maximum(am, bm)
    ca, cb = torch.exp(am - m), torch.exp(bm - m)
    take_b = (bv1 > av1) | ((bv1 == av1) & (bi1 < ai1))
    return (m, as_ * ca + bs * cb, au * ca + bu * cb,
            torch.maximum(av1, bv1),
            torch.maximum(torch.minimum(av1, bv1), torch.maximum(av2, bv2)),
            torch.where(take_b, bi1, ai1))


def margin_head_split_ref(hidden: torch.Tensor, w_vocab: torch.Tensor,
                          slice_cols: int) -> Tuple[torch.Tensor, ...]:
    """``margin_head_ref`` split as the CUDA kernel splits it: the online
    state (max m, sum of e^(x-m) s, sum of x e^(x-m) u, top-2 v1 >= v2,
    first argmax i1) of each slice of ``slice_cols`` (>= 2) columns (the
    kernel's slices are 128), then the slices folded in the merge pass's
    order: 32 lanes each fold a contiguous run of slices in increasing
    order, and the lanes are merged pairwise (lane ^ 16, ^ 8, ..., ^ 1).
    The main path never calls it."""
    x = hidden.float() @ w_vocab.float()
    T, V = x.shape
    ns = -(-V // slice_cols)
    pad = ns * slice_cols - V
    xs = F.pad(x, (0, pad), value=NEG_INF).reshape(T, ns, slice_cols)
    valid = (torch.arange(ns * slice_cols, device=x.device) < V).reshape(
        ns, slice_cols)
    m = xs.max(dim=-1).values
    e = torch.where(valid, torch.exp(xs - m[..., None]), 0.0)
    top = torch.topk(xs, 2, dim=-1).values
    i1 = torch.argmax(xs, dim=-1) + torch.arange(
        ns, device=x.device) * slice_cols
    states = (m, e.sum(-1), (torch.where(valid, xs, 0.0) * e).sum(-1),
              top[..., 0], top[..., 1], i1)
    # the merge pass: runs of `per` slices a lane, empty states past ns
    per = -(-ns // 32)
    empty = (NEG_INF, 0.0, 0.0, NEG_INF, NEG_INF, torch.iinfo(torch.int32).max)
    lanes = tuple(F.pad(t, (0, 32 * per - ns), value=fill).reshape(T, 32, per)
                  for t, fill in zip(states, empty))
    acc = tuple(torch.full_like(t[..., 0], fill)
                for t, fill in zip(lanes, empty))
    for k in range(per):
        acc = _merge_states(acc, tuple(t[..., k] for t in lanes))
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = _merge_states(acc, tuple(t[:, idx ^ off] for t in acc))
    m, s, u, v1, v2, i1 = (t[:, 0] for t in acc)
    s = torch.clamp(s, min=1e-30)
    lse = m + torch.log(s)
    return v1 - v2, lse - u / s, v1 - lse, i1.to(torch.int32)


def pairwise_sqdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared euclidean distances, fp32.

    The kernel's expansion (||x||^2 - 2 x.c + ||c||^2, clamped at 0), so
    both round alike and agree exactly on integer-valued inputs."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1)
    c2 = torch.sum(c * c, dim=-1)
    g = x @ c.T
    return torch.clamp(x2[:, None] - 2.0 * g + c2[None, :], min=0.0)


def _bf16_split(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """t = hi + mid + lo + a remainder below 2^-24 |t|: each part the bf16
    rounding of what the parts before it leave (both remainders exact in
    fp32), so the three hold fp32's 24 significant bits (returned in
    fp32)."""
    parts = []
    for _ in range(3):
        p = t.to(torch.bfloat16).float()
        parts.append(p)
        t = t - p
    return tuple(parts)


def pairwise_sqdist_split_ref(x: torch.Tensor, c: torch.Tensor
                              ) -> torch.Tensor:
    """``pairwise_sqdist_ref`` with x.c taken as the CUDA kernel takes it on
    the tensor cores: each fp32 element split once into bf16 hi + mid + lo,
    and x.c the six products whose parts' orders sum to at most 2,
    hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi, each exact and summed
    in fp32 (the kernel sums the five corrections apart from hi.hi in each
    16-deep k step; the order of the fp32 sums is the one difference); the
    norms stay fp32.  The dropped mid.lo, lo.mid and lo.lo are below 2^-25
    relative, so it is as accurate as the plain version; exact on integers
    up to 256 (mid = lo = 0).  The main path never calls it."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1)
    c2 = torch.sum(c * c, dim=-1)
    (xh, xm, xl), (ch, cm, cl) = _bf16_split(x), _bf16_split(c)
    g = (xh @ ch.T + xh @ cm.T + xm @ ch.T + xm @ cm.T + xh @ cl.T
         + xl @ ch.T)
    return torch.clamp(x2[:, None] - 2.0 * g + c2[None, :], min=0.0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Head-major q (B, H, Tq, hd), k/v (B, Hk, Tk, hd) -> (B, H, Tq, hd).

    The online softmax over kv chunks of ``kv_chunk`` keys (default
    min(1024, Tk), as the reference's ``ref.flash_attention_ref``), with the
    TPU kernel's masks: ``window`` applies with or without ``causal``.  (The
    reference's jnp oracle, ``layers.blockwise_attention``, applies it only
    under ``causal``; no model calls a window without ``causal``.)"""
    Tk = k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5

    def visible(q_pos, k_pos):
        ok = (k_pos < Tk)[None, :].expand(q_pos.shape[0], -1)
        if causal:
            ok = ok & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
        return ok

    out = online_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale,
        kv_chunk=kv_chunk or min(1024, Tk), q_offset=0, visible=visible)
    return out.transpose(1, 2)


def ssd_scan_ref(xh, dt, A, Bm, Cm, *, chunk: int = 128):
    """The chunked SSD scan: ``mamba2.ssd_chunked`` (the kernel's oracle in
    the reference)."""
    return mamba2.ssd_chunked(xh, dt, A, Bm, Cm, chunk)


def ssd_scan_passes_ref(xh, dt, A, Bm, Cm, *, chunk: int = 128):
    """The chunked SSD scan split as the CUDA kernel splits it: (a) each
    chunk's summary S_c = sum_s exp(l_last - l_s) xd_s (x) B_s and its total
    log decay l_last, (b) the walk h_c = exp(l_last,c) h_{c-1} + S_c over
    the chunks, (c) each chunk's output from its incoming state,
    y_t = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) xd_s + exp(l_t) C_t . h_{c-1}.

    Returns (y (B, T, H, hd) in xh's dtype, h_final (B, H, hd, N) fp32,
    h_in (B, nc, H, hd, N) fp32, each chunk's incoming state)."""
    Bsz, T, H, hd = xh.shape
    N = Bm.shape[-1]
    C = min(chunk, T)
    nc = -(-T // C)
    pad = nc * C - T   # exact: dt = 0 gives unit decay and no update
    x = F.pad(xh.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, C, H, hd)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, C, H)
    Bc, Cc = (F.pad(m.float(), (0, 0, 0, pad)).reshape(Bsz, nc, C, N)
              for m in (Bm, Cm))
    cum = torch.cumsum(-(dtc * A.float()), dim=2)            # l_t (B,nc,C,H)
    xd = x * dtc[..., None]

    # (a) chunk summaries
    last = cum[:, :, -1]                                     # (B, nc, H)
    dec = torch.exp(last[:, :, None] - cum)
    S = torch.einsum("bcsh,bcshd,bcsn->bchdn", dec, xd, Bc)
    # (b) the inter-chunk walk
    h = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=xh.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None, None] * h + S[:, c]
    h_in = torch.stack(h_in, dim=1)
    # (c) output: the intra-chunk term, masked before the exp, and the
    # incoming state's
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=xh.device))
    W = G[..., None] * torch.exp(torch.where(
        tril[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], -torch.inf))
    y = torch.einsum("bctsh,bcshd->bcthd", W, xd) + torch.einsum(
        "bcth,bctn,bchdn->bcthd", torch.exp(cum), Cc, h_in)
    y = y.reshape(Bsz, nc * C, H, hd)[:, :T]
    return y.to(xh.dtype), h, h_in
