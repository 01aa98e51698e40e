"""Plain PyTorch versions of the hand-written kernels (``repro.kernels.ref``).

Each is the kernel's function written with ordinary tensor ops: the CPU
path of its wrapper, and what ``chip_smoke.py`` holds the kernel against
on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, attention_mask,
                                       online_attention,
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
                        kv_chunk: Optional[int] = None, q_offset: int = 0,
                        kv_start: int = 0) -> torch.Tensor:
    """Head-major q (B, H, Tq, hd), k/v (B, Hk, Tk, hd) -> (B, H, Tq, hd).

    The online softmax over kv chunks of ``kv_chunk`` keys (default
    min(1024, Tk), as the reference's ``ref.flash_attention_ref``), query
    row i at position ``q_offset + i`` and keys below ``kv_start`` hidden,
    as the reference's ``layers.blockwise_attention`` takes them, with the
    TPU kernel's window: it applies with or without ``causal``
    (``layers.attention_mask``; the jnp oracle applies it only under
    ``causal``, and no model calls a window without it)."""
    Tk = k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    visible = attention_mask(Tk, causal=causal, window=window,
                             kv_start=kv_start, window_alone=True)
    out = online_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale,
        kv_chunk=kv_chunk or min(1024, Tk), q_offset=q_offset,
        visible=visible)
    return out.transpose(1, 2)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            scale: Optional[float] = None, q_offset: int = 0,
                            kv_start: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of its scores, (B, H, Tq) fp32, for
    head-major q (B, H, Tq, hd) and k (B, Hk, Tk, hd) with the mask of
    :func:`flash_attention_ref`: qs = q * scale rounded to q's dtype, the
    scores qs k^T in fp32, -1e30 where the mask hides a key (a row that
    sees none gives about -1e30).  What ``flash_attention(...,
    return_lse=True)`` writes beside its output; the scores of about 2^26
    (query, key) pairs at a time."""
    B, H, Tq, hd = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    qs = (q * scale).float().reshape(B, Hk, H // Hk, Tq, hd)
    kf = k.float()
    visible = attention_mask(Tk, causal=causal, window=window,
                             kv_start=kv_start, window_alone=True)
    k_pos = torch.arange(Tk, device=q.device)
    rows = max(1, 2 ** 26 // max(1, B * H * Tk))
    out = []
    for r in range(0, Tq, rows):
        s = torch.einsum("bkgtd,bksd->bkgts", qs[:, :, :, r:r + rows], kf)
        ok = visible(q_offset + torch.arange(r, min(r + rows, Tq),
                                             device=q.device), k_pos)
        out.append(torch.logsumexp(torch.where(ok, s, NEG_INF), dim=-1)
                   .reshape(B, H, -1))
    return torch.cat(out, dim=-1)


def flash_attention_bwd_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  dout: torch.Tensor, lse: torch.Tensor, *,
                                  causal: bool = True, window: int = 0,
                                  scale: Optional[float] = None,
                                  q_offset: int = 0, kv_start: int = 0):
    """The backward kernel's arithmetic on its wgmma route (bf16 at hd 64,
    80, 128 and 256), step by step, on head-major tensors as
    ``flash_attention_bwd`` takes them (``lse`` the forward's (B, H, Tq);
    the mask with ``q_offset`` and ``kv_start`` as the forward's).  The
    kernel's blocks change which warpgroup sums an entry, not the order of
    its sums: 128 keys (dK/dV) or queries (dQ), two warpgroups of 64 rows
    at the full width; at hd 256 64 keys with one warpgroup summing dV and
    the other dK at the full width, and 64 queries of two query heads of a
    kv group, a warpgroup each.

    qs = q * scale rounded to q's dtype (fp32 rounds nothing), D =
    rowsum(dO o) in fp32.  dK and dV: fp32 sums over query tiles of 64
    rows, the query heads of a kv group outer and the tiles inner, as each
    key block of the kernel walks them: S^T = K qs^T, P = exp(S - lse) (0
    where the forward's mask hides the pair), dP^T = V dO^T,
    dS = P (dP - D), then dV += P^T dO and dK += dS^T qs with P and dS
    rounded to q's dtype as the products' operands.  dQ in its own pass
    over key tiles of 64: dQ += dS K, times scale at the end.  Products of
    such operands are exact in fp32; the order of the sums within a tile
    is the matmul's.  Returns (dq, dk, dv) in q's dtype.  The main path
    never calls it."""
    od, tile = q.dtype, 64
    B, H, Tq, hd = q.shape
    Hk, Tk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = hd ** -0.5 if scale is None else float(scale)

    def rnd(t):
        return t.to(od).float()
    qs = rnd(q.float() * scale)
    kf, vf, dof = (rnd(t.float()) for t in (k, v, dout))
    D = (dout.float() * out.float()).sum(-1)
    lse = lse.float()
    vis = attention_mask(Tk, causal=causal, window=window,
                         kv_start=kv_start, window_alone=True)(
        q_offset + torch.arange(Tq, device=q.device),
        torch.arange(Tk, device=q.device))

    def grads(qs_t, do_t, lse_t, d_t, k_t, v_t, vis_t):
        p = torch.where(vis_t, torch.exp(qs_t @ k_t.transpose(-1, -2)
                                         - lse_t[..., None]), 0.0)
        return p, p * (do_t @ v_t.transpose(-1, -2) - d_t[..., None])

    def by_group(t):   # (B, H, ...) -> (B, Hk, G, ...)
        return t.reshape(B, Hk, G, *t.shape[2:])
    qs_g, do_g, lse_g, d_g = (by_group(t) for t in (qs, dof, lse, D))
    dk = torch.zeros((B, Hk, Tk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for g in range(G):
        for q0 in range(0, Tq, tile):
            r = slice(q0, q0 + tile)
            p, ds = grads(qs_g[:, :, g, r], do_g[:, :, g, r],
                          lse_g[:, :, g, r], d_g[:, :, g, r], kf, vf, vis[r])
            dv = dv + rnd(p).transpose(-1, -2) @ do_g[:, :, g, r]
            dk = dk + rnd(ds).transpose(-1, -2) @ qs_g[:, :, g, r]
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (kf, vf))
    dq = torch.zeros((B, H, Tq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, tile):
        c = slice(k0, k0 + tile)
        _, ds = grads(qs, dof, lse, D, kh[:, :, c], vh[:, :, c], vis[:, c])
        dq = dq + rnd(ds) @ kh[:, :, c]
    return (dq * scale).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def ssd_scan_ref(xh, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """The chunked SSD scan from the incoming state ``h0`` (None: zeros):
    ``mamba2.ssd_chunked`` (the kernel's oracle in the reference)."""
    return mamba2.ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0)


def ssd_scan_passes_ref(xh, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """The chunked SSD scan split as the CUDA kernel splits it: (a) each
    chunk's summary S_c = sum_s exp(l_last - l_s) xd_s (x) B_s and its total
    log decay l_last, (b) the walk h_c = exp(l_last,c) h_{c-1} + S_c over
    the chunks from ``h0`` (None: zeros), (c) each chunk's output from its
    incoming state,
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
    h = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
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


def ssd_scan_bwd_passes_ref(xh, dt, A, Bm, Cm, h_in, dy, dh_final=None, *,
                            chunk: int = 128, with_dh0: bool = False):
    """The gradient of the chunked SSD scan split as the CUDA kernel
    ``ssd_scan_bwd`` splits it, all in fp32 (the model's ``ssd_chunked``
    rounds W, the end decays and B to xh's dtype inside its products; this
    does not, as neither kernel does).  ``h_in`` is each chunk's incoming
    state (B, nc, H, hd, N), as the forward leaves it
    (``ssd_scan_passes_ref``); ``dy`` the output's gradient and
    ``dh_final`` the final state's (None for zeros).  Per chunk, with l the
    cumsum of -dt A, L its last value and G = C B^T:

    U_c = sum_t exp(l_t) dy_t (x) C_t; the walk from the last chunk, each
    chunk's g the gradient at its outgoing state (dh_final for the last),
    g_prev = exp(L) g + U; dS_ts = (dy_t . x_s) dt_s exp(l_t - l_s) for
    s <= t; dxd_s = sum_t G_ts exp(l_t - l_s) dy_t + exp(L - l_s) g B_s;
    dC = dS B + exp(l) dy h_in; dB = dS^T C + dt exp(L - l) x g; dl from
    the row and column sums of Z = dS o G, Q_t = C_t . exp(l_t) h_in^T dy_t
    and R_s = dt_s x_s . g B_s, with sum_s exp(L - l_s) R_s + exp(L) <g,
    h_in> on the last position; dla its reverse cumsum; dx = dxd dt, ddt =
    -A dla + dxd . x, dA = -sum dt dla.

    Returns (dxh in xh's dtype, ddt (B, T, H), dA (H,), dBm, dCm (B, T, N)),
    fp32 but dxh, and with ``with_dh0`` the first chunk's incoming state's
    gradient (the g the walk leaves after it) after them.  The main path
    never calls it."""
    Bsz, T, H, hd = xh.shape
    N = Bm.shape[-1]
    C = min(chunk, T)
    nc = -(-T // C)
    pad = nc * C - T   # exact: padded positions carry no data

    def chunks(t):   # (B, T, ...) -> (B, nc, C, ...), fp32, zero-padded
        t = t.float()
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bsz, nc, C, *t.shape[2:])
    x, dyc, dtc, Bc, Cc = (chunks(t) for t in (xh, dy, dt, Bm, Cm))
    A = A.float()
    h_in = h_in.float()
    cum = torch.cumsum(-(dtc * A), dim=2)                  # (B, nc, C, H)
    last = cum[:, :, -1]                                   # (B, nc, H)
    el, eL = torch.exp(cum), torch.exp(last[:, :, None] - cum)
    # U, then the reverse walk
    U = torch.einsum("bcth,bcthd,bctn->bchdn", el, dyc, Cc)
    g = torch.zeros_like(h_in[:, 0]) if dh_final is None else \
        dh_final.float()
    gout = [None] * nc
    for c in reversed(range(nc)):
        gout[c] = g
        g = torch.exp(last[:, c])[..., None, None] * g + U[:, c]
    gout = torch.stack(gout, dim=1)                        # (B, nc, H, hd, N)
    # the gradient pass
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    tril = torch.tril(torch.ones((C, C), dtype=torch.bool, device=xh.device))
    E = torch.exp(torch.where(tril[None, None, :, :, None],
                              cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              -torch.inf))                 # (B, nc, t, s, H)
    gB = torch.einsum("bchdn,bcsn->bcshd", gout, Bc)        # (g B_s)[d]
    dxd = torch.einsum("bcts,bctsh,bcthd->bcshd", G, E, dyc) + \
        eL[..., None] * gB
    dS = E * dtc[:, :, None] * torch.einsum("bcthd,bcshd->bctsh", dyc, x)
    Z = dS * G[..., None]
    inter = el[..., None] * torch.einsum("bcthd,bchdn->bcthn", dyc, h_in)
    dC = torch.einsum("bctsh,bcsn->bctn", dS, Bc) + inter.sum(3)
    dB = torch.einsum("bctsh,bctn->bcsn", dS, Cc) + torch.einsum(
        "bcsh,bcshd,bchdn->bcsn", dtc * eL, x, gout)
    Q = torch.einsum("bcthn,bctn->bcth", inter, Cc)
    R = dtc * (x * gB).sum(-1)                             # (B, nc, C, H)
    dl = Z.sum(3) - Z.sum(2) + Q - eL * R
    dl[:, :, -1] = dl[:, :, -1] + (eL * R).sum(2) + torch.exp(last) * (
        gout * h_in).sum((-1, -2))
    dla = torch.flip(torch.cumsum(torch.flip(dl, (2,)), 2), (2,))
    ddt = -A * dla + (dxd * x).sum(-1)
    dA = -(dtc * dla).sum((0, 1, 2))

    def unchunk(t):
        return t.reshape(Bsz, nc * C, *t.shape[3:])[:, :T]
    return ((unchunk(dxd) * dt.float()[..., None]).to(xh.dtype), unchunk(ddt),
            dA, unchunk(dB), unchunk(dC)) + ((g,) if with_dh0 else ())
