"""Plain PyTorch versions of the hand-written kernels (``repro.kernels.ref``).

Each is the kernel's function written with ordinary tensor ops: the CPU
path of its wrapper, and what ``chip_smoke.py`` holds the kernel against
on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import online_attention, score_stats_from_logits
from repro_torch.models import mamba2


def margin_head_ref(hidden: torch.Tensor, w_vocab: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """(T, D) x (D, V) -> (margin, entropy, max_logprob, top1)."""
    stats = score_stats_from_logits(hidden.float() @ w_vocab.float())
    return (stats.margin, stats.entropy, stats.max_logprob, stats.top1)


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
