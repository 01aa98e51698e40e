"""Public kernel entry points, dispatched by the tensor's device
(``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel or raises.  There is no switch and no fallback: this
is the port's counterpart of ``use_pallas()`` "auto" on a TPU.  The port's
models call :func:`attention` and :func:`ssd` (the reference's models call
the jnp paths directly and never reach its kernels), so that the serving
path runs on the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import margin_head as _mh
from repro_torch.kernels import pairwise_dist as _pd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.layers import ScoreStats


def score_head(hidden: torch.Tensor, w_vocab: torch.Tensor) -> ScoreStats:
    """Pool-scoring statistics for MCAL's M(.)/L(.).  hidden: (..., D)."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.device.type == "cpu":
        outs = _ref.margin_head_ref(h2, w_vocab)
    else:
        outs = _mh.margin_head(h2.contiguous(), w_vocab.contiguous())
    return ScoreStats(*(o.reshape(lead) for o in outs))


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared distances for k-center M(.)."""
    if x.device.type == "cpu":
        return _ref.pairwise_sqdist_ref(x, c)
    return _pd.pairwise_sqdist(x.contiguous(), c.contiguous())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Model-layout attention (B, T, H, hd) x (B, Tk, Hk, hd).  On the CPU
    the plain version walks kv chunks of ``kv_chunk`` keys (the model's own
    chunking; default min(1024, Tk))."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        out = _ref.flash_attention_ref(qh, kh, vh, causal=causal,
                                       window=window, scale=scale,
                                       kv_chunk=kv_chunk)
    else:
        out = _fa.flash_attention(qh, kh, vh, causal=causal, window=window,
                                  scale=scale)
    return out.transpose(1, 2)


def ssd(xh, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD scan -> (y (B, T, H, hd), final state (B, H, hd, N))."""
    if xh.device.type == "cpu":
        return _ref.ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan(*(t.contiguous() for t in (xh, dt, A, Bm, Cm)),
                         chunk=chunk)
