"""Public kernel entry points, dispatched by the tensor's device
(``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel or raises.  There is no switch and no fallback: this
is the port's counterpart of ``use_pallas()`` "auto" on a TPU.  Any other
device (``meta``, say, whose tensors have no storage a kernel could read)
is refused with a ``ValueError``.  The port's
models call :func:`attention` and :func:`ssd` (the reference's models call
the jnp paths directly and never reach its kernels), so that the serving
path runs on the kernels.

Gradients: on the CPU autograd differentiates the plain versions.  On a
CUDA tensor :func:`attention` goes through a ``torch.autograd.Function``
whenever grad is on and an input requires it: its forward is the
``flash_attention`` kernel (which then also writes each row's
log-sum-exp) and its backward the ``flash_attention_bwd`` kernel.
:func:`ssd` likewise: its forward is the ``ssd_scan`` kernel (keeping
each chunk's incoming state) and its backward the ``ssd_scan_bwd`` kernel.
Nothing falls back to the plain versions on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import margin_head as _mh
from repro_torch.kernels import pairwise_dist as _pd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb
from repro_torch.models.layers import ScoreStats


def _kernel_device(*ts: torch.Tensor) -> None:
    """Refuse a kernel call on anything but a CUDA tensor."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(
                f"the CUDA kernels take cuda tensors; got one on {t.device} "
                f"(cpu tensors take the plain versions)")


def score_head(hidden: torch.Tensor, w_vocab: torch.Tensor) -> ScoreStats:
    """Pool-scoring statistics for MCAL's M(.)/L(.).  hidden: (..., D)."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.device.type == "cpu":
        outs = _ref.margin_head_ref(h2, w_vocab)
    else:
        _kernel_device(h2, w_vocab)
        outs = _mh.margin_head(h2.contiguous(), w_vocab.contiguous())
    return ScoreStats(*(o.reshape(lead) for o in outs))


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) squared distances for k-center M(.)."""
    if x.device.type == "cpu":
        return _ref.pairwise_sqdist_ref(x, c)
    _kernel_device(x, c)
    return _pd.pairwise_sqdist(x.contiguous(), c.contiguous())


class _FlashAttention(torch.autograd.Function):
    """The flash-attention kernel with the backward kernel as its gradient
    (head-major q, k, v; the mask settings ``causal``, ``window``,
    ``q_offset``, ``kv_start`` and the scale are not differentiated)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, kv_start):
        mask = dict(causal=causal, window=window, scale=scale,
                    q_offset=q_offset, kv_start=kv_start)
        out, lse = _fa.flash_attention(q, k, v, return_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fab.flash_attention_bwd(q, k, v, out, dout, lse,
                                              **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None,
              kv_chunk: Optional[int] = None, q_offset: int = 0,
              kv_start: int = 0) -> torch.Tensor:
    """Model-layout attention (B, T, H, hd) x (B, Tk, Hk, hd), query row i
    at position ``q_offset + i``, keys below ``kv_start`` hidden (the
    reference's ``blockwise_attention`` settings).  On the CPU the plain
    version walks kv chunks of ``kv_chunk`` keys (the model's own chunking;
    default min(1024, Tk)).  On a CUDA device with grad wanted, the kernel
    pair as one autograd function."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = dict(causal=causal, window=window, scale=scale,
                q_offset=q_offset, kv_start=kv_start)
    if q.device.type == "cpu":
        out = _ref.flash_attention_ref(qh, kh, vh, kv_chunk=kv_chunk, **mask)
    else:
        _kernel_device(q, k, v)
        if _needs_grad(q, k, v):
            out = _FlashAttention.apply(qh, kh, vh, causal, window, scale,
                                        q_offset, kv_start)
        else:
            out = _fa.flash_attention(qh, kh, vh, **mask)
    return out.transpose(1, 2)


class _SSDScan(torch.autograd.Function):
    """The ``ssd_scan`` kernel with the ``ssd_scan_bwd`` kernel as its
    gradient (contiguous inputs; ``chunk`` is not differentiated), from the
    incoming state ``h0`` (None: zeros), whose gradient the backward kernel
    gives where it is wanted.  The forward keeps each chunk's incoming
    state for the backward: (B, nc, H, hd, N) fp32, 268 MB at mamba2-1.3b's
    training batch of 8 x 2,048."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, h0, chunk):
        y, hfin, states = _ssd.ssd_scan_with_states(xh, dt, A, Bm, Cm,
                                                    chunk=chunk, h0=h0)
        ctx.save_for_backward(xh, dt, A, Bm, Cm, states)
        ctx.chunk = chunk
        ctx.with_dh0 = h0 is not None and ctx.needs_input_grad[5]
        # an unused output's gradient comes as None, not as zeros
        ctx.set_materialize_grads(False)
        return y, hfin

    @staticmethod
    def backward(ctx, dy, dh_final):
        xh, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xh)
        grads = _ssdb.ssd_scan_bwd(xh, dt, A, Bm, Cm, states, dy, dh_final,
                                   chunk=ctx.chunk, with_dh0=ctx.with_dh0)
        dh0 = grads[5] if ctx.with_dh0 else None
        return (*grads[:5], dh0, None)


def ssd(xh, dt, A, Bm, Cm, *, chunk: int = 128,
        h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan from the incoming state ``h0`` (B, H, hd, N) fp32
    (None: zeros) -> (y (B, T, H, hd), final state (B, H, hd, N)).  On a
    CUDA device with grad wanted, the kernel pair as one autograd function
    (``h0``'s gradient from the backward kernel)."""
    if xh.device.type == "cpu":
        return _ref.ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    start = () if h0 is None else (h0,)
    _kernel_device(xh, dt, A, Bm, Cm, *start)
    ins = tuple(t.contiguous() for t in (xh, dt, A, Bm, Cm))
    if _needs_grad(*ins, *start):
        return _SSDScan.apply(*ins, h0, chunk)
    return _ssd.ssd_scan(*ins, chunk=chunk, h0=h0)
