"""The gradient of flash attention: the CUDA kernel
``csrc/flash_attention_bwd.cu``, the backward of ``csrc/flash_attention.cu``
(the port of ``repro.kernels.flash_attention``, which has no backward on
the TPU: the reference differentiates its jnp attention instead).

``flash_attention_bwd(q, k, v, out, dout, lse)`` launches it on CUDA
tensors and raises on anything it does not take (the forward's dtypes,
head dims and masks); ``lse`` is the forward's per-row log-sum-exp
(``flash_attention(..., return_lse=True)``).  It runs three launches on one
stream: D = rowsum(dO o) (and, on the wgmma route, qs = q * scale in bf16,
but at hd 256 with a power-of-two scale, which it reads as q), then dK and
dV a key tile a block, then dQ a query tile a block, with no
atomics, so its result does not depend on the order blocks run in.  bf16
inputs at hd 64, 80, 128 and 256 (every shape training gives it; hd 80 at
the width of two whole 64-column panels, zero past hd) run on Hopper's
``wgmma`` with TMA-fed tiles (``csrc/sm90.cuh``): blocks of 128 keys (dK,
dV) or queries (dQ), each of two consumer warpgroups 64 of them at the full
width; at hd 256 dK/dV blocks of 64 keys, one consumer accumulating dV and
the other dK at the full width, and dQ blocks of 64 queries of two query
heads of a kv group, a consumer each (128 fp32 accumulators a thread
throughout).  At hd 16 and 32 they run on ``mma.sync``; fp32 inputs, and
bf16 at hd 8, on fp32 FMAs.
``torch.autograd.grad`` through
:func:`repro_torch.kernels.ref.flash_attention_ref` is its plain version,
:func:`repro_torch.kernels.ref.flash_attention_bwd_tiled_ref` the wgmma
route's arithmetic step by step.  ``q_offset`` and ``kv_start`` are the
forward's mask settings (keys below ``kv_start`` get zero gradients).
``launches`` counts calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_inputs, mask_args

launches = 0

_SYMBOLS = {torch.float32: "flash_attention_bwd_f32",
            torch.bfloat16: "flash_attention_bwd_bf16"}
# bf16 head dims of the wgmma route, whose kernels take a workspace of qs
# (B H Tq hd bf16) and 64-row tiles of lse and D (B H ceil(Tq / 64) 128
# fp32); every other route takes D alone (B H Tq fp32)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    with build.LOCK:
        if dtype not in _fns:
            fn = getattr(build.load("flash_attention_bwd"), _SYMBOLS[dtype])
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                           + [ctypes.c_float] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        return _fns[dtype]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        q_offset: int = 0, kv_start: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Head-major q (B, H, Tq, hd), k/v (B, Hk, Tk, hd), the forward's out
    and the gradient dout (B, H, Tq, hd), all of one dtype (fp32 or bf16),
    and lse (B, H, Tq) fp32, on one CUDA device -> (dq, dk, dv) in that
    dtype, each a head-major view of a contiguous model-layout tensor
    ((B, Tq, H, hd), (B, Tk, Hk, hd)).  Any strides with a contiguous head
    dim are taken."""
    global launches
    check_inputs(q, k, v, "flash_attention_bwd")
    mask = mask_args(causal, window, q_offset, kv_start,
                     "flash_attention_bwd")
    B, H, Tq, hd = q.shape
    _, Hk, Tk, _ = k.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} on {t.device}, want "
                             f"{tuple(q.shape)} on {q.device}")
    out, dout = (t.to(q.dtype) if t.dtype != q.dtype else t
                 for t in (out, dout))
    out, dout = (t if t.stride(3) == 1
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (out, dout))
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels copy 16-byte pieces of each row (TMA
        # takes byte strides that are positive multiples of 16)
        q, k, v, out, dout = (
            t if t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and s > 0 for s in t.stride()[:3])
            else t.clone(memory_format=torch.contiguous_format)
            for t in (q, k, v, out, dout))
    if lse.shape != (B, H, Tq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want a contiguous (B, H, Tq) fp32")
    dq = torch.empty((B, Tq, H, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((B, Tk, Hk, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2) for _ in range(2))
    if B * H * Tq == 0 or Tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if q.dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        words = B * H * Tq * hd // 2 + B * H * -(-Tq // 64) * 128
    else:
        words = B * H * Tq
    work = torch.empty(words, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in t.stride()[:3]))
    scale = hd ** -0.5 if scale is None else float(scale)
    err = build.call(_fn(q.dtype), q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides),
                     B, H, Hk, Tq, Tk, hd, scale, *mask)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: CUDA error {err}")
    with build.COUNT_LOCK:
        launches += 1
    return dq, dk, dv
