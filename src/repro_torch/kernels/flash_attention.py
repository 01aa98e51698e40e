"""Flash attention with causal / sliding-window masks and GQA: the CUDA
kernel ``csrc/flash_attention.cu`` (the port of
``repro.kernels.flash_attention``).

``flash_attention(q, k, v)`` launches the kernel on CUDA tensors and raises
on anything it does not take: bf16 inputs go to the tensor-core kernel,
fp32 inputs to the exact fp32-FMA kernel (the dtype selects);
:func:`repro_torch.kernels.ref.flash_attention_ref` is its plain version.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
# the head dims the kernel is compiled for (csrc/flash_attention.cu): the
# JAX package's test grid and zamba2's 80
HEAD_DIMS = (8, 16, 32, 80)
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    if dtype not in _fns:
        fn = getattr(build.load("flash_attention"), _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, Hk, Tk, hd), H % Hk == 0, all fp32 or
    all bf16, on one CUDA device -> (B, H, Tq, hd) in q's dtype.

    Head-major, as the TPU kernel takes them.  Any strides are taken as
    long as hd is contiguous, so ``ops.attention`` passes transposed views
    of the model layout (B, T, H, hd) without a copy; the result is a
    head-major view of a contiguous (B, Tq, H, hd) tensor.  ``window``
    applies with or without ``causal``, as in the TPU kernel."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes fp32 or bf16 inputs of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    _, Hk, Tk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hk < 1 or H % Hk:
        raise ValueError(f"flash_attention: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention takes inputs with a contiguous "
                         "head dim")
    if B * H > 65535 or max(Tq, Tk) >= 2**31:
        raise ValueError(f"flash_attention: {tuple(q.shape)} is too large")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies 16-byte pieces of each row
        q, k, v = (t if t.data_ptr() % 16 == 0
                   and all(s % 8 == 0 for s in t.stride()[:3])
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * H * Tq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = hd ** -0.5 if scale is None else float(scale)
    fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, H, Hk, Tq, Tk, hd, scale,
                 int(causal), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
