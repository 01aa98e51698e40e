"""Fused head projection + online top-2 / logsumexp / entropy: the CUDA
kernel ``csrc/margin_head.cu`` (the port of ``repro.kernels.margin_head``).

``margin_head(hidden, w)`` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`repro_torch.kernels.ref.margin_head_ref`
is its plain version.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0

_SYMBOLS = {torch.float32: "margin_head_f32", torch.bfloat16: "margin_head_bf16"}
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    if dtype not in _fns:
        fn = getattr(build.load("margin_head"), _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def margin_head(hidden: torch.Tensor, w_vocab: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """hidden: (T, D); w_vocab: (D, V), both fp32 or both bf16, contiguous,
    on one CUDA device -> (margin, entropy, max_logprob) fp32 and top1
    int32, each (T,)."""
    global launches
    if not (hidden.is_cuda and w_vocab.device == hidden.device):
        raise ValueError("margin_head: both inputs must be on one CUDA "
                         f"device, got {hidden.device} and {w_vocab.device}")
    if hidden.dtype not in _SYMBOLS or w_vocab.dtype != hidden.dtype:
        raise TypeError("margin_head takes fp32 or bf16 inputs of one dtype, "
                        f"got {hidden.dtype} and {w_vocab.dtype}")
    if hidden.ndim != 2 or w_vocab.ndim != 2 or \
            hidden.shape[1] != w_vocab.shape[0] or w_vocab.shape[1] < 1:
        raise ValueError(f"margin_head: bad shapes {tuple(hidden.shape)} x "
                         f"{tuple(w_vocab.shape)}")
    if not (hidden.is_contiguous() and w_vocab.is_contiguous()):
        raise ValueError("margin_head takes contiguous inputs")
    T, D = hidden.shape
    V = w_vocab.shape[1]
    if max(T, D, V) >= 2**31:
        raise ValueError(f"margin_head: ({T}, {D}, {V}) is too large")
    fn = _fn(hidden.dtype)
    dev = hidden.device
    outs = (torch.empty(T, dtype=torch.float32, device=dev),
            torch.empty(T, dtype=torch.float32, device=dev),
            torch.empty(T, dtype=torch.float32, device=dev),
            torch.empty(T, dtype=torch.int32, device=dev))
    if T == 0:
        return outs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(hidden.data_ptr(), w_vocab.data_ptr(),
                 *(o.data_ptr() for o in outs), T, D, V, stream)
    if err != 0:
        raise RuntimeError(f"margin_head launch failed: CUDA error {err}")
    launches += 1
    return outs
