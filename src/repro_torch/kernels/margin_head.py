"""Fused head projection + online top-2 / logsumexp / entropy: the CUDA
kernel ``csrc/margin_head.cu`` (the port of ``repro.kernels.margin_head``).

``margin_head(hidden, w)`` launches the kernel on CUDA tensors and raises
on anything it does not take; :func:`repro_torch.kernels.ref.margin_head_ref`
is its plain version, and :func:`repro_torch.kernels.ref.margin_head_split_ref`
the same function split over column slices as the kernel splits it.
``launches`` counts wrapper calls that launched the kernel (one per call,
also where V spans several slices and a merge launch follows).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0

_MAX_SLICES = 65535     # the grid's slice dimension
_SYMBOLS = {torch.float32: "margin_head_f32", torch.bfloat16: "margin_head_bf16"}
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use, and the
    kernel's slice width (W columns per block of its slice pass; V over
    one slice adds the merge pass and its scratch)."""
    with build.LOCK:
        got = _fns.get(dtype)
        if got is None:
            lib = build.load("margin_head")
            fn = getattr(lib, _SYMBOLS[dtype])
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            got = _fns[dtype] = (fn, lib.margin_head_slice_cols())
        return got


def margin_head(hidden: torch.Tensor, w_vocab: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """hidden: (T, D); w_vocab: (D, V), both fp32 or both bf16, contiguous,
    on one CUDA device -> (margin, entropy, max_logprob) fp32 and top1
    int32, each (T,): views of one buffer."""
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
    fn, slice_cols = _fn(hidden.dtype)
    ns = -(-V // slice_cols)
    if max(T, D) >= 2**31 or ns > _MAX_SLICES:
        raise ValueError(f"margin_head: ({T}, {D}, {V}) is too large")
    # the four outputs, then the per-slice states the merge pass folds
    buf = torch.empty(4 * T + (6 * T * ns if ns > 1 else 0),
                      dtype=torch.float32, device=hidden.device)
    outs = (buf[:T], buf[T:2 * T], buf[2 * T:3 * T],
            buf[3 * T:4 * T].view(torch.int32))
    if T == 0:
        return outs
    err = build.call(fn, hidden.device, hidden.data_ptr(),
                     w_vocab.data_ptr(), buf.data_ptr(), T, D, V)
    if err != 0:
        raise RuntimeError(f"margin_head launch failed: CUDA error {err}")
    with build.COUNT_LOCK:
        launches += 1
    return outs
