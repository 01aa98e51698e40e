"""Tiled pairwise squared-euclidean distances: the CUDA kernel
``csrc/pairwise_dist.cu`` (the port of ``repro.kernels.pairwise_dist``).

``pairwise_sqdist(x, c)`` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`repro_torch.kernels.ref.pairwise_sqdist_ref`
is its plain version.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_MAX_M = 65535 * 64    # the grid's column-tile dimension


_fns = []


def _fn():
    """The C entry point, typed on first use."""
    if not _fns:
        fn = build.load("pairwise_dist").pairwise_sqdist_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns.append(fn)
    return _fns[0]


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x: (N, D) rows; c: (M, D) centres, fp32, contiguous, on one CUDA
    device -> (N, M) fp32 squared distances."""
    global launches
    if not (x.is_cuda and c.device == x.device):
        raise ValueError("pairwise_sqdist: both inputs must be on one CUDA "
                         f"device, got {x.device} and {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("pairwise_sqdist takes fp32 inputs, got "
                        f"{x.dtype} and {c.dtype}")
    if x.ndim != 2 or c.ndim != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_sqdist: bad shapes {tuple(x.shape)} x "
                         f"{tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("pairwise_sqdist takes contiguous inputs")
    N, D = x.shape
    M = c.shape[0]
    if M > _MAX_M or N >= 2**31:
        raise ValueError(f"pairwise_sqdist: ({N}, {M}) is too large")
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    if N == 0 or M == 0:
        return out
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), c.data_ptr(), out.data_ptr(), N, M, D, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_sqdist launch failed: CUDA error {err}")
    launches += 1
    return out
