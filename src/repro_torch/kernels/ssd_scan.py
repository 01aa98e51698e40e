"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` (the port
of ``repro.kernels.ssd_scan``).

``ssd_scan(xh, dt, A, Bm, Cm, chunk=...)`` launches the kernel on CUDA
tensors and raises on anything it does not take;
:func:`repro_torch.kernels.ref.ssd_scan_ref` is its plain version, and
:func:`repro_torch.kernels.ref.ssd_scan_passes_ref` the same split into the
kernel's three passes.  ``launches`` counts calls: each runs the three
passes (chunk summaries, inter-chunk walk, output) on one stream.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0

_SYMBOLS = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    with build.LOCK:
        if dtype not in _fns:
            fn = getattr(build.load("ssd_scan"), _SYMBOLS[dtype])
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        return _fns[dtype]


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, T, H, hd) fp32 or bf16; dt: (B, T, H), A: (H,), Bm/Cm:
    (B, T, N), fp32; all contiguous on one CUDA device.  Returns
    (y (B, T, H, hd) in xh's dtype, h_final (B, H, hd, N) fp32), with chunks
    of min(chunk, T) steps (T padded with dt = 0 inside the kernel)."""
    y, hfin, _ = ssd_scan_with_states(xh, dt, A, Bm, Cm, chunk=chunk)
    return y, hfin


def ssd_scan_with_states(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         chunk: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`, and the scratch the passes leave behind: each
    chunk's incoming state (B, nc, H, hd, N) fp32 (168 MB at zamba2-2.7b's
    prefill of 8 x 2,048 tokens, allocated per call)."""
    global launches
    ins = (xh, dt, A, Bm, Cm)
    if not (xh.is_cuda and all(t.device == xh.device for t in ins)):
        raise ValueError("ssd_scan: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ins]}")
    if xh.dtype not in _SYMBOLS or any(t.dtype != torch.float32
                                       for t in ins[1:]):
        raise TypeError("ssd_scan takes xh in fp32 or bf16 and dt, A, Bm, "
                        f"Cm in fp32, got {[t.dtype for t in ins]}")
    if xh.ndim != 4:
        raise ValueError(f"ssd_scan: bad xh shape {tuple(xh.shape)}")
    B, T, H, hd = xh.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    if dt.shape != (B, T, H) or A.shape != (H,) or \
            Bm.shape != (B, T, N) or Cm.shape != (B, T, N) or chunk < 1:
        raise ValueError(f"ssd_scan: bad shapes {[tuple(t.shape) for t in ins]}"
                         f" or chunk {chunk}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan takes contiguous inputs")
    if hd % 8 or N % 4:
        # the kernel copies 16-byte pieces of x rows and 4-float pieces of
        # the state
        raise ValueError(f"ssd_scan takes hd % 8 == 0 and N % 4 == 0, got "
                         f"hd {hd}, N {N}")
    xh, dt, A, Bm, Cm = ins = tuple(
        t if t.data_ptr() % 16 == 0 else t.clone() for t in ins)
    C = min(chunk, T)
    nc = -(-T // C) if T else 0
    if B > 65535 or nc > 65535 or B * T * H * hd >= 2**62:
        raise ValueError(f"ssd_scan: {tuple(xh.shape)} is too large")
    y = torch.empty_like(xh)
    hfin = torch.empty((B, H, hd, N), dtype=torch.float32, device=xh.device)
    states = torch.empty((B, nc, H, hd, N), dtype=torch.float32,
                         device=xh.device)
    if B * H * T == 0:
        return y, hfin.zero_(), states
    last = torch.empty((B, nc, H), dtype=torch.float32, device=xh.device)
    err = build.call(_fn(xh.dtype), xh.device,
                     *(t.data_ptr() for t in ins), y.data_ptr(),
                     hfin.data_ptr(), states.data_ptr(), last.data_ptr(), B,
                     T, H, hd, N, C)
    if err != 0:
        # error 1 (invalid value) includes a chunk too large for shared
        # memory: see csrc/ssd_scan.cu for the bytes a launch needs
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"(chunk {C}, N {N}, hd {hd})")
    with build.COUNT_LOCK:
        launches += 1
    return y, hfin, states
