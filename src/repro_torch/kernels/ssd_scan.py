"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` (the port
of ``repro.kernels.ssd_scan``).

``ssd_scan(xh, dt, A, Bm, Cm, chunk=..., h0=...)`` launches the kernel on
CUDA tensors and raises on anything it does not take (``h0``: the incoming
state, None for zeros, the TPU kernel's only start);
:func:`repro_torch.kernels.ref.ssd_scan_ref` is its plain version, and
:func:`repro_torch.kernels.ref.ssd_scan_passes_ref` the same split into the
kernel's three passes.  ``launches`` counts calls: each runs the three
passes (chunk summaries, inter-chunk walk, output) on one stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        return _fns[dtype]


def check_inputs(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, name: str,
                 chunk: int) -> None:
    """Raise on inputs the kernels (``name``: the forward or its gradient)
    do not take: devices, dtypes, shapes, contiguity, hd % 8 and N % 4."""
    ins = (xh, dt, A, Bm, Cm)
    if not (xh.is_cuda and all(t.device == xh.device for t in ins)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in ins]}")
    if xh.dtype not in _SYMBOLS or any(t.dtype != torch.float32
                                       for t in ins[1:]):
        raise TypeError(f"{name} takes xh in fp32 or bf16 and dt, A, Bm, "
                        f"Cm in fp32, got {[t.dtype for t in ins]}")
    if xh.ndim != 4:
        raise ValueError(f"{name}: bad xh shape {tuple(xh.shape)}")
    B, T, H, hd = xh.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    if dt.shape != (B, T, H) or A.shape != (H,) or \
            Bm.shape != (B, T, N) or Cm.shape != (B, T, N) or chunk < 1:
        raise ValueError(f"{name}: bad shapes {[tuple(t.shape) for t in ins]}"
                         f" or chunk {chunk}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name} takes contiguous inputs")
    if hd % 8 or N % 4:
        # the kernel copies 16-byte pieces of x rows and 4-float pieces of
        # the state
        raise ValueError(f"{name} takes hd % 8 == 0 and N % 4 == 0, got "
                         f"hd {hd}, N {N}")


def check_state(h: Optional[torch.Tensor], shape: Tuple[int, ...],
                device: torch.device, name: str) -> Optional[torch.Tensor]:
    """A state the kernels read (``h0``, ``dh_final``): None, or fp32 of
    ``shape`` on ``device``, contiguous and 16-byte aligned (copied where
    it is not: the kernels read float4 pieces).  Raises on anything else."""
    if h is None:
        return None
    if tuple(h.shape) != tuple(shape) or h.device != device:
        raise ValueError(f"{name} {tuple(h.shape)} on {h.device}, want "
                         f"{tuple(shape)} on {device}")
    h = h.float()
    if h.is_contiguous() and h.data_ptr() % 16 == 0:
        return h
    return h.clone(memory_format=torch.contiguous_format)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, T, H, hd) fp32 or bf16; dt: (B, T, H), A: (H,), Bm/Cm:
    (B, T, N), fp32; all contiguous on one CUDA device; ``h0``: the state
    the scan starts from, (B, H, hd, N) fp32 (None: zeros).  Returns
    (y (B, T, H, hd) in xh's dtype, h_final (B, H, hd, N) fp32), with chunks
    of min(chunk, T) steps (T padded with dt = 0 inside the kernel)."""
    y, hfin, _ = ssd_scan_with_states(xh, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return y, hfin


def ssd_scan_with_states(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         chunk: int = 128, h0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`, and the scratch the passes leave behind: each
    chunk's incoming state (B, nc, H, hd, N) fp32, the first ``h0`` (168 MB
    at zamba2-2.7b's prefill of 8 x 2,048 tokens, allocated per call)."""
    global launches
    check_inputs(xh, dt, A, Bm, Cm, "ssd_scan", chunk)
    B, T, H, hd = xh.shape
    N = Bm.shape[-1]
    h0 = check_state(h0, (B, H, hd, N), xh.device, "ssd_scan: h0")
    xh, dt, A, Bm, Cm = ins = tuple(
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (xh, dt, A, Bm, Cm))
    C = min(chunk, T)
    nc = -(-T // C) if T else 0
    if B > 65535 or nc > 65535 or B * T * H * hd >= 2**62:
        raise ValueError(f"ssd_scan: {tuple(xh.shape)} is too large")
    y = torch.empty_like(xh)
    hfin = torch.empty((B, H, hd, N), dtype=torch.float32, device=xh.device)
    states = torch.empty((B, nc, H, hd, N), dtype=torch.float32,
                         device=xh.device)
    if B * H * T == 0:
        return y, (hfin.zero_() if h0 is None else hfin.copy_(h0)), states
    last = torch.empty((B, nc, H), dtype=torch.float32, device=xh.device)
    err = build.call(_fn(xh.dtype), xh.device,
                     *(t.data_ptr() for t in ins),
                     h0.data_ptr() if h0 is not None else None, y.data_ptr(),
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
