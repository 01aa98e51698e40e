"""The gradient of the SSD chunked scan: the CUDA kernel
``csrc/ssd_scan_bwd.cu``, the backward of ``csrc/ssd_scan.cu`` (the port of
``repro.kernels.ssd_scan``, which has no backward on the TPU: the reference
differentiates its jnp ``ssd_chunked`` instead).

``ssd_scan_bwd(xh, dt, A, Bm, Cm, h_in, dy, dh_final)`` launches it on CUDA
tensors and raises on anything it does not take (the forward's dtypes and
shapes); ``h_in`` is each chunk's incoming state, which the forward leaves
behind (``ssd_scan_with_states``; the first is the forward's ``h0``), and
``with_dh0`` adds the gradient of that incoming state (what the reverse
walk leaves after the first chunk) to the result.  It runs its launches
on one stream (G = C B^T, the chunk summaries of dy, the reverse walk over
the chunks, then dx, dC and dB, and the per-position dt and A terms) with
no atomics,
so its result does not depend on the order blocks run in; the groups'
shares of dB and dC and the chunks' shares of dA are summed here, in a
fixed order.  bf16 xh at hd 64, chunk 128 and N 64 or 128 (what training
sends) runs dx and one merged dC + dB launch on Hopper's ``wgmma`` with
TMA-fed tiles (``csrc/sm90.cuh``); every other shape, and fp32 xh, runs a
dx, a dC and a dB launch on ``mma.sync``.  ``torch.autograd.grad`` through
:func:`repro_torch.kernels.ref.ssd_scan_ref` is its plain version,
:func:`repro_torch.kernels.ref.ssd_scan_bwd_passes_ref` the same split as
the kernel splits it.  ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as _ssd

launches = 0

# heads a block of the chunk, dx, dc and db passes takes (HG in the source)
HEAD_GROUP = 8
_SYMBOLS = {torch.float32: "ssd_scan_bwd_f32",
            torch.bfloat16: "ssd_scan_bwd_bf16"}
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    with build.LOCK:
        if dtype not in _fns:
            fn = getattr(build.load("ssd_scan_bwd"), _SYMBOLS[dtype])
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        return _fns[dtype]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where it is not contiguous or not
    16-byte aligned (the kernel reads 16-byte pieces)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def smem_bytes(C: int, N: int, hd: int, f32: bool) -> dict:
    """The dynamic shared memory of each launch at chunk ``C`` (bytes),
    keyed by launch: gram, chunk, dx, dc, db, final, or on the wgmma route
    gram, chunk, dx, dcdb (the merged dC and dB launch), final."""
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_smem
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 6)()
    if fn(C, N, hd, int(f32), ctypes.addressof(out)):
        return dict(zip(("gram", "chunk", "dx", "dcdb", "final"),
                        (*out[:4], out[5])))
    return dict(zip(("gram", "chunk", "dx", "dc", "db", "final"), out))


def ssd_scan_bwd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, h_in: torch.Tensor,
                 dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None,
                 *, chunk: int = 128, with_dh0: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """The forward's inputs (as ``ssd_scan`` takes them), each chunk's
    incoming state ``h_in`` (B, nc, H, hd, N) fp32, the output's gradient
    ``dy`` (B, T, H, hd) and the final state's ``dh_final`` (B, H, hd, N;
    None for zeros), on one CUDA device -> (dxh in xh's dtype, ddt (B, T,
    H), dA (H,), dBm (B, T, N), dCm (B, T, N), fp32), and with
    ``with_dh0`` the incoming state's gradient dh0 (B, H, hd, N) fp32
    after them."""
    global launches
    _ssd.check_inputs(xh, dt, A, Bm, Cm, "ssd_scan_bwd", chunk)
    B, T, H, hd = xh.shape
    N = Bm.shape[-1]
    C = min(chunk, T)
    nc = -(-T // C) if T else 0
    if B > 65535 or nc > 65535 or B * T * H * hd >= 2**62:
        raise ValueError(f"ssd_scan_bwd: {tuple(xh.shape)} is too large")
    dev = xh.device
    if h_in.shape != (B, nc, H, hd, N) or h_in.dtype != torch.float32 or \
            h_in.device != dev:
        raise ValueError(f"ssd_scan_bwd: h_in {tuple(h_in.shape)} "
                         f"{h_in.dtype} on {h_in.device}, want "
                         f"{(B, nc, H, hd, N)} fp32 on {dev}")
    if dy.shape != xh.shape or dy.device != dev:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device}, want {tuple(xh.shape)} on {dev}")
    dh_final = _ssd.check_state(dh_final, (B, H, hd, N), dev,
                                "ssd_scan_bwd: dh_final")
    h_in, dy = _aligned(h_in), _aligned(dy.to(xh.dtype))
    xh, dt, A, Bm, Cm = (_aligned(t) for t in (xh, dt, A, Bm, Cm))
    groups = -(-H // HEAD_GROUP)
    CP = -(-C // 32) * 32 if C else 0
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xh)
    ddt = torch.empty((B, T, H), **f32)
    dh0 = torch.empty((B, H, hd, N), **f32) if with_dh0 else None
    if B * H * T == 0:
        # no position: the final state is the incoming one
        if with_dh0:
            dh0.zero_() if dh_final is None else dh0.copy_(dh_final)
        return (dx.zero_(), ddt.zero_(), torch.zeros((H,), **f32),
                torch.zeros((B, T, N), **f32),
                torch.zeros((B, T, N), **f32)) + ((dh0,) if with_dh0 else ())
    dAp = torch.empty((B, nc, H), **f32)
    dBp, dCp = (torch.empty((groups, B, nc * C, N), **f32) for _ in range(2))
    # G (or G^T), then for bf16 xh room for B and C split into bf16 hi and
    # lo planes (4, B, nc, CP, N), which the wgmma route's passes load
    planes = 2 * B * nc * CP * N if xh.dtype == torch.bfloat16 else 0
    gram = torch.empty(B * nc * CP * CP + planes, **f32)
    gout = torch.empty((B, nc, H, hd, N), **f32)
    terms = torch.empty((B, nc, H, 6, CP), **f32)
    last = torch.empty((B, nc, H), **f32)
    err = build.call(
        _fn(xh.dtype), dev, xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), h_in.data_ptr(), dy.data_ptr(),
        dh_final.data_ptr() if dh_final is not None else None,
        dh0.data_ptr() if with_dh0 else None, dx.data_ptr(),
        ddt.data_ptr(), dAp.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
        gram.data_ptr(), gout.data_ptr(), terms.data_ptr(), last.data_ptr(),
        B, T, H, hd, N, C)
    if err != 0:
        # error 1 (invalid value) includes a chunk too large for shared
        # memory: ``smem_bytes`` gives the bytes each launch needs
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err} "
                           f"(chunk {C}, N {N}, hd {hd})")
    with build.COUNT_LOCK:
        launches += 1
    # the groups' and the chunks' shares, summed in a fixed order
    dB, dC = ((p.sum(0) if groups > 1 else p[0])[:, :T].contiguous()
              for p in (dBp, dCp))
    return (dx, ddt, dAp.sum((0, 1)), dB, dC) + ((dh0,) if with_dh0 else ())
