"""Flash attention with causal / sliding-window masks and GQA: the CUDA
kernel ``csrc/flash_attention.cu`` (the port of
``repro.kernels.flash_attention``).

``flash_attention(q, k, v)`` launches the kernel on CUDA tensors and raises
on anything it does not take; head dims 8, 16, 32, 64, 80, 128 and 256
(:data:`HEAD_DIMS`).  The dtype and the head dim select the route: bf16 at
hd 64, 80 and 128 (:data:`WGMMA_HEAD_DIMS`: whisper-tiny's, zamba2's and
the dense LMs') runs on Hopper's ``wgmma`` with TMA-fed tiles (128 query
rows a block as two consumer warpgroups, 128-key tiles; hd 80 at the
width of two 64-column panels, zero past hd); bf16 at hd 8, 16, 32 and 256
on ``mma.sync`` (128 rows over 64-key tiles up to hd 32, 64 rows over 32
keys at hd 256); fp32 on the exact fp32-FMA kernel (one thread a query
row over 64-key tiles up to hd 80, hd / 32 threads a row over 4096 / hd
keys a tile from hd 128).
:func:`repro_torch.kernels.ref.flash_attention_ref` is its plain version,
:func:`repro_torch.kernels.ref.flash_attention_lse_ref` that of the
log-sum-exp.
With ``return_lse`` the kernel also writes each query row's log-sum-exp
(B, H, Tq) fp32, which the backward kernel
(:mod:`repro_torch.kernels.flash_attention_bwd`) recomputes the softmax
from; without it (serving) the kernel does the same work as before.
``q_offset`` (the position of query row 0) and ``kv_start`` (keys below it
hidden) are the reference's ``blockwise_attention`` mask settings
(``csrc/attn_mask.cuh``): a rank of a sequence split attends from its
positions over the gathered keys, halo attention masks a missing halo.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

launches = 0

_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
# the head dims the kernel is compiled for (csrc/flash_attention.cu): the
# JAX package's test grid (8, 16, 32), whisper-tiny's 64, zamba2's 80,
# qwen2's, qwen1.5's and phi3's 128, and gemma3's 256
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
# bf16 head dims of the wgmma route (csrc/flash_attention.cu,
# ``flash_attention_wgmma_kernel``)
WGMMA_HEAD_DIMS = (64, 80, 128)
_fns = {}


def _fn(dtype: torch.dtype):
    """The C entry point for ``dtype``, typed on first use."""
    with build.LOCK:
        if dtype not in _fns:
            fn = getattr(build.load("flash_attention"), _SYMBOLS[dtype])
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                           + [ctypes.c_float] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[dtype] = fn
        return _fns[dtype]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 name: str = "flash_attention") -> None:
    """Raise on what the kernels do not take (the forward's and the
    backward's rules alike)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 inputs of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    _, Hk, Tk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hk < 1 or H % Hk:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} takes hd in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} takes inputs with a contiguous head dim")
    if B * H > 65535 or max(Tq, Tk) >= 2**31:
        raise ValueError(f"{name}: {tuple(q.shape)} is too large")


def mask_args(causal: bool, window: int, q_offset: int, kv_start: int,
              name: str = "flash_attention") -> Tuple[int, int, int, int]:
    """The C entry points' four mask ints; raises on a negative window,
    offset or start."""
    args = (int(causal), int(window), int(q_offset), int(kv_start))
    if min(args[1:]) < 0 or max(args[2:]) >= 2**31:
        raise ValueError(f"{name}: window {window}, q_offset {q_offset}, "
                         f"kv_start {kv_start} out of range")
    return args


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    return_lse: bool = False, q_offset: int = 0,
                    kv_start: int = 0):
    """q: (B, H, Tq, hd); k, v: (B, Hk, Tk, hd), H % Hk == 0, all fp32 or
    all bf16, on one CUDA device -> (B, H, Tq, hd) in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp (B, H, Tq) fp32.

    Head-major, as the TPU kernel takes them.  Any strides are taken as
    long as hd is contiguous, so ``ops.attention`` passes transposed views
    of the model layout (B, T, H, hd) without a copy; the result is a
    head-major view of a contiguous (B, Tq, H, hd) tensor.  ``window``
    applies with or without ``causal``, as in the TPU kernel; query row i
    sits at position ``q_offset + i`` and keys below ``kv_start`` are
    hidden."""
    global launches
    check_inputs(q, k, v)
    mask = mask_args(causal, window, q_offset, kv_start)
    B, H, Tq, hd = q.shape
    _, Hk, Tk, _ = k.shape
    if q.dtype == torch.bfloat16:
        # the tensor-core kernels copy 16-byte pieces of each row (the
        # wgmma route's tensor maps need the same alignment)
        q, k, v = (t if t.data_ptr() % 16 == 0
                   and all(s % 8 == 0 for s in t.stride()[:3])
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if B * H * Tq == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = hd ** -0.5 if scale is None else float(scale)
    err = build.call(_fn(q.dtype), q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     ctypes.addressof(strides),
                     B, H, Hk, Tq, Tk, hd, scale, *mask)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    with build.COUNT_LOCK:
        launches += 1
    return (out, lse) if return_lse else out
