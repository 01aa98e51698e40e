"""Gradient compression: int8 quantization with error feedback
(``repro.distributed.compression``).

Compressing the data-parallel gradient reduction to int8 on the slow axis
cuts its wire 4x against fp32.  Error feedback keeps the scheme unbiased
over time: each rank's quantization residual is added back to its next
step's gradient before quantizing.

:func:`compressed_psum` is the reference's shard-map building block over a
process group: each rank quantizes with its own scale, a MAX all-reduce
shares the largest scale, each rank requantizes against it, an int32 SUM
all-reduce adds the payloads exactly, and the sum is dequantized and
divided by the group's size.  Rounding is half to even in both packages
(``torch.round``, ``jnp.round``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_ef(g: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale fp32 scalar, new residual fp32)."""
    gf = g.float() + residual
    scale = torch.amax(torch.abs(gf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback int8 mean of ``g`` over ``group`` (the default
    group when None): ``(mean in g's dtype, new residual)``.  The wire
    carries the int payload and one fp32 scalar."""
    import torch.distributed as dist
    q, scale, new_residual = quantize_ef(g, residual)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    # requantize against the shared scale so the integer sum is exact
    q_shared = torch.clamp(torch.round(q.float() * (scale / scale_max)),
                           -127, 127).to(torch.int32)
    dist.all_reduce(q_shared, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    mean = q_shared.float() * scale_max / n
    return mean.to(g.dtype), new_residual


def init_ef_state(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A zero fp32 residual per gradient leaf."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def tree_compressed_psum(grads: Dict[str, torch.Tensor],
                         ef_state: Dict[str, torch.Tensor], group=None):
    """:func:`compressed_psum` over every leaf, in sorted path order (the
    reference's leaf order): ``(mean grads, new residuals)``."""
    new_g, new_r = {}, {}
    for k in sorted(grads):
        new_g[k], new_r[k] = compressed_psum(grads[k], ef_state[k], group)
    return new_g, new_r
