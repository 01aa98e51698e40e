"""Halo-exchange windowed attention for sequence-sharded serving
(``repro.serving.halo_attention``).

For sliding-window layers (window w) with activations sequence-sharded
over a mesh axis, a query in shard s attends to its own shard and the
last w tokens of shard s-1 only, so each rank sends exactly that halo to
the next rank (``batch_isend_irecv``) instead of gathering the whole
sequence's keys and values.

The attention runs through ``kernels.ops.attention`` in the halo's frame
(``q_offset`` = window, ``kv_start`` masking a missing halo): on a CUDA
device the ``flash_attention`` kernel, on the CPU its plain version.

Requirements: T divisible by the axis size, window <= T / axis size.
Global (full-attention) layers still need the gathered path.  The
exchange has no gradient: a training step gathers instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def _exchange(x: torch.Tensor, group, idx: int, n: int) -> torch.Tensor:
    """The previous rank's ``x`` (zeros on rank 0): every rank but the
    last sends its ``x`` on, every rank but the first receives."""
    import torch.distributed as dist
    halo = torch.zeros_like(x)
    ops = []
    if idx + 1 < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        ops.append(dist.P2POp(dist.irecv, halo,
                              dist.get_global_rank(group, idx - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return halo


def halo_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int, mesh, axis: str = "model",
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal sliding-window attention over a sequence sharded on
    ``axis`` of ``mesh`` (a ``DeviceMesh``).  q (B, T_loc, H, hd) and k, v
    (B, T_loc, Hk, hd) are this rank's shard of the sequence (its batch
    rows too, where the batch is sharded); the result is this rank's
    (B, T_loc, H, hd).  The last ``window`` keys and values travel one
    rank on along ``axis``; rank 0 has no predecessor and masks its
    (zero) halo through ``kv_start``."""
    T_loc = q.shape[1]
    if window > T_loc:
        raise ValueError(f"window {window} exceeds the shard's {T_loc} "
                         f"positions")
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    halo_k = _exchange(k[:, -window:], group, idx, n)
    halo_v = _exchange(v[:, -window:], group, idx, n)
    kk = torch.cat([halo_k, k], dim=1)
    vv = torch.cat([halo_v, v], dim=1)
    # relative frame: q[j] at window + j, keys at 0 .. window + T_loc - 1
    return ops.attention(
        q, kk, vv, causal=True, window=window, q_offset=window,
        kv_start=window if idx == 0 else 0,
        kv_chunk=min(1024, kk.shape[1]), scale=scale)
