"""Differentiable collectives over one mesh axis (the port's counterparts of
the collectives a JAX ``shard_map`` body calls, with the transposes JAX
gives them).

An :class:`Axis` is one dimension of a ``DeviceMesh`` seen from this rank:
its process group, size and this rank's index along it.  Each function
below is an autograd op whose backward is the forward's transpose:

=======================  ==============================  ===================
op                       forward                         backward
=======================  ==============================  ===================
:func:`all_gather`       tiled all-gather along ``dim``  reduce-scatter (sum)
:func:`all_to_all`       tiled all-to-all on dim 0       all-to-all on dim 0
:func:`psum`             all-reduce (sum)                identity, or a sum
                                                         where the cotangent
                                                         differs by rank
:func:`split`            this rank's chunk of ``dim``    all-gather
:func:`gather`           all-gather along ``dim``        this rank's chunk
:func:`replicate`        identity                        all-reduce (sum)
=======================  ==============================  ===================

``split`` / ``gather`` / ``replicate`` (no-ops over an axis of one rank,
where they move nothing) are the boundary of a sharded island
inside a program whose tensors are whole on every rank: ``split`` takes a
rank's shard of a whole tensor (its gradient is assembled whole again),
``gather`` assembles a sharded result whole on every rank (every rank then
holds the same cotangent, so each keeps its chunk), and ``replicate``
marks a whole input every rank uses on its own shard of the work (its
gradient sums the ranks' contributions).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Axis:
    group: Any
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        dim = mesh.mesh_dim_names.index(name)
        return cls(mesh.get_group(name), int(mesh.size(dim)),
                   int(mesh.get_local_rank(name)))


def _gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    import torch.distributed as dist
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((x0.shape[0] // axis.size,) + tuple(x0.shape[1:]),
                      dtype=x0.dtype, device=x0.device)
    dist.reduce_scatter(out, list(x0.chunk(axis.size)), group=axis.group)
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, axis: Axis, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=axis.group)
    return out


def _chunk(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


def _a2a(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _a2a(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.axis), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, varying):
        ctx.axis, ctx.varying = axis, varying
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.axis) if ctx.varying else g), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _chunk(x, dim, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.axis).contiguous(), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return _AllGather.apply(x, dim, axis)


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: chunk i of dim 0
    goes to rank i, and chunk j of the result came from rank j."""
    return _AllToAll.apply(x, axis)


def psum(x: torch.Tensor, axis: Axis, varying: bool = False) -> torch.Tensor:
    """``jax.lax.psum``.  Its transpose is the identity where every rank
    of the axis goes on with the same cotangent, and a sum where the
    result feeds work that differs by rank (``varying``): what JAX's
    implicit ``pvary`` after the psum transposes to."""
    return _Psum.apply(x, axis, varying)


def split(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's chunk of ``dim`` (size divisible by the axis); ``x``
    itself over an axis of one rank."""
    return x if axis.size == 1 else _Split.apply(x, dim, axis)


def gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The ranks' chunks along ``dim``, whole on every rank; ``x`` itself
    over an axis of one rank."""
    return x if axis.size == 1 else _Gather.apply(x, dim, axis)


def replicate(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` as it is; its gradient sums the ranks' gradients."""
    return x if axis.size == 1 else _Replicate.apply(x, axis)


def all_reduce_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.pmax`` (no gradient)."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), axis, dist.ReduceOp.MAX)
