"""Compressed data-parallel train step (``repro.training.compressed_dp``):
the int8 error-feedback gradient all-reduce.

:func:`make_compressed_dp_train_step` builds the reference's replicated-
parameter DP step over a ``DeviceMesh``: every rank holds the whole
parameters and optimizer state and takes its own shard of the batch's
rows; its gradients (autograd through ``train_loop.loss_fn``) are averaged
with :func:`~repro_torch.distributed.compression.compressed_psum` over
``compress_axis`` (an int payload and one fp32 scale on the wire) and with
a plain mean over each of ``plain_axes``; then the global-norm clip and
AdamW run on every rank alike.  The quantization residual (one fp32 tree
per rank) rides in the carry, which keeps the scheme unbiased over steps.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.compression import tree_compressed_psum
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule
from repro_torch.training.train_loop import loss_fn


def init_ef_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's fp32 residual tree, zero."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _shard_rows(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """This rank's (index, count) among the batch shards over ``axes``,
    the first axis major (the reference's ``P(axes)`` on dim 0)."""
    index, count = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        index = index * size + mesh.get_local_rank(a)
        count *= size
    return index, count


def make_compressed_dp_train_step(model, tc: TrainConfig, mesh,
                                  compress_axis: str = "data",
                                  plain_axes: Tuple[str, ...] = ()):
    """-> ``step((state, ef), batch) -> ((state, ef), metrics)``.

    ``state`` is ``train_loop``'s ``{params, opt, step}`` and ``ef`` this
    rank's residual tree (:func:`init_ef_state`).  ``batch`` is the global
    batch, the same on every rank: each takes its shard of dim 0 over
    ``(compress_axis, *plain_axes)``.  The loss in ``metrics`` is the mean
    of the ranks' losses."""
    import torch.distributed as dist
    sched = make_schedule(tc)
    dp_axes = (compress_axis,) + tuple(plain_axes)
    index, count = _shard_rows(mesh, dp_axes)
    compress_group = mesh.get_group(compress_axis)
    plain_groups = [(mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)))
                    for a in plain_axes]

    def step(carry, batch):
        state, ef = carry
        rows = next(iter(batch.values())).shape[0]
        if rows % count:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{count} data-parallel ranks")
        per = rows // count
        local = {k: v[index * per:(index + 1) * per]
                 for k, v in batch.items()}
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state["params"].items()}
        names = sorted(params)
        with torch.enable_grad():
            loss = loss_fn(model, params, local)
            gs = torch.autograd.grad(loss, [params[k] for k in names])
        grads = dict(zip(names, gs))
        # int8 with error feedback over the slow axis, an exact mean over
        # the rest
        grads, new_ef = tree_compressed_psum(grads, ef, compress_group)
        loss = loss.detach().float().reshape(())
        dist.all_reduce(loss, group=compress_group)
        for group, size in plain_groups:
            for k in names:
                dist.all_reduce(grads[k], group=group)
                grads[k] = grads[k] / size
            dist.all_reduce(loss, group=group)
        loss = loss / count
        grads, gnorm = opt.clip_by_global_norm(grads, tc.grad_clip)
        lr = sched(state["step"])
        with torch.no_grad():
            new_params, new_slots = opt.adamw_update(
                {k: p.detach() for k, p in params.items()}, grads,
                state["opt"], state["step"], lr, tc)
        new_state = {"params": new_params, "opt": new_slots,
                     "step": state["step"] + 1}
        return (new_state, new_ef), {"loss": loss, "grad_norm": gnorm,
                                     "lr": lr}

    return step
