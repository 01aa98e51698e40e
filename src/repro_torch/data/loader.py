"""Batching + host->device pipeline (``repro.data.loader``).

``ShardedLoader`` cuts host numpy arrays into global batches in the
reference's order (one ``numpy.random.default_rng(seed)`` permutation an
epoch, batches in permutation order, a ragged last batch dropped or
wrapped around) and delivers each as device tensors.  On a CUDA device
each batch is copied from pinned host memory on a side stream, one batch
ahead of the one being consumed (the reference's one-deep prefetch): the
consumer's stream waits on the copy's event and the tensors are recorded
on that stream.

Over a ``mesh`` (a ``DeviceMesh`` of the process group) every rank cuts
the same global batch and copies only its own rows of the batch dim's
split over ("pod", "data") (:func:`batch_sharding`), delivered as a
``DTensor`` of the global batch (:func:`device_put_global`), so the host
never copies a whole batch to the device.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


def batch_sharding(mesh, ndim: int) -> "shd.NamedSharding":
    """The batch dim over the mesh's ("pod", "data") axes, the rest
    whole."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    return shd.named(mesh, (first,) + (None,) * (ndim - 1))


def device_put_global(array: np.ndarray, mesh=None, device="cuda"):
    """A host array on the device: whole without a mesh, else a
    ``DTensor`` of the global array holding this rank's rows only."""
    if mesh is None:
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)
    sh = batch_sharding(mesh, array.ndim)
    rows = np.ascontiguousarray(array[shd.slices(array.shape, sh.spec,
                                                 mesh)])
    return shd.place(torch.from_numpy(rows).to(device), sh, array.shape)


class ShardedLoader:
    def __init__(self, data: Dict[str, np.ndarray], global_batch: int,
                 mesh=None, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 1, device="cuda"):
        sizes = {k: len(v) for k, v in data.items()}
        assert len(set(sizes.values())) == 1, sizes
        self.data = data
        self.n = next(iter(sizes.values()))
        self.global_batch = global_batch
        self.mesh = mesh
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = torch.device(device)
        self._stream = None

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(self.n)
        nb = self.n // self.global_batch if self.drop_last else \
            -(-self.n // self.global_batch)
        for b in range(nb):
            sel = order[b * self.global_batch:(b + 1) * self.global_batch]
            if len(sel) < self.global_batch:
                sel = np.concatenate(
                    [sel, order[: self.global_batch - len(sel)]])
            yield {k: v[sel] for k, v in self.data.items()}

    def _put(self, host_batch: Dict[str, np.ndarray]):
        """Start one batch's copy (this rank's rows over a mesh): (tensors,
        the copy's event or None, the global shapes or None)."""
        shapes = None
        if self.mesh is not None:
            shapes = {k: v.shape for k, v in host_batch.items()}
            host_batch = {k: v[shd.slices(v.shape, batch_sharding(
                self.mesh, v.ndim).spec, self.mesh)]
                for k, v in host_batch.items()}
        out, event = self._copy(host_batch)
        return out, event, shapes

    def _copy(self, host_batch: Dict[str, np.ndarray]):
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in host_batch.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in host_batch.items()}
        with torch.cuda.stream(self._stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _ready(self, item) -> Dict[str, torch.Tensor]:
        out, event, shapes = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)
        if shapes is not None:
            out = {k: shd.place(t, batch_sharding(self.mesh, t.ndim),
                                shapes[k]) for k, t in out.items()}
        return out

    def epoch(self) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of device-resident global batches (1-deep prefetch);
        over a mesh, DTensors of this rank's rows."""
        queue = collections.deque()
        for host_batch in self._host_batches():
            queue.append(self._put(host_batch))
            if len(queue) > self.prefetch:
                yield self._ready(queue.popleft())
        while queue:
            yield self._ready(queue.popleft())
