"""Batching + host->device pipeline (``repro.data.loader``), on one device.

``ShardedLoader`` cuts host numpy arrays into global batches in the
reference's order (one ``numpy.random.default_rng(seed)`` permutation an
epoch, batches in permutation order, a ragged last batch dropped or
wrapped around) and delivers each as device tensors.  On a CUDA device
each batch is copied from pinned host memory on a side stream, one batch
ahead of the one being consumed (the reference's one-deep prefetch): the
consumer's stream waits on the copy's event and the tensors are recorded
on that stream.  The reference's sharded placement (``mesh`` given) is
the next slice of ROADMAP A.4 and is refused.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator

import numpy as np
import torch


class ShardedLoader:
    def __init__(self, data: Dict[str, np.ndarray], global_batch: int,
                 mesh=None, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 1, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "ShardedLoader over a mesh is not ported (ROADMAP A.4, its "
                "second half); it runs with mesh=None on one device")
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
        """Start one batch's copy: (tensors, the copy's event or None)."""
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
        out, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)
        return out

    def epoch(self) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of device-resident global batches (1-deep prefetch)."""
        queue = collections.deque()
        for host_batch in self._host_batches():
            queue.append(self._put(host_batch))
            if len(queue) > self.prefetch:
                yield self._ready(queue.popleft())
        while queue:
            yield self._ready(queue.popleft())
