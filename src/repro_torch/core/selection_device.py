"""Device greedy k-center (farthest-point) M(.) engine
(``repro.core.selection_device``).

The same greedy recursion as the host oracle ``selection.k_center_greedy``,
on the features' device:

* the pool is padded with the scoring engine's pow2 bucketing (row tiles
  of ``KCenterConfig.block``), and k to the next power of two — greedy
  selection is prefix-stable, so the extra centres are trimmed off and
  change nothing;
* anchor initialization (features of already-labeled samples) is the
  (N, M) distance-matrix workload: per row tile it goes through
  ``kernels.ops.pairwise_sqdist`` — the ``pairwise_dist`` CUDA kernel on a
  CUDA device — and folds a masked row-min, so the distance temporaries
  stay O(block * M);
* each greedy step takes one first-index argmax over the running
  min-distances and updates them with the expansion
  ``||x||^2 - 2 x.c + ||c||^2`` (a matvec).

Oracle contract: the EXACT chosen-index sequence of the host oracle on
integer-valued features (where every squared distance is exact), ties to
the first index — ``torch.argmax`` returns the first maximal index, as
numpy's and XLA's argmax do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.scoring import next_pow2 as _next_pow2
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KCenterConfig:
    block: int = 65536             # row tile for the anchor distances


def _anchor_min_dist(X: torch.Tensor, A: torch.Tensor, m: int,
                     block: int) -> torch.Tensor:
    """(Np,) min squared distance to the first ``m`` rows of the padded
    anchor matrix ``A``, one row tile at a time."""
    amask = torch.arange(A.shape[0], device=A.device) < m
    return torch.cat([
        torch.where(amask[None, :], ops.pairwise_sqdist(xb, A),
                    torch.inf).min(dim=1).values
        for xb in X.split(block)])


def _kcenter_padded(X: torch.Tensor, n: int, mind0: torch.Tensor, k: int,
                    has_anchors: bool) -> torch.Tensor:
    """X: (Np, d) padded pool; n: true row count; mind0: (Np,) initial
    min-distances (+inf rows, or min-over-anchors).  Returns the (k,)
    chosen row indices on the device."""
    Np = X.shape[0]
    x2 = torch.sum(X * X, dim=-1)
    valid = torch.arange(Np, device=X.device) < n

    def dist(j):
        c = X.index_select(0, j.reshape(1))[0]
        d = torch.clamp(x2 - 2.0 * (X @ c) + torch.dot(c, c), min=0.0)
        return torch.where(valid, d, -torch.inf)

    min_d = torch.where(valid, mind0, -torch.inf)
    first = (torch.argmax(min_d) if has_anchors
             else torch.zeros((), dtype=torch.int64, device=X.device))
    chosen = [first]
    min_d = torch.minimum(min_d, dist(first))
    for _ in range(1, k):
        j = torch.argmax(min_d)
        chosen.append(j)
        min_d = torch.minimum(min_d, dist(j))
    return torch.stack(chosen)


def k_center_greedy_device(features, k: int, anchors=None,
                           cfg: KCenterConfig = KCenterConfig(),
                           device="cuda") -> np.ndarray:
    """Device twin of ``selection.k_center_greedy``.

    ``features``: (N, d) array or tensor (e.g. the scoring engine's feature
    emission, already on the device); ``anchors``: (M, d) features of
    already-selected/labeled samples.  Returns (k,) row indices into
    ``features`` as host int64."""
    X = torch.as_tensor(features, dtype=torch.float32, device=device)
    N, d = X.shape
    k = int(min(k, N))
    if k <= 0:
        return np.zeros((0,), np.int64)

    # pow2-bucketed padding, mirroring PoolScoringEngine._pack
    if N >= cfg.block:
        block = cfg.block
        nb = _next_pow2(math.ceil(N / block))
    else:
        block = max(_next_pow2(N), 8)
        nb = 1
    Np = nb * block
    if Np != N:
        X = torch.cat([X, X.new_zeros((Np - N, d))])

    has_anchors = anchors is not None and len(anchors) > 0
    if has_anchors:
        A = torch.as_tensor(anchors, dtype=torch.float32, device=X.device)
        m = A.shape[0]
        Ma = max(_next_pow2(m), 8)
        if Ma != m:
            A = torch.cat([A, A.new_zeros((Ma - m, d))])
        mind0 = _anchor_min_dist(X, A, m, block)
    else:
        mind0 = torch.full((Np,), torch.inf, device=X.device)

    chosen = _kcenter_padded(X, N, mind0, min(_next_pow2(k), Np),
                             has_anchors)
    return chosen[:k].cpu().numpy().astype(np.int64)
