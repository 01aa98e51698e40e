"""Sample-selection functions M(.) (train-set acquisition) and L(.)
(machine-labeling confidence ranking).

All uncertainty metrics consume :class:`repro_torch.models.layers.ScoreStats`
(computed pool-wide by the scoring engine / the margin_head CUDA
kernel); k-center consumes last-hidden-state features.  Ranking/argpartition
happen on host over numpy arrays — the expensive part (model inference over
the pool) is the distributed job, not this.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

UNCERTAINTY_METRICS = ("margin", "entropy", "least_confidence")
METRICS = UNCERTAINTY_METRICS + ("kcenter",)


def uncertainty_scores(metric: str, stats) -> np.ndarray:
    """Higher score = more uncertain (better M(.) candidate)."""
    if metric == "margin":
        return -np.asarray(stats.margin, np.float64)
    if metric == "entropy":
        return np.asarray(stats.entropy, np.float64)
    if metric == "least_confidence":
        return 1.0 - np.exp(np.asarray(stats.max_logprob, np.float64))
    raise ValueError(f"unknown uncertainty metric {metric!r}")


def select_for_training(
    metric: str,
    k: int,
    stats=None,
    features: Optional[np.ndarray] = None,
    candidates: Optional[np.ndarray] = None,
    anchors: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """M(.): pick ``k`` pool indices to human-label next.

    ``candidates`` are pool indices still unlabeled; uncertainty metrics rank
    by ``stats`` rows aligned with ``candidates``; ``kcenter`` runs greedy
    farthest-point on ``features`` rows (aligned the same way) against
    ``anchors`` (features of already-labeled samples).
    """
    assert candidates is not None
    k = min(k, len(candidates))
    if k <= 0:
        return np.zeros((0,), np.int64)
    if metric == "random":
        rng = rng or np.random.default_rng(0)
        return rng.choice(candidates, size=k, replace=False)
    if metric == "kcenter":
        assert features is not None
        sel = k_center_greedy(features, k, anchors=anchors)
        return np.asarray(candidates)[sel]
    scores = uncertainty_scores(metric, stats)
    assert len(scores) == len(candidates)
    top = np.argpartition(-scores, k - 1)[:k]
    return np.asarray(candidates)[top]


def rank_for_machine_labeling(stats, metric: str = "margin") -> np.ndarray:
    """L(.): order rows most-confident-first."""
    scores = uncertainty_scores(metric, stats)  # high = uncertain
    return np.argsort(scores, kind="stable")     # ascending = confident first


def k_center_greedy(features: np.ndarray, k: int,
                    anchors: Optional[np.ndarray] = None,
                    chunk: int = 4096) -> np.ndarray:
    """Greedy k-center (farthest-point) selection.  O(k * N * d) chunked.

    Returns row indices into ``features``.
    """
    X = np.asarray(features, np.float32)
    N = X.shape[0]
    k = min(k, N)
    if k <= 0:  # same contract as the device twin: nothing selected
        return np.zeros((0,), np.int64)
    min_d = np.full((N,), np.inf, np.float32)

    def update(center_vec):
        for lo in range(0, N, chunk):
            hi = min(lo + chunk, N)
            d = np.sum((X[lo:hi] - center_vec[None, :]) ** 2, axis=1)
            np.minimum(min_d[lo:hi], d, out=min_d[lo:hi])

    if anchors is not None and len(anchors):
        for a in np.asarray(anchors, np.float32):
            update(a)
        first = int(np.argmax(min_d))
    else:
        first = 0
    chosen = [first]
    update(X[first])
    for _ in range(1, k):
        nxt = int(np.argmax(min_d))
        chosen.append(nxt)
        update(X[nxt])
    return np.asarray(chosen, np.int64)


def machine_label_error_curve(stats, correct: np.ndarray,
                              thetas: Sequence[float],
                              metric: str = "margin") -> np.ndarray:
    """eps_T(S^theta): error of the top-theta confidence fraction (Fig. 5).

    ``correct`` is a bool array (classifier prediction == human label),
    row-aligned with ``stats``.  Returns the error rate over the
    most-confident ``theta`` fraction for each theta.
    """
    order = rank_for_machine_labeling(stats, metric)
    wrong = (~np.asarray(correct, bool))[order]
    n = len(wrong)
    cum_wrong = np.cumsum(wrong)
    out = []
    for th in thetas:
        m = max(int(round(th * n)), 1)
        m = min(m, n)
        out.append(cum_wrong[m - 1] / m)
    return np.asarray(out, np.float64)
