"""Baseline labeling strategies MCAL is compared against (paper §5;
``repro.core.baselines``).

* ``human_all_cost``  — label everything with the service.
* ``run_naive_al``    — classic active learning with fixed batch size
  delta: acquire delta samples by M(.), retrain, and stop as soon as
  machine-labeling ALL remaining samples meets the overall error bound
  ((|S|/|X|) * eps_T <= eps, theta = 1); then machine-label the rest.
  Sweeping delta and taking the best gives the paper's "oracle assisted
  AL" (Tbl. 2) — the oracle picks delta in hindsight.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import mcal
from repro_torch.core import selection as sel
from repro_torch.core.cost import CostLedger, LabelingService


def _buy(task, ledger: CostLedger, service: LabelingService,
         idx: np.ndarray) -> np.ndarray:
    """Purchase labels for ``idx`` with the same repeats-inclusive
    charging convention as ``SharedPool.buy_labels`` — baselines must
    price noisy-annotation votes like the campaigns they are compared
    against, or the savings comparison is skewed in their favor."""
    ann = getattr(task, "annotation", None)
    v0 = ann.votes_bought if ann is not None else 0
    labels = task.human_label(idx)
    votes = (ann.votes_bought - v0) if ann is not None else len(idx)
    ledger.pay_human(len(idx), service, votes=votes)
    return labels


@dataclasses.dataclass
class ALResult:
    cost: float
    ledger: Dict
    B_size: int
    S_size: int
    measured_error: float
    iterations: int
    machine_fraction: float
    met_constraint: bool


def run_naive_al(task, service: LabelingService, delta_frac: float,
                 eps_target: float = 0.05, metric: str = "margin",
                 test_frac: float = 0.05, max_iters: int = 120,
                 seed: int = 0) -> ALResult:
    X = task.pool_size
    rng = np.random.default_rng(seed)
    ledger = CostLedger()

    T_size = max(int(round(test_frac * X)), 16)
    T_idx = rng.choice(X, T_size, replace=False)
    T_labels = _buy(task, ledger, service, T_idx)

    in_T = np.zeros(X, bool)
    in_T[T_idx] = True
    in_B = np.zeros(X, bool)
    delta = max(int(round(delta_frac * X)), 8)

    labels = np.full(X, -1, np.int64)
    labels[T_idx] = T_labels

    b0 = rng.choice(np.nonzero(~in_T)[0], delta, replace=False)
    in_B[b0] = True
    labels[b0] = _buy(task, ledger, service, b0)

    it = 0
    met = False
    while it < max_iters:
        B_idx = np.nonzero(in_B)[0]
        ledger.pay_training(task.train(B_idx, labels[B_idx]))
        correct = task.eval_correct(T_idx, labels[T_idx])
        eps_T = float(np.mean(~correct))
        remaining = np.nonzero(~in_T & ~in_B)[0]
        overall = eps_T * len(remaining) / X
        it += 1
        if overall <= eps_target:
            met = True
            break
        if len(remaining) <= delta:
            break
        stats, feats = task.score(remaining)
        pick = sel.select_for_training(metric, delta, stats=stats,
                                       features=feats, candidates=remaining,
                                       rng=rng)
        labels[pick] = _buy(task, ledger, service, pick)
        in_B[pick] = True

    remaining = np.nonzero(~in_T & ~in_B)[0]
    if met and len(remaining):
        labels[remaining] = task.predict(remaining)
        S = len(remaining)
    else:  # constraint never met: humans finish the job
        if len(remaining):
            labels[remaining] = _buy(task, ledger, service, remaining)
        S = 0
    gt = mcal.oracle_labels(task, np.arange(X))  # evaluation only
    return ALResult(
        cost=ledger.total, ledger=ledger.snapshot(),
        B_size=int(np.sum(in_B)), S_size=S,
        measured_error=float(np.mean(labels != gt)), iterations=it,
        machine_fraction=S / X, met_constraint=met)


def oracle_al(task_factory, service: LabelingService,
              deltas=(0.01, 0.017, 0.033, 0.067, 0.10, 0.133, 0.167, 0.20),
              eps_target: float = 0.05, seed: int = 0):
    """Sweep delta; return (best_delta, best result, all results)."""
    results = {}
    for d in deltas:
        results[d] = run_naive_al(task_factory(), service, d,
                                  eps_target=eps_target, seed=seed)
    best = min(results, key=lambda d: results[d].cost)
    return best, results[best], results
