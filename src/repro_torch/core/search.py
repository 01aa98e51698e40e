"""Joint (|B|, theta) minimum-cost search (paper §3, Alg. 1 line 18) and the
delta-adaptation rule (line 20).

Given per-theta truncated power laws, the fitted training cost model, and the
sunk cost so far, the search scans a vectorized grid of candidate training
sizes (multiples of delta above the current |B|) x the theta grid and returns
the feasible minimizer of

    C(B, theta) = (|X| - |S|) * C_h + C_spent + C_grow(|B_i| -> B; delta)

subject to  (|S| / |X|) * eps_theta(B) <= eps_target,  |S| = theta * (|X| - |T| - B).

theta = 0 (human-label everything) is always feasible and acts as the
fallback arm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost import LabelingService, TrainCostModel
from repro_torch.core.powerlaw import PowerLaw

MAX_GRID = 4096


@dataclasses.dataclass(frozen=True)
class SearchResult:
    cost: float                 # predicted total C*
    B_opt: int                  # optimal training-set size
    theta_opt: float            # optimal machine-label fraction
    machine_labeled: int        # |S*| at the optimum
    feasible: bool              # False -> only the human-all arm exists
    human_all_cost: float       # cost of the theta=0 fallback
    # full surface for diagnostics/benchmarks: cost[b_idx, theta_idx]
    grid_B: Optional[np.ndarray] = None
    grid_theta: Optional[np.ndarray] = None
    grid_cost: Optional[np.ndarray] = None
    grid_feasible: Optional[np.ndarray] = None


def _grow_cost_vec(cost_model: TrainCostModel, current_B: int,
                   grid_B: np.ndarray, delta: int) -> np.ndarray:
    """Vectorized cost_to_grow for grid points current_B + j*delta."""
    j = np.round((grid_B - current_B) / max(delta, 1)).astype(np.int64)
    if cost_model.exponent == 1:
        # sum_{i=1..j} (current_B + i*delta)
        return cost_model.c_u * (j * current_B + delta * j * (j + 1) / 2.0)
    out = np.zeros(len(grid_B), np.float64)
    for i, b in enumerate(grid_B):
        out[i] = cost_model.cost_to_grow(current_B, int(b), delta)
    return out


def joint_search(
    *,
    pool_size: int,
    test_size: int,
    current_B: int,
    spent: float,
    laws: Dict[float, PowerLaw],
    cost_model: TrainCostModel,
    delta: int,
    service: LabelingService,
    eps_target: float,
    keep_surface: bool = False,
) -> SearchResult:
    X = pool_size
    C_h = service.price_per_label
    human_all = X * C_h + spent

    B_max = X - test_size
    delta = max(int(delta), 1)
    n_steps = max(int((B_max - current_B) // delta), 0)
    stride = max(n_steps // MAX_GRID, 1) * delta if n_steps > MAX_GRID else delta
    grid_B = np.arange(current_B, B_max + 1, stride, dtype=np.int64)
    if len(grid_B) == 0:
        grid_B = np.asarray([current_B], np.int64)

    thetas = np.asarray(sorted(laws.keys()), np.float64)
    grow = _grow_cost_vec(cost_model, current_B, grid_B, delta)

    eps = np.stack([laws[t].predict(grid_B) for t in thetas], axis=1)  # (Nb, Nt)
    remaining = np.maximum(X - test_size - grid_B, 0)[:, None]         # (Nb, 1)
    S = thetas[None, :] * remaining                                    # (Nb, Nt)
    feasible = (S / X) * eps <= eps_target
    cost = (X - S) * C_h + spent + grow[:, None]

    masked = np.where(feasible, cost, np.inf)
    best_flat = int(np.argmin(masked))
    bi, ti = np.unravel_index(best_flat, masked.shape)
    best_cost = float(masked[bi, ti])

    if not np.isfinite(best_cost) or best_cost >= human_all:
        return SearchResult(
            cost=human_all, B_opt=current_B, theta_opt=0.0, machine_labeled=0,
            feasible=bool(np.isfinite(best_cost)), human_all_cost=human_all,
            grid_B=grid_B if keep_surface else None,
            grid_theta=thetas if keep_surface else None,
            grid_cost=cost if keep_surface else None,
            grid_feasible=feasible if keep_surface else None)
    return SearchResult(
        cost=best_cost, B_opt=int(grid_B[bi]), theta_opt=float(thetas[ti]),
        machine_labeled=int(round(S[bi, ti])), feasible=True,
        human_all_cost=human_all,
        grid_B=grid_B if keep_surface else None,
        grid_theta=thetas if keep_surface else None,
        grid_cost=cost if keep_surface else None,
        grid_feasible=feasible if keep_surface else None)


def budget_search(
    *,
    pool_size: int,
    test_size: int,
    current_B: int,
    spent: float,
    laws: Dict[float, PowerLaw],
    cost_model: TrainCostModel,
    delta: int,
    service: LabelingService,
    budget: float,
) -> SearchResult:
    """Budget-constrained variant (§4): minimize predicted overall error
    subject to total cost <= budget."""
    X = pool_size
    C_h = service.price_per_label
    human_all = X * C_h + spent

    B_max = X - test_size
    delta = max(int(delta), 1)
    grid_B = np.arange(current_B, B_max + 1, delta, dtype=np.int64)
    if len(grid_B) == 0:
        grid_B = np.asarray([current_B], np.int64)
    if len(grid_B) > MAX_GRID:
        grid_B = grid_B[:: len(grid_B) // MAX_GRID + 1]
    thetas = np.asarray(sorted(laws.keys()), np.float64)
    grow = _grow_cost_vec(cost_model, current_B, grid_B, delta)
    eps = np.stack([laws[t].predict(grid_B) for t in thetas], axis=1)
    remaining = np.maximum(X - test_size - grid_B, 0)[:, None]
    S = thetas[None, :] * remaining
    cost = (X - S) * C_h + spent + grow[:, None]
    overall_err = (S / X) * eps
    within = cost <= budget

    if human_all <= budget:  # human-all is error-free and affordable
        return SearchResult(cost=human_all, B_opt=current_B, theta_opt=0.0,
                            machine_labeled=0, feasible=True,
                            human_all_cost=human_all)
    masked = np.where(within, overall_err, np.inf)
    best_flat = int(np.argmin(masked))
    bi, ti = np.unravel_index(best_flat, masked.shape)
    if not np.isfinite(masked[bi, ti]):
        # nothing fits the budget: stop training now, machine-label all
        return SearchResult(cost=float(cost[0, -1]), B_opt=current_B,
                            theta_opt=1.0,
                            machine_labeled=int(remaining[0, 0]),
                            feasible=False, human_all_cost=human_all)
    return SearchResult(cost=float(cost[bi, ti]), B_opt=int(grid_B[bi]),
                        theta_opt=float(thetas[ti]),
                        machine_labeled=int(round(S[bi, ti])), feasible=True,
                        human_all_cost=human_all)


def adapt_delta(
    *,
    current_B: int,
    B_opt: int,
    cstar: float,
    spent: float,
    pool_size: int,
    test_size: int,
    machine_labeled: int,
    cost_model: TrainCostModel,
    service: LabelingService,
    beta: float = 0.05,
    max_N: int = 64,
) -> int:
    """Alg. 1 line 20: delta_opt = (B_opt - B_i)/N with the fewest retrains
    whose predicted total cost stays within (1 + beta) * C* — "proceeding
    faster to B_opt to reduce training cost" (§4).  Growing in one jump is
    cheapest but each intermediate retrain refines the estimates, so the
    beta slack lets the schedule keep at least the affordable granularity.
    If even the single cheapest jump violates the bound (stale C*), still
    jump — it is the cheapest path to B_opt."""
    gap = B_opt - current_B
    if gap <= 0:
        return 0
    fixed_human = (pool_size - machine_labeled) * service.price_per_label
    for N in range(1, max_N + 1):
        delta = int(np.ceil(gap / N))
        c = fixed_human + spent + cost_model.cost_to_grow(current_B, B_opt, delta)
        if c <= cstar * (1.0 + beta):
            return delta
    return gap  # N = 1: cheapest possible path to B_opt
