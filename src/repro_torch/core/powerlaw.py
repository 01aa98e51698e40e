"""Truncated power-law error model (paper Eqn. 3).

    eps(n) = alpha * n^(-gamma) * exp(-n / k)

The family is log-linear — ``log eps = c0 - c1*log n - c2*n`` with
``alpha = e^c0, gamma = c1, 1/k = c2`` — so the fit is a tiny (weighted)
linear least-squares with the sign constraints ``gamma >= 0, 1/k >= 0``
enforced by active-set clamping.  Cheap enough to refit every MCAL
iteration for every theta.  A plain power law (``k = inf``) is the Fig. 2
baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

EPS_FLOOR = 1e-6


@dataclasses.dataclass(frozen=True)
class PowerLaw:
    alpha: float
    gamma: float
    k: float = np.inf          # truncation scale; inf -> plain power law
    resid_std: float = 0.0     # residual std in log space (fit quality)
    n_points: int = 0

    def predict(self, n) -> np.ndarray:
        n = np.maximum(np.asarray(n, np.float64), 1.0)
        out = self.alpha * n ** (-self.gamma)
        if np.isfinite(self.k):
            out = out * np.exp(-n / self.k)
        return out

    def __call__(self, n):
        return self.predict(n)


def _solve(X: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    sw = np.sqrt(w)
    coef, *_ = np.linalg.lstsq(X * sw[:, None], y * sw, rcond=None)
    return coef


def fit_power_law(
    sizes: Sequence[float],
    errors: Sequence[float],
    *,
    truncated: bool = True,
    weights: Optional[Sequence[float]] = None,
) -> PowerLaw:
    """Fit eps(n); clamps eps to a floor so perfect iterations stay finite.

    With fewer than 3 (truncated) / 2 (plain) points the fit degrades
    gracefully (constant, then pinned-slope).
    """
    n = np.asarray(sizes, np.float64)
    e = np.maximum(np.asarray(errors, np.float64), EPS_FLOOR)
    assert n.shape == e.shape and n.ndim == 1
    w = np.ones_like(n) if weights is None else np.asarray(weights, np.float64)
    y = np.log(e)
    ln = np.log(n)

    if len(n) == 1:
        return PowerLaw(alpha=float(e[0]), gamma=0.0, n_points=1)
    if len(n) == 2 or not truncated:
        X = np.stack([np.ones_like(ln), -ln], axis=1)
        c = _solve(X, y, w)
        gamma = max(c[1], 0.0)
        if gamma != c[1]:  # re-fit intercept only
            c0 = np.average(y, weights=w)
            c = np.array([c0, 0.0])
        resid = y - X @ np.array([c[0], gamma])
        return PowerLaw(alpha=float(np.exp(c[0])), gamma=float(gamma),
                        resid_std=float(np.std(resid)), n_points=len(n))

    # full 3-parameter truncated fit
    X = np.stack([np.ones_like(ln), -ln, -n], axis=1)
    c = _solve(X, y, w)
    gamma, inv_k = c[1], c[2]
    if gamma < 0 and inv_k < 0:
        c0 = np.average(y, weights=w)
        gamma, inv_k, c = 0.0, 0.0, np.array([c0, 0.0, 0.0])
    elif gamma < 0:      # drop the power term, keep exponential falloff
        X2 = np.stack([np.ones_like(ln), -n], axis=1)
        c2 = _solve(X2, y, w)
        gamma, inv_k = 0.0, max(c2[1], 0.0)
        c = np.array([c2[0], 0.0, inv_k])
    elif inv_k < 0:      # plain power law
        X2 = np.stack([np.ones_like(ln), -ln], axis=1)
        c2 = _solve(X2, y, w)
        gamma, inv_k = max(c2[1], 0.0), 0.0
        c = np.array([c2[0], gamma, 0.0])
    resid = y - (c[0] - gamma * ln - inv_k * n)
    k = 1.0 / inv_k if inv_k > 0 else np.inf
    return PowerLaw(alpha=float(np.exp(c[0])), gamma=float(gamma), k=float(k),
                    resid_std=float(np.std(resid)), n_points=len(n))


def required_size(law: PowerLaw, target_eps: float,
                  n_max: float = 1e9) -> float:
    """Smallest n with law(n) <= target_eps (inf if unreachable by n_max).

    Monotone-decreasing family -> bisection.
    """
    if law.predict(1.0) <= target_eps:
        return 1.0
    if law.predict(n_max) > target_eps:
        return np.inf
    lo, hi = 1.0, float(n_max)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if law.predict(mid) <= target_eps:
            hi = mid
        else:
            lo = mid
    return hi
