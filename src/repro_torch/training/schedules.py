"""Learning-rate schedules (``repro.training.schedules``).

``paper_steps`` reproduces the paper's recipe (§5): 200 epochs with 10x LR
reductions at epochs 80/120/160/180, expressed as fractions of
``total_steps`` (0.4 / 0.6 / 0.8 / 0.9) so it applies at any step budget;
``cosine`` decays to 10% of the peak; ``constant`` is what live labeling
campaigns train with (one step program serves every |B|).

The step is a host integer, so a schedule is a plain function
``step -> lr`` (a python float), computed in fp32 numpy scalars in the
reference's order of operations: ``constant`` and ``paper_steps`` give the
fp32 values of the reference's jitted schedule exactly (its train step's),
``cosine`` to within 6e-7 relative (XLA's cos).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.configs.base import TrainConfig

PAPER_BOUNDARIES = (0.4, 0.6, 0.8, 0.9)  # epochs 80/120/160/180 of 200
PAPER_DECAY = 0.1

_F = np.float32


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    base = _F(tc.learning_rate)
    total = max(tc.total_steps, 1)

    def warmup_scale(step):
        if tc.warmup_steps <= 0:
            return _F(1.0)
        return np.minimum(_F(step + 1) / _F(tc.warmup_steps), _F(1.0))

    if tc.schedule == "constant":
        def lr(step):
            return base
    elif tc.schedule == "cosine":
        def lr(step):
            frac = np.clip(_F(step) / _F(total), _F(0.0), _F(1.0))
            # XLA's fp32 cos and its fused code round their own way: the
            # float64 cos rounded to fp32 keeps within 6e-7 of them
            cos = _F(0.5) * (_F(1.0) + _F(np.cos(np.float64(
                _F(np.pi) * frac))))
            return base * (_F(0.1) + _F(0.9) * cos)   # 10% of peak at the end
    elif tc.schedule == "paper_steps":
        bounds = np.asarray([b * total for b in PAPER_BOUNDARIES], _F)

        def lr(step):
            k = int(np.sum(_F(step) >= bounds))
            return base * _F(PAPER_DECAY) ** _F(k)
    else:
        raise ValueError(f"unknown schedule {tc.schedule!r}")

    def fn(step: int) -> float:
        return float(_F(lr(step)) * warmup_scale(step))
    return fn
