"""Learning-rate schedules (``repro.training.schedules``): ``constant``,
the schedule live labeling campaigns train with (one step program serves
every |B|).  The reference's ``cosine`` and ``paper_steps`` are not ported.

The step is a host integer, so a schedule is a plain function
``step -> lr`` (a python float, rounded to fp32 like the reference's).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.configs.base import TrainConfig


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    if tc.schedule != "constant":
        raise ValueError(f"schedule {tc.schedule!r} is not ported")
    base = tc.learning_rate

    def fn(step):
        scale = (1.0 if tc.warmup_steps <= 0
                 else min((step + 1) / tc.warmup_steps, 1.0))
        return float(np.float32(base * scale))
    return fn
