"""Straggler detection (``repro.distributed.straggler``): step-time outlier
detection + mitigation hooks.

The monitor keeps a rolling window of measured step times, flags outliers
by median + k*MAD (robust to the warmup tail), and invokes a mitigation
callback; in tests it records the event.  Detection is on the host: it
reads wall-clock timings of steps whose loss the trainer has already read
back (so each time spans the step's device work), and adds no device work.
A copy of the reference's framework-free module.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float
    threshold: float


class StragglerMonitor:
    def __init__(self, window: int = 64, k_mad: float = 5.0,
                 min_samples: int = 16,
                 on_straggler: Optional[Callable[[StragglerEvent],
                                                 None]] = None):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.k_mad = k_mad
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step = 0

    # -- timing context ------------------------------------------------------
    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "start() before stop()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, duration: float) -> Optional[StragglerEvent]:
        self._step += 1
        event = None
        if len(self.window) >= self.min_samples:
            med = _median(self.window)
            mad = _median([abs(x - med) for x in self.window]) or 1e-9
            thresh = med + self.k_mad * mad
            if duration > thresh:
                event = StragglerEvent(self._step, duration, med, thresh)
                self.events.append(event)
                if self.on_straggler:
                    self.on_straggler(event)
        self.window.append(duration)
        return event


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
