"""Bounded-backoff retry with seeded deterministic jitter.

A :class:`RetryPolicy` re-issues a unit of work after a
:class:`~repro_torch.faults.errors.TransientError` with exponential backoff;
the jitter is NOT drawn from a global RNG but hashed from
``(policy.seed, site, invocation, attempt)`` — the same convention the
fault plan fires on — so a chaos run's retry delays (and therefore its
emitted ``retry`` events) replay bit-identically.

The policy never makes a request idempotent by itself: it is only safe
around operations that are transactional per attempt.  The annotation
service qualifies twice over — votes are counter-free hashes of
(pool seed, worker, item), so a re-issued request yields the identical
vote matrix, and the budget check precedes every charge, so a failed
attempt charges nothing (see ``AnnotationService._annotate_impl``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional, TypeVar

from repro_torch.faults.errors import RetryExhausted, TransientError
from repro_torch.faults.plan import hash01

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: up to ``max_attempts`` tries,
    delay ``min(base_delay * multiplier**attempt, max_delay)`` scaled by
    a deterministic jitter in ``[1 - jitter/2, 1 + jitter/2)``.

    ``timeout`` is the per-request deadline handed down to fault checks
    (an injected latency above it turns into a retryable
    ``AnnotationTimeout``).  ``sleep_scale`` scales the actual sleeps —
    0 in tests keeps the decision/emission stream while skipping the
    waiting (delays are still computed and reported deterministically).
    """

    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5
    timeout: Optional[float] = None
    seed: int = 0
    sleep_scale: float = 1.0
    _calls: "itertools.count" = dataclasses.field(
        default_factory=itertools.count, repr=False, compare=False)

    def backoff(self, site: str, invocation: int, attempt: int) -> float:
        """The delay before re-attempt ``attempt + 1`` — pure in
        (seed, site, invocation, attempt)."""
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if self.jitter > 0.0:
            u = hash01(self.seed, f"retry.{site}",
                       invocation * 64 + attempt)
            d *= 1.0 + self.jitter * (u - 0.5)
        return d

    def call(self, fn: Callable[[], T], *, site: str = "request",
             notify: Optional[Callable[[int, BaseException, float],
                                       None]] = None) -> T:
        """Run ``fn`` under the policy.  Only
        :class:`~repro_torch.faults.errors.TransientError` is retried —
        anything else (``BudgetExceeded``, programming errors, kill
        points) propagates from the first attempt untouched.  ``notify``
        observes each retry as ``(attempt, exc, delay)`` (the seam the
        service's ``retry`` trace events / ``retries_total`` counter
        hang off).  Raises :class:`RetryExhausted` chaining the last
        transient error once attempts run out.
        """
        invocation = next(self._calls)
        last: Optional[TransientError] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except TransientError as e:
                last = e
                if attempt + 1 >= max(1, self.max_attempts):
                    break
                delay = self.backoff(site, invocation, attempt)
                if notify is not None:
                    notify(attempt, e, delay)
                if self.sleep_scale > 0.0:
                    time.sleep(delay * self.sleep_scale)
        raise RetryExhausted(
            f"{site}: {max(1, self.max_attempts)} attempts exhausted "
            f"(last: {type(last).__name__}: {last})") from last
