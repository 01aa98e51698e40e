"""Deterministic fault injection + the resilience vocabulary
(``repro.faults``, the port's own copy).

``FaultPlan`` schedules faults as pure functions of (seed, site,
invocation counter); ``FaultInjector`` is its thread-safe runtime face;
``RetryPolicy`` re-issues transient failures with seeded deterministic
jitter.  The package is a leaf: stdlib-only, imported by core/, trace/,
serving/, training/ and launch/ without cycles.  ``faults.plan`` lists
the fault sites.
"""
from repro_torch.faults.errors import (AnnotationTimeout, FaultError,
                                 InjectedKill, InjectedWorkerCrash,
                                 RetryExhausted, StragglerTimeout,
                                 TransientAnnotationError, TransientError)
from repro_torch.faults.plan import (KINDS, Fault, FaultInjector, FaultPlan,
                               FaultRule, hash01)
from repro_torch.faults.retry import RetryPolicy

__all__ = [
    "AnnotationTimeout", "Fault", "FaultError", "FaultInjector",
    "FaultPlan", "FaultRule", "InjectedKill", "InjectedWorkerCrash",
    "KINDS", "RetryExhausted", "RetryPolicy", "StragglerTimeout",
    "TransientAnnotationError", "TransientError", "hash01",
]
