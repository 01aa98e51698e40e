"""Exception vocabulary of the fault-injection / resilience layer.

Two families, split by how the runtime is allowed to react:

* :class:`TransientError` subclasses are RETRYABLE — a bounded-backoff
  re-issue (``faults.retry.RetryPolicy``) or a worker re-dispatch is
  expected to clear them.  They model the lossy-service failure surface:
  an annotation backend timing out, a flaky RPC, a preempted broker job.
* :class:`FaultError` subclasses are TERMINAL for the failing unit of
  work — retries were exhausted or a wall budget blew.  The fleet layer
  reacts by quarantining the tenant instead of nuking the round.

:class:`InjectedKill` deliberately derives from ``BaseException`` so the
mid-iteration kill point is NOT swallowed by ``except Exception`` paths
— it emulates a SIGKILL/preemption and must unwind all the way to the
launcher's crash-safe autosave handler.
"""
from __future__ import annotations


class TransientError(RuntimeError):
    """Base of retryable faults: a bounded re-issue should clear it."""


class TransientAnnotationError(TransientError):
    """The annotation backend dropped/garbled one request (flaky RPC)."""


class AnnotationTimeout(TransientError):
    """One annotation request exceeded its per-request deadline."""


class InjectedWorkerCrash(TransientError):
    """A :class:`~repro_torch.core.worker.SerialWorker` job died mid-flight
    (emulated preemption) — the re-dispatch path re-runs the job."""


class FaultError(RuntimeError):
    """Base of terminal resilience failures (retries exhausted, wall
    budget blown).  The orchestrator maps these to tenant quarantine."""


class RetryExhausted(FaultError):
    """Every attempt of a :class:`~repro_torch.faults.retry.RetryPolicy` loop
    failed; ``__cause__`` chains the last transient error."""


class StragglerTimeout(FaultError):
    """An async sweep/fit/annotation job was still running when its
    configured wall budget expired (``SweepFuture.result(timeout)``)."""


class InjectedKill(BaseException):
    """Mid-iteration kill point: emulates preemption of the whole
    process.  BaseException on purpose — only the launcher's autosave
    handler (and test harnesses) may catch it."""
