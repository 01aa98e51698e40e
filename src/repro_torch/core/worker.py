"""The engine broker thread (``repro.core.worker``): one daemon serial
worker per runtime.

``PoolSweepRunner.submit`` and ``FitEngine.submit_fit``/``submit_call``
broker jobs onto a single worker thread and hand back a
:class:`~repro_torch.serving.sweep.SweepFuture`.

* The thread is a **daemon** and starts lazily at the first ``submit``: an
  engine that never goes async never pays for a thread, and an abandoned
  in-flight job cannot hang interpreter shutdown.
* ``submit`` returns a ``concurrent.futures.Future`` (cancelling a queued
  job works through ``Future.set_running_or_notify_cancel``); a job that
  raises delivers its exception at ``result()`` and the loop keeps
  draining.
* ``close()`` is idempotent: it lets the queued jobs finish, joins the
  thread and returns whether it joined within ``timeout`` (a stuck job
  warns and leaks its daemon thread); ``submit`` afterwards raises
  :class:`WorkerClosed`.
* with a ``RetryPolicy``/``FaultInjector`` attached (``attach_faults``)
  every job ticks the ``worker.<name>`` fault site before it runs, and a
  transiently crashed job is re-dispatched in place — the resilience seam
  ``repro_torch.faults`` exercises with injected
  :class:`~repro_torch.faults.errors.InjectedWorkerCrash` faults.

A worker built with a CUDA ``device`` makes it current when its thread
starts, so its jobs launch on that device's default stream — the stream
the main thread uses too, which orders a job's kernels after the work
queued before it was submitted.
"""
from __future__ import annotations

import queue
import threading
import warnings
from concurrent.futures import Future
from typing import Optional

import torch


class WorkerClosed(RuntimeError):
    """``submit`` after ``close()`` — the broker thread is gone."""


class SerialWorker:
    """One daemon thread draining a FIFO job queue into Futures, named so
    thread dumps attribute stuck jobs to their engine."""

    def __init__(self, name: str = "serial-worker", device=None, *,
                 retry=None, faults=None):
        self._name = name
        self._index = None          # the CUDA device its thread makes current
        if device is not None and torch.device(device).type == "cuda":
            index = torch.device(device).index
            self._index = torch.cuda.current_device() if index is None \
                else index
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._lock = threading.Lock()
        self.retry = retry            # faults.RetryPolicy: re-dispatch
        self.faults = faults          # faults.FaultInjector: chaos seam
        self.metrics = None           # obs registry for retries_total
        self.redispatches = 0         # transient job crashes survived

    # -- resilience wiring ---------------------------------------------------
    @property
    def fault_site(self) -> str:
        """This worker's fault-plan site key (``worker.<name>``)."""
        return f"worker.{self._name}"

    def attach_faults(self, faults, retry=None) -> None:
        """Wire the chaos seam: every job ticks ``worker.<name>`` before
        running (an injected crash raises into the job), and with a
        retry policy transiently-crashed jobs are re-dispatched."""
        self.faults = faults
        if retry is not None:
            self.retry = retry

    # -- the executor surface ----------------------------------------------
    def submit(self, fn, *args, **kw) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise WorkerClosed(
                    f"{self._name}: submit after close() — the broker "
                    f"thread has been joined")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name=self._name, daemon=True)
                self._thread.start()
            self._q.put((fut, fn, args, kw))
        return fut

    def _loop(self):
        if self._index is not None:
            torch.cuda.set_device(self._index)
        while True:
            item = self._q.get()
            if item is None:          # the close() sentinel
                return
            fut, fn, args, kw = item
            if not fut.set_running_or_notify_cancel():
                continue              # cancelled while queued
            try:
                if self.retry is not None:
                    result = self.retry.call(
                        lambda: self._run_job(fn, args, kw),
                        site=self.fault_site, notify=self._notify_retry)
                else:
                    result = self._run_job(fn, args, kw)
                fut.set_result(result)
            except BaseException as e:   # delivered at result()
                fut.set_exception(e)

    def _run_job(self, fn, args, kw):
        """One dispatch of a job through the fault seam; re-dispatched
        as a whole by the retry policy on a transient crash."""
        if self.faults is not None:
            self.faults.check(self.fault_site)
        return fn(*args, **kw)

    def _notify_retry(self, attempt: int, exc: BaseException,
                      delay: float) -> None:
        self.redispatches += 1
        if self.metrics is not None:
            self.metrics.inc("retries_total", site=self.fault_site)

    @property
    def alive(self) -> bool:
        """True while the worker thread exists and has not been joined."""
        return self._thread is not None and self._thread.is_alive()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Finish the queued jobs and join the thread (a no-op beyond the
        closed flag for a worker that never started).  True when the
        thread is gone; False, with a warning, when it did not join within
        ``timeout`` (a stuck job: the daemon flag keeps it from hanging
        interpreter exit)."""
        with self._lock:
            already = self._closed
            self._closed = True
            thread = self._thread
            if thread is not None and not already:
                self._q.put(None)
        if thread is None:
            return True
        if not already:
            thread.join(timeout)
        if thread.is_alive():
            warnings.warn(
                f"{self._name}: broker thread failed to join within "
                f"{timeout!r}s and leaked (stuck job?)",
                RuntimeWarning, stacklevel=2)
            return False
        return True

    def __enter__(self) -> "SerialWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
