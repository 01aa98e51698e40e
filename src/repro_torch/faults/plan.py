"""Seeded, counter-keyed fault schedule + the thread-safe injector.

The contract that makes chaos runs replayable: whether invocation ``c``
of site ``s`` faults is a PURE function of ``(plan.seed, s, c)`` — the
same splitmix64 mix the annotator oracle draws votes with, so a chaos
campaign re-run under the same plan fires bit-identical faults.  No
global RNG state, no wall clock: the injector only keeps per-site
invocation counters.

Site vocabulary (the fault-site inventory):

  ``annotation.request``   one human-label batch request (pre-charge)
  ``worker.<name>``        one SerialWorker job (sweep/fit/annotation
                           brokers — ``pool-sweep``, ``fit-engine``, ...)
  ``trace.flush``          one trace-store buffer flush (torn write)
  ``campaign.iteration``   one MCAL iteration entry (kill point)

Counters are process-local and NOT persisted across resume: a resumed
campaign starts every site at 0 (documented — resume-under-chaos tests
hand the resumed leg a fresh plan).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Callable, Dict, FrozenSet, Optional, Tuple

from repro_torch.faults.errors import (AnnotationTimeout, InjectedKill,
                                 InjectedWorkerCrash,
                                 TransientAnnotationError)

_MASK = 0xFFFFFFFFFFFFFFFF

#: fault kinds -> what :meth:`FaultInjector.check` does when one fires
KINDS: FrozenSet[str] = frozenset({
    "latency",    # sleep ``duration`` (AnnotationTimeout past a deadline)
    "transient",  # raise TransientAnnotationError
    "timeout",    # raise AnnotationTimeout
    "crash",      # raise InjectedWorkerCrash
    "oserror",    # raise OSError (trace-write faults)
    "hang",       # sleep ``duration`` silently (straggler emulation)
    "kill",       # raise InjectedKill (BaseException: emulated preemption)
})


def hash01(seed: int, site: str, counter: int) -> float:
    """Uniform [0, 1) from (seed, site, counter) — splitmix64 finalizer
    over a crc32 site salt, the repo's counter-based draw convention
    (``AnnotatorPool._draws``)."""
    salt = zlib.crc32(site.encode("utf-8")) & 0xFFFFFFFF
    key = (seed * 1_000_003 + salt * 7919 + 0x51ED2701) & _MASK
    z = (key + counter * 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    z ^= z >> 31
    return (z >> 11) / float(1 << 53)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injectable fault at one site.

    Fires when the site's invocation counter is in ``at`` (an explicit
    schedule), or — with ``at`` unset — independently per invocation
    with probability ``rate`` (counter >= ``after``).  ``duration`` is
    the emulated latency/hang in seconds, scaled by the plan's
    ``time_scale`` (0 in tests: decisions without the waiting).
    """

    site: str
    kind: str
    rate: float = 0.0
    at: Optional[Tuple[int, ...]] = None
    after: int = 0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {sorted(KINDS)})")
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(a) for a in self.at))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of :class:`FaultRule`\\ s, grouped by site.

    :meth:`decide` is pure: rules with an explicit ``at`` schedule win
    first (in rule order), then rate rules share ONE uniform draw per
    invocation (cumulative-rate partition), so adding a rule never
    perturbs which invocations an earlier rule fires on only reweights
    the shared draw — and two runs under the same plan fault at exactly
    the same invocations.
    """

    seed: int = 0
    rules: Tuple[FaultRule, ...] = ()
    time_scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        by_site: Dict[str, Tuple[FaultRule, ...]] = {}
        for r in self.rules:
            by_site[r.site] = by_site.get(r.site, ()) + (r,)
        object.__setattr__(self, "_by_site", by_site)

    def decide(self, site: str, counter: int) -> Optional[FaultRule]:
        """The rule firing at invocation ``counter`` of ``site`` (None =
        no fault) — pure in (seed, site, counter)."""
        rules = self._by_site.get(site)
        if not rules:
            return None
        for r in rules:
            if r.at is not None and counter in r.at:
                return r
        u, acc = None, 0.0
        for r in rules:
            if r.at is not None or counter < r.after or r.rate <= 0.0:
                continue
            if u is None:
                u = hash01(self.seed, site, counter)
            acc += r.rate
            if u < acc:
                return r
        return None

    @classmethod
    def standard_transient(cls, seed: int = 0, *,
                           time_scale: float = 0.0) -> "FaultPlan":
        """The standard chaos mix benchmarks and ``--chaos`` use: flaky
        annotation backend (transient failures + latency spikes), one
        broker-job crash per engine family, one torn trace write.  No
        kill points — a killed CLI run would re-fire the kill on resume
        (counters restart); kills are exercised by the test harness."""
        return cls(seed=seed, time_scale=time_scale, rules=(
            FaultRule("annotation.request", "transient", rate=0.15),
            FaultRule("annotation.request", "latency", rate=0.10,
                      duration=0.05),
            FaultRule("worker.pool-sweep", "crash", at=(1,)),
            FaultRule("worker.fit-engine", "crash", at=(1,)),
            FaultRule("trace.flush", "oserror", at=(0,)),
        ))


class Fault:
    """One fired fault: ``(site, counter, rule)``."""

    __slots__ = ("site", "counter", "rule")

    def __init__(self, site: str, counter: int, rule: FaultRule):
        self.site, self.counter, self.rule = site, counter, rule

    def __repr__(self):
        return (f"Fault(site={self.site!r}, counter={self.counter}, "
                f"kind={self.rule.kind!r})")


class FaultInjector:
    """Thread-safe runtime face of a :class:`FaultPlan`.

    Every resilience seam calls :meth:`check` (or the lower-level
    :meth:`tick`) once per unit of work; with no plan attached both are
    near-free no-ops.  Fired faults ride the trace as ``fault_injected``
    observability events and bump the ``faults_injected_total`` counter
    when a trace/metrics surface is attached.
    """

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan()
        self.trace = None
        self.metrics = None
        self.fired = 0
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._sleep: Callable[[float], None] = time.sleep

    # -- wiring ---------------------------------------------------------
    def attach_trace(self, trace) -> None:
        """Emit ``fault_injected`` events into this store (observability
        kind: replay/diff ignore it, chaos runs stay diff-clean)."""
        self.trace = trace

    def attach_metrics(self, metrics) -> None:
        self.metrics = metrics

    # -- introspection --------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Per-site invocation counts seen so far (a copy)."""
        with self._lock:
            return dict(self._counters)

    # -- the injection seam ---------------------------------------------
    def tick(self, site: str, *, emit: bool = True) -> Optional[Fault]:
        """Advance ``site``'s invocation counter and return the fault
        firing at it, if any — WITHOUT acting on it.  ``emit=False``
        skips the trace event (required where the caller already holds
        the trace-store lock, e.g. inside ``TraceStore._flush_locked``)."""
        with self._lock:
            c = self._counters.get(site, 0)
            self._counters[site] = c + 1
        rule = self.plan.decide(site, c)
        if rule is None:
            return None
        self.fired += 1
        if emit and self.trace is not None:
            self.trace.emit("fault_injected", site=site, counter=int(c),
                            fault=rule.kind)
        if self.metrics is not None:
            self.metrics.inc("faults_injected_total", site=site,
                             kind=rule.kind)
        return Fault(site, c, rule)

    def check(self, site: str, *, timeout: Optional[float] = None,
              emit: bool = True) -> Optional[Fault]:
        """One unit of work at ``site``: sleep through latency/hang
        faults (scaled by the plan's ``time_scale``) and raise the
        mapped exception for failure faults.  ``timeout`` is the
        caller's per-request deadline — an injected latency above it
        becomes an :class:`AnnotationTimeout` instead of a sleep."""
        fault = self.tick(site, emit=emit)
        if fault is None:
            return None
        r, c = fault.rule, fault.counter
        where = f"{site}#{c}"
        if r.kind == "latency":
            if timeout is not None and r.duration > timeout:
                self._sleep(timeout * self.plan.time_scale)
                raise AnnotationTimeout(
                    f"injected latency {r.duration:g}s blew the "
                    f"{timeout:g}s request deadline at {where}")
            self._sleep(r.duration * self.plan.time_scale)
            return fault
        if r.kind == "hang":
            self._sleep(r.duration * self.plan.time_scale)
            return fault
        if r.kind == "transient":
            raise TransientAnnotationError(f"injected transient failure "
                                           f"at {where}")
        if r.kind == "timeout":
            raise AnnotationTimeout(f"injected request timeout at {where}")
        if r.kind == "crash":
            raise InjectedWorkerCrash(f"injected job crash at {where}")
        if r.kind == "oserror":
            raise OSError(f"injected IO fault at {where}")
        assert r.kind == "kill"
        raise InjectedKill(f"injected kill point at {where}")
