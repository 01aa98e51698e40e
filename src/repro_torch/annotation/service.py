"""The annotation-service runtime: request broker + budget ledger
(``repro.annotation.service``).

One :class:`AnnotationService` is one annotation campaign endpoint: a
seeded noisy :class:`~repro_torch.annotation.oracle.AnnotatorPool`, a
:class:`RepeatPolicy` (how many votes per item, whether to top up
adaptively), the device-resident
:class:`~repro_torch.annotation.aggregate.VoteAggregator`, and pricing —
every request round is charged per VOTE at the configured
:class:`~repro_torch.core.cost.LabelingService` tier rates into the
service's own :class:`~repro_torch.core.cost.CostLedger` (the budget
ledger; an optional hard ``budget`` refuses requests that would break it).

Request flow per batch (``annotate``):

1. rounds ``0 .. repeats-1`` ask one worker per item each (workers are
   assigned round-robin from the deterministic request cursor, so no item
   sees the same worker twice and the schedule replays identically after
   a resume);
2. with ``adaptive``, the votes are aggregated after the base rounds and
   only items whose aggregated posterior confidence has NOT cleared
   ``confidence`` get another vote, round by round up to ``max_repeats``;
3. the final vote matrix aggregates (majority or Dawid-Skene EM, on the
   device) into the labels handed back; per-worker agreement statistics
   and the latest EM confusion estimates are folded into the service
   state (persisted in campaign state files).

``submit`` runs a batch on the service's worker thread
(``core.worker.SerialWorker``) and returns the sweep runtime's
:class:`~repro_torch.serving.sweep.SweepFuture`; callers synchronize at
``result()``.

MCAL integration: tasks carry ``task.annotation = service`` and route
``human_label`` through :meth:`annotate`; ``SharedPool.buy_labels`` reads
the per-call vote count (:attr:`votes_bought` delta) and charges the
campaign ledger repeats-inclusive through ``pay_human``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.annotation.aggregate import AggregateConfig, VoteAggregator
from repro_torch.annotation.oracle import AnnotatorPool
from repro_torch.core.cost import CostLedger, LabelQuality, LabelingService
from repro_torch.core.worker import SerialWorker
# the sweep runtime's async handle, shared rather than mirrored (the same
# convention FitEngine follows) so worker-handle hardening lands once
from repro_torch.serving.sweep import SweepFuture as AnnotationFuture

AGGREGATORS = ("majority", "ds")


class BudgetExceeded(RuntimeError):
    """A request round would push the service ledger past its budget."""


@dataclasses.dataclass(frozen=True)
class RepeatPolicy:
    """Repeated-labeling policy: ``repeats`` votes per item up front;
    with ``adaptive``, items below ``confidence`` aggregated-posterior
    confidence keep receiving votes up to ``max_repeats``."""

    repeats: int = 1
    max_repeats: Optional[int] = None      # None -> repeats (no top-up)
    adaptive: bool = False
    confidence: float = 0.9
    aggregator: str = "majority"           # majority | ds

    def __post_init__(self):
        assert self.repeats >= 1
        assert self.aggregator in AGGREGATORS
        if self.max_repeats is not None:
            assert self.max_repeats >= self.repeats
        if self.adaptive:
            # a silent-no-op guard, not a nicety: with cap == repeats the
            # top-up loop is empty by construction, and a single-vote
            # majority's confidence is identically 1.0 so no row would
            # ever be selected — the flags would promise quality-driven
            # top-ups and deliver none
            assert self.cap > self.repeats, \
                "adaptive repeats needs max_repeats > repeats " \
                "(no room to top up)"
            assert self.repeats >= 2 or self.aggregator == "ds", \
                "adaptive majority needs repeats >= 2: a single-vote " \
                "majority is always 100% confident, so no item would " \
                "ever be topped up (use aggregator='ds' for " \
                "single-vote adaptivity)"

    @property
    def cap(self) -> int:
        return self.max_repeats if self.max_repeats is not None \
            else self.repeats


class AnnotationService:
    """One annotation endpoint: noisy worker pool + aggregation policy +
    per-vote pricing.  See the module docstring for the request flow."""

    def __init__(self, pool: AnnotatorPool,
                 policy: RepeatPolicy = RepeatPolicy(),
                 pricing: LabelingService = LabelingService("annotation",
                                                            0.04),
                 budget: Optional[float] = None,
                 agg_cfg: AggregateConfig = AggregateConfig(),
                 device="cuda"):
        assert policy.cap <= pool.n_workers, \
            "max_repeats cannot exceed the worker pool (one vote each)"
        self.pool = pool
        self.policy = policy
        self.pricing = pricing
        self.budget = budget
        self.device = device
        self.aggregator = VoteAggregator(pool.cfg.num_classes, agg_cfg,
                                         device=device)
        self.ledger = CostLedger()             # the service budget ledger
        self.trace = None                      # campaign event bus (attach_trace)
        self.metrics = None                    # runtime metrics (attach_metrics)
        self.faults = None                     # chaos injector (attach_faults)
        self.retry = None                      # faults.RetryPolicy: re-issue
        #                                        transiently-failed batches
        # -- persisted runtime state (state_dict) --------------------------
        self._cursor = 0                       # request-batch counter: the
        #                                        worker-schedule offset
        W = pool.n_workers
        self._agree = np.zeros(W, np.int64)    # votes == aggregated label
        self._count = np.zeros(W, np.int64)    # votes cast, per worker
        self._conf_sum = 0.0                   # sum of per-item aggregated
        self._conf_n = 0                       # confidence (residual est.)
        self._confusion_est: Optional[np.ndarray] = None  # last EM (W,C,C)
        self._exec: Optional[SerialWorker] = None
        # one batch at a time: direct annotate() calls and brokered
        # submit() batches serialize here, so the cursor advance, the
        # ledger's read-modify-writes, and the worker statistics can
        # never interleave.  A service shared by several campaigns hands
        # each one an :class:`AnnotationSession` (per-tenant cursor +
        # vote accounting); attaching the bare service to two campaigns
        # remains unsupported, because the votes-bought delta
        # ``SharedPool.buy_labels`` reads would see the other buyer's
        # requests.
        self._lock = threading.Lock()

    def attach_trace(self, trace) -> None:
        """Wire the campaign event bus through the broker: every service-
        ledger charge emits (as ledger="service", distinct from the
        campaign ledger's stream), and each request batch emits its vote
        rounds, adaptive top-ups, and an annotator-quality snapshot."""
        self.trace = trace
        self.ledger.trace = trace
        self.ledger.trace_name = "service"

    def attach_metrics(self, metrics) -> None:
        """Wire the runtime metrics registry (repro_torch.obs) through the
        request path: per-batch spans, EM/top-up round counters, and the
        broker queue depth/wait telemetry.  None (the default) keeps
        every instrumented site a free no-op."""
        self.metrics = metrics
        self.aggregator.metrics = metrics

    def attach_faults(self, faults, retry=None) -> None:
        """Wire the chaos/resilience seam: every request batch ticks the
        ``annotation.request`` fault site BEFORE any charge or cursor
        advance, and with a :class:`~repro_torch.faults.RetryPolicy` attached
        transiently-failed batches are re-issued (safe: votes are
        counter-free hashes of (pool seed, worker, item), so a re-issued
        request yields the identical vote matrix, and a failed attempt
        charges nothing — retries charge exactly once)."""
        self.faults = faults
        if retry is not None:
            self.retry = retry

    def _emit(self, kind: str, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **payload)

    # -- introspection -----------------------------------------------------
    @property
    def votes_bought(self) -> int:
        """Priced annotation requests so far (the campaign charging hook:
        ``SharedPool.buy_labels`` charges the delta across one call)."""
        return self.ledger.human_votes

    @property
    def request_cursor(self) -> int:
        return self._cursor

    def avg_repeats(self) -> float:
        """Measured votes per purchased label (policy.repeats before any
        purchase)."""
        if self.ledger.human_labels == 0:
            return float(self.policy.repeats)
        return self.ledger.human_votes / self.ledger.human_labels

    def worker_accuracy(self) -> np.ndarray:
        """Per-worker empirical agreement with the aggregated labels —
        the online annotator-quality estimate (1.0 for unseen workers)."""
        with np.errstate(invalid="ignore"):
            acc = self._agree / np.maximum(self._count, 1)
        return np.where(self._count > 0, acc, 1.0)

    def confusion_estimate(self) -> Optional[np.ndarray]:
        """Latest Dawid-Skene per-worker confusion estimate (None until a
        ``ds``-aggregated batch has run)."""
        return None if self._confusion_est is None \
            else self._confusion_est.copy()

    def estimated_residual_error(self) -> float:
        """Running estimate of the aggregated-label error: one minus the
        mean aggregated-posterior confidence of the chosen labels (the
        standard posterior-risk proxy); falls back to the pool's analytic
        majority error before any batch has run."""
        if self._conf_n == 0:
            return self.pool.expected_majority_error(self.policy.repeats)
        return max(1.0 - self._conf_sum / self._conf_n, 0.0)

    def expected_quality(self) -> LabelQuality:
        """The :class:`LabelQuality` a campaign should fold into its
        accuracy target and joint search — analytic (from the pool's true
        confusion matrices + the policy), so it is deterministic at
        campaign-config time.  Pessimistic for ``ds``/adaptive policies
        (it models a plain ``repeats``-vote majority); :meth:`calibrate`
        measures the real thing."""
        return LabelQuality(
            residual_error=self.pool.expected_majority_error(
                self.policy.repeats),
            avg_repeats=float(self.policy.repeats))

    def calibrate(self, n: int = 2048) -> LabelQuality:
        """MEASURED label quality: run the full policy + aggregation
        machinery over a seeded synthetic calibration batch with known
        ground truth and report the observed residual error and votes per
        label.  Deterministic per (pool seed, policy, n) — a resumed
        campaign reconstructs the identical quality config — and charge-
        free: the batch runs on a cloned pool (disjoint Philox streams,
        so calibration never reuses the randomness of real requests) and
        a throwaway service, leaving this service's cursor, ledger, and
        statistics untouched.  Unlike :meth:`expected_quality` this sees
        what Dawid-Skene and adaptive top-ups actually buy (spammers
        down-weighted, hard items topped up)."""
        cfg = self.pool.cfg
        # the SAME worker population (profiles + confusion matrices), on
        # vote-randomness streams salted away from every real request —
        # reseeding the pool itself would resample the per-worker noise
        # jitter and measure a different crowd than the one answering
        clone = AnnotationService(
            AnnotatorPool(cfg, draw_salt=0x5CA1AB1E),
            self.policy, pricing=self.pricing,
            agg_cfg=self.aggregator.cfg, device=self.device)
        rng = np.random.default_rng(cfg.seed)
        gt = rng.integers(0, cfg.num_classes, n)
        labels = clone.annotate(np.arange(n), gt)
        return LabelQuality(residual_error=float(np.mean(labels != gt)),
                            avg_repeats=clone.avg_repeats())

    # -- the request path --------------------------------------------------
    def _within_budget(self, n_votes: int) -> bool:
        if self.budget is None:
            return True
        due = self.pricing.cost(n_votes, start=self.ledger.human_votes)
        return self.ledger.human + due <= self.budget + 1e-12

    def _topup_round(self, votes: np.ndarray, rows: np.ndarray,
                     idx: np.ndarray, true: np.ndarray, base: int, r: int):
        """One adaptive top-up round over the still-unsure ``rows``:
        worker ``(base + row + r) % W`` answers each — the continuation
        of ``AnnotatorPool.vote_matrix``'s schedule at round ``r``."""
        W = self.pool.n_workers
        w_of = (base + rows + r) % W
        for w in np.unique(w_of):
            sub = rows[w_of == w]
            votes[sub, w] = self.pool.annotate(idx[sub], true[sub], int(w))

    def annotate(self, idx: np.ndarray, true_labels: np.ndarray
                 ) -> np.ndarray:
        """Answer one label-request batch: collect votes per the policy,
        charge the ledger per vote round, return the aggregated labels
        (row-aligned with ``idx``).  Batches serialize on the service
        lock — a direct call and a brokered one can never interleave.

        Budget semantics are transactional: the mandatory base rounds
        (``N * repeats`` votes) are affordability-checked UP FRONT —
        :class:`BudgetExceeded` is raised before anything is charged,
        counted, or cursor-advanced, so a refused batch leaves no
        phantom state and a retried one replays identically.  Adaptive
        top-up rounds are best-effort within the remaining budget: an
        unaffordable round just stops the topping-up."""
        labels, _votes = self.annotate_counted(idx, true_labels)
        return labels

    def annotate_counted(self, idx: np.ndarray, true_labels: np.ndarray
                         ) -> Tuple[np.ndarray, int]:
        """:meth:`annotate` plus the EXACT priced vote count this call
        consumed, measured inside the lock — the per-call accounting the
        votes-bought delta protocol approximates from outside it."""
        idx = np.asarray(idx, np.int64)
        true = np.asarray(true_labels, np.int64)

        def attempt():
            # read-modify-write of the cursor stays atomic per attempt:
            # a failed attempt (the fault fires pre-mutation) leaves
            # cursor, ledger, and statistics untouched, so the retry
            # replays the identical worker schedule and charges once
            with self._lock:
                out = self._annotate_locked(idx, true, self._cursor,
                                            self.policy)
                self._cursor = out[2]
                return out

        labels, votes, _ = self._run_request(attempt)
        return labels, votes

    def _run_request(self, attempt, *, retry=None, trace=None):
        """One request batch through the resilience layer: run
        ``attempt`` under the retry policy (session override first,
        service default second, none = a single bare attempt).  Each
        re-issue emits a ``retry`` observability event and bumps
        ``retries_total``; exhaustion raises
        :class:`~repro_torch.faults.RetryExhausted` (terminal — the fleet
        layer quarantines)."""
        retry = retry if retry is not None else self.retry
        if retry is None:
            return attempt()
        emitter = trace if trace is not None else self.trace

        def notify(attempt_no, exc, delay):
            if emitter is not None:
                emitter.emit("retry", site="annotation.request",
                             attempt=int(attempt_no),
                             error=type(exc).__name__, delay=float(delay))
            if self.metrics is not None:
                self.metrics.inc("retries_total", site="annotation.request")

        return retry.call(attempt, site="annotation.request", notify=notify)

    def _annotate_locked(self, idx: np.ndarray, true: np.ndarray,
                         cursor: int, pol: RepeatPolicy,
                         faults=None, timeout: Optional[float] = None
                         ) -> Tuple[np.ndarray, int, int]:
        faults = faults if faults is not None else self.faults
        if faults is not None:
            # the injection seam sits BEFORE the metrics span and before
            # any mutation: a fault here models the request never
            # reaching the backend — nothing was charged or counted
            if timeout is None and self.retry is not None:
                timeout = self.retry.timeout
            faults.check("annotation.request", timeout=timeout)
        if self.metrics is None:
            return self._annotate_impl(idx, true, cursor, pol)
        with self.metrics.span("annotate"):
            return self._annotate_impl(idx, true, cursor, pol)

    def _aggregate(self, resident, pol: RepeatPolicy):
        """One device aggregation round (majority or Dawid-Skene EM),
        timed when metrics are attached."""
        if self.metrics is None:
            return self.aggregator.aggregate_resident(resident,
                                                      pol.aggregator)
        t0 = time.perf_counter()
        out = self.aggregator.aggregate_resident(resident, pol.aggregator)
        self.metrics.observe("annotation_agg_seconds",
                             time.perf_counter() - t0,
                             aggregator=pol.aggregator)
        self.metrics.inc("annotation_agg_rounds_total",
                         aggregator=pol.aggregator)
        return out

    def _annotate_impl(self, idx: np.ndarray, true: np.ndarray,
                       cursor: int, pol: RepeatPolicy
                       ) -> Tuple[np.ndarray, int, int]:
        """One request batch under the lock: ``(labels, votes_spent,
        next_cursor)``.  The cursor is threaded through (not read off
        ``self``) so per-tenant :class:`AnnotationSession` cursors make
        each tenant's worker schedule — hence its vote streams — a pure
        function of its OWN request history, independent of how sibling
        tenants interleave on the shared service.  Likewise the policy is
        a parameter: sessions may carry a downgraded (fewer-repeats)
        policy while the service default stays put."""
        N = len(idx)
        if N == 0:
            return np.zeros((0,), np.int64), 0, cursor
        if not self._within_budget(N * pol.repeats):
            due = self.pricing.cost(N * pol.repeats,
                                    start=self.ledger.human_votes)
            raise BudgetExceeded(
                f"batch of {N} labels x {pol.repeats} votes (${due:.2f}) "
                f"would exceed the ${self.budget:.2f} annotation budget "
                f"(spent ${self.ledger.human:.2f})")
        base, cursor = cursor, cursor + 1
        # base rounds ARE the round-robin schedule the oracle exposes
        # (one shared implementation — tests/benchmarks build the exact
        # matrices campaigns aggregate through the same method)
        votes = self.pool.vote_matrix(idx, true, pol.repeats, base)
        spent = N * pol.repeats
        self.ledger.pay_human(N, self.pricing, votes=N * pol.repeats)
        self._emit("vote_round", n=int(N), repeats=int(pol.repeats),
                   votes=int(N * pol.repeats), cursor=int(base),
                   aggregator=pol.aggregator)
        # the batch stays device-resident across top-up rounds: one full
        # upload here, then only the rows a round changed scatter in
        # (the FitEngine.extend_resident convention) — re-aggregation
        # never re-materializes or re-uploads the (N, W) matrix
        resident = self.aggregator.upload(votes)
        if self.metrics is not None:
            self.metrics.inc("annotation_labels_total", float(N))
            self.metrics.inc("annotation_votes_total",
                             float(N * pol.repeats))
        labels, conf, ds = self._aggregate(resident, pol)
        if pol.adaptive:
            rows = np.arange(N)
            for r in range(pol.repeats, pol.cap):
                active = rows[conf < pol.confidence]
                if len(active) == 0 or \
                        not self._within_budget(len(active)):
                    break
                self.ledger.pay_votes(len(active), self.pricing)
                spent += len(active)
                self._emit("topup", round=int(r), n=int(len(active)),
                           cursor=int(base))
                if self.metrics is not None:
                    self.metrics.inc("annotation_topup_rounds_total")
                    self.metrics.inc("annotation_votes_total",
                                     float(len(active)))
                self._topup_round(votes, active, idx, true, base, r)
                resident = self.aggregator.scatter(resident, active,
                                                   votes[active])
                labels, conf, ds = self._aggregate(resident, pol)
        # -- fold batch statistics into the service state ------------------
        # single-vote batches carry no quality signal (one vote always
        # "agrees" with its own aggregate and majority confidence is
        # identically 1.0): skip the fold so the estimators keep the
        # analytic prior instead of reporting a perfect crowd
        if pol.cap > 1:
            cast = votes >= 0
            match = cast & (votes == labels[:, None].astype(np.int32))
            self._count += cast.sum(axis=0)
            self._agree += match.sum(axis=0)
            self._conf_sum += float(np.sum(conf))
            self._conf_n += N
        if ds is not None:
            self._confusion_est = np.asarray(ds.confusion, np.float64)
        if pol.cap > 1:
            # quality telemetry for the live report's drift view — one
            # snapshot per statistics fold, so the trace shows the
            # estimators converging request batch by request batch
            self._emit("annotator_snapshot",
                       worker_accuracy=[float(a) for a
                                        in self.worker_accuracy()],
                       residual_error=float(
                           self.estimated_residual_error()),
                       avg_repeats=float(self.avg_repeats()))
        return labels, spent, cursor

    # -- the broker --------------------------------------------------------
    def _executor(self) -> SerialWorker:
        if self._exec is None:
            self._exec = SerialWorker("annotation", device=self.device)
        return self._exec

    def submit(self, idx: np.ndarray, true_labels: np.ndarray
               ) -> AnnotationFuture:
        """Broker a label-request batch onto the service worker thread
        (requests from any number of campaigns serialize there, so state
        mutation and charging stay single-threaded); synchronize at
        ``result()`` — the aggregated labels."""
        idx = np.asarray(idx, np.int64).copy()
        true = np.asarray(true_labels, np.int64).copy()
        m = self.metrics
        if m is None:
            return AnnotationFuture(
                self._executor().submit(self.annotate, idx, true))
        m.add_gauge("queue_depth", 1, queue="annotation")
        t_sub = time.perf_counter()

        def job():
            # wait = broker latency: submit -> the worker picks it up
            m.observe("queue_wait_seconds", time.perf_counter() - t_sub,
                      queue="annotation")
            try:
                return self.annotate(idx, true)
            finally:
                m.add_gauge("queue_depth", -1, queue="annotation")

        return AnnotationFuture(self._executor().submit(job))

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Idempotent service shutdown: join the broker thread (no-op if
        nothing was ever submitted).  ``submit`` afterwards raises;
        synchronous ``annotate`` calls remain valid."""
        if self._exec is not None:
            self._exec.close()

    def __enter__(self) -> "AnnotationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def session(self, name: str = "tenant") -> "AnnotationSession":
        """A per-tenant view of this service — the supported shape for
        sharing one service across campaigns."""
        return AnnotationSession(self, name)

    # -- fault tolerance ---------------------------------------------------
    def state_dict(self) -> Dict:
        """JSON-serializable service state: the pending-request cursor,
        the budget ledger, per-worker agreement stats, and the latest EM
        confusion estimate — with the (seeded) pool and the persisted
        label store, a resumed noisy-oracle campaign replays future
        requests bit-identically."""
        return {
            "cursor": int(self._cursor),
            "ledger": self.ledger.as_dict(),
            "agree": self._agree.tolist(),
            "count": self._count.tolist(),
            "conf_sum": float(self._conf_sum),
            "conf_n": int(self._conf_n),
            "confusion_est": (None if self._confusion_est is None
                              else self._confusion_est.tolist()),
        }

    def load_state_dict(self, s: Dict):
        self._cursor = int(s["cursor"])
        self.ledger = CostLedger.from_dict(s["ledger"])
        if self.trace is not None:
            # from_dict built a fresh ledger: re-wire the event bus
            self.ledger.trace = self.trace
            self.ledger.trace_name = "service"
        self._agree = np.asarray(s["agree"], np.int64)
        self._count = np.asarray(s["count"], np.int64)
        assert len(self._agree) == self.pool.n_workers, \
            "checkpoint was cut against a different worker pool"
        self._conf_sum = float(s["conf_sum"])
        self._conf_n = int(s["conf_n"])
        ce = s.get("confusion_est")
        self._confusion_est = None if ce is None \
            else np.asarray(ce, np.float64)


class AnnotationSession:
    """One tenant's view of a SHARED :class:`AnnotationService`.

    The shared pieces stay on the service — the worker pool, the
    aggregation engine and its compile cache, pricing, the service
    ledger, the broker thread, the batch lock.  The per-tenant pieces
    live here:

    * the **request cursor**: the worker round-robin schedule (hence the
      exact vote stream each item sees) is a pure function of this
      session's own request history, so a tenant's labels are
      bit-identical whether sibling tenants interleave with it or not,
      and a preempted-and-resumed tenant never perturbs its siblings;
    * the **vote/label counters** ``SharedPool.buy_labels`` charges
      against: the ``votes_bought`` delta a campaign reads across one
      ``human_label`` call can only ever see this session's requests —
      charges cannot cross-talk (tests/test_orchestrator.py proves it
      under interleaved submits);
    * an optional **policy override** (the fleet controller's
      ``shrink_votes`` downgrade swaps in a fewer-repeats policy for
      this tenant only).

    A session satisfies the same task-facing surface the bare service
    does (``annotate``/``submit``/``votes_bought``/``state_dict``/
    quality estimators), so ``task.annotation = service.session(...)``
    is a drop-in."""

    def __init__(self, service: AnnotationService, name: str = "tenant"):
        self.service = service
        self.name = name
        self._cursor = 0
        self._votes = 0
        self._labels = 0
        self._policy: Optional[RepeatPolicy] = None
        self.trace = None
        # per-tenant resilience overrides (None = the service's): a chaos
        # harness can fail ONE tenant's requests while siblings run clean
        self._faults = None
        self._retry = None

    # -- shared-surface delegation -----------------------------------------
    @property
    def pool(self) -> AnnotatorPool:
        return self.service.pool

    @property
    def pricing(self) -> LabelingService:
        return self.service.pricing

    @property
    def policy(self) -> RepeatPolicy:
        return self._policy or self.service.policy

    def expected_quality(self) -> LabelQuality:
        return self.service.expected_quality()

    def calibrate(self, n: int = 2048) -> LabelQuality:
        return self.service.calibrate(n)

    def estimated_residual_error(self) -> float:
        return self.service.estimated_residual_error()

    def worker_accuracy(self) -> np.ndarray:
        return self.service.worker_accuracy()

    def confusion_estimate(self) -> Optional[np.ndarray]:
        return self.service.confusion_estimate()

    # -- per-tenant accounting ---------------------------------------------
    @property
    def votes_bought(self) -> int:
        """THIS session's priced requests (the ``buy_labels`` delta
        protocol reads this — sibling sessions never move it)."""
        return self._votes

    @property
    def labels_bought(self) -> int:
        return self._labels

    @property
    def request_cursor(self) -> int:
        return self._cursor

    def avg_repeats(self) -> float:
        if self._labels == 0:
            return float(self.policy.repeats)
        return self._votes / self._labels

    def set_policy(self, policy: Optional[RepeatPolicy]) -> None:
        """Install a per-tenant policy override (None restores the
        service default) — the fleet controller's vote-shrink hook."""
        if policy is not None:
            assert policy.cap <= self.service.pool.n_workers
        self._policy = policy

    # -- the request path --------------------------------------------------
    def annotate(self, idx: np.ndarray, true_labels: np.ndarray
                 ) -> np.ndarray:
        """One request batch through the shared service, scheduled off
        THIS session's cursor.  Batches still serialize on the service
        lock; the session's counters update on the calling thread (one
        tenant drives one session — sessions are not themselves
        concurrency-safe, the service is)."""
        idx = np.asarray(idx, np.int64)
        true = np.asarray(true_labels, np.int64)
        svc = self.service
        retry = self._retry if self._retry is not None else svc.retry
        timeout = retry.timeout if retry is not None else None

        def attempt():
            with svc._lock:
                out = svc._annotate_locked(idx, true, self._cursor,
                                           self.policy, self._faults,
                                           timeout)
                self._cursor = out[2]
                return out

        labels, votes, _ = svc._run_request(attempt, retry=retry,
                                            trace=self.trace)
        self._votes += votes
        self._labels += len(idx)
        if self.trace is not None:
            self.trace.emit("vote_round", session=self.name,
                            n=int(len(idx)), votes=int(votes),
                            cursor=int(self._cursor - 1))
        return labels

    def submit(self, idx: np.ndarray, true_labels: np.ndarray
               ) -> AnnotationFuture:
        """Broker a batch onto the shared service worker thread.  The
        session's cursor/counters update on that worker before the
        future resolves, so a tenant that synchronizes at ``result()``
        reads its own accounting consistently."""
        idx = np.asarray(idx, np.int64).copy()
        true = np.asarray(true_labels, np.int64).copy()
        return AnnotationFuture(
            self.service._executor().submit(self.annotate, idx, true))

    # -- lifecycle ---------------------------------------------------------
    def attach_trace(self, trace) -> None:
        """Per-tenant observability only: the session emits its own vote
        rounds into the tenant trace.  The SHARED service ledger and
        batch telemetry are deliberately NOT wired here — their events
        interleave every tenant's requests and belong to the fleet
        trace, not to any one tenant's decision stream."""
        self.trace = trace

    def attach_metrics(self, metrics) -> None:
        """Runtime metrics are shared-service telemetry: delegate to the
        service registry (per-tenant attribution happens via the
        registry's bound labels on the calling thread, not here)."""
        self.service.attach_metrics(metrics)

    def attach_faults(self, faults, retry=None) -> None:
        """Per-SESSION chaos/retry override: only this tenant's request
        batches tick the injector (and retry under ``retry``) — the seam
        the quarantine acceptance test fails one tenant through while
        its siblings stay fault-free.  The service-level
        :meth:`AnnotationService.attach_faults` remains the
        whole-endpoint chaos switch."""
        self._faults = faults
        if retry is not None:
            self._retry = retry

    def close(self) -> None:
        """Sessions do not own the broker thread — closing one is a
        no-op (the service/fleet owner closes the service)."""

    # -- fault tolerance ---------------------------------------------------
    def state_dict(self) -> Dict:
        """Per-tenant session state only (cursor + counters): a resumed
        tenant replays ITS schedule bit-identically from here.  The
        shared service's state is fleet infrastructure and is persisted
        by the service owner, not per tenant."""
        return {"session": True, "cursor": int(self._cursor),
                "votes": int(self._votes), "labels": int(self._labels)}

    def load_state_dict(self, s: Dict):
        assert s.get("session"), \
            "checkpoint carries bare-service state, not a session's"
        self._cursor = int(s["cursor"])
        self._votes = int(s["votes"])
        self._labels = int(s["labels"])


def make_annotation_service(
        num_classes: int, *, n_workers: int = 5, noise: float = 0.2,
        spammer_frac: float = 0.0, repeats: int = 1,
        max_repeats: Optional[int] = None, adaptive: bool = False,
        confidence: float = 0.9, aggregator: str = "majority",
        pricing: LabelingService = LabelingService("annotation", 0.04),
        budget: Optional[float] = None, seed: int = 0,
        device="cuda") -> AnnotationService:
    """One-call construction of the full runtime (the launcher's and the
    tests' entry point)."""
    from repro_torch.annotation.oracle import make_annotator_pool
    pool = make_annotator_pool(n_workers, num_classes, noise=noise,
                               spammer_frac=spammer_frac, seed=seed)
    return AnnotationService(
        pool, RepeatPolicy(repeats=repeats, max_repeats=max_repeats,
                           adaptive=adaptive, confidence=confidence,
                           aggregator=aggregator),
        pricing=pricing, budget=budget, device=device)
