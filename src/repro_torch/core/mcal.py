"""The MCAL campaign loop (paper Alg. 1), ``repro.core.mcal``.

One campaign = one (task, labeling service, MCALConfig).  The loop:

  bootstrap:  human-label a test set T (test_frac) and a random seed set B0
              (delta0_frac); train; measure eps_T(S^theta) over the theta grid.
  iterate:    fit the per-theta truncated power laws and the training-cost
              model from the measurement history; joint-search (|B|, theta)
              for the predicted minimum cost C*; once C* stabilizes
              (|dC*| <= stability_tol) adapt delta (Alg. 1 line 20) and stop
              when |B| has reached B_opt; otherwise acquire delta more
              samples ranked by M(.), human-label, retrain, re-measure.
  bail-out:   if training spend exceeds bailout_frac of the full human-
              labeling cost while no feasible machine labeling exists, label
              everything with humans (the paper's ImageNet behaviour).
  commit:     rank the remaining pool by L(.), machine-label the largest
              prefix the *measured* test-set error curve admits within
              eps_target, human-label the residual.

Every decision is the reference's, for perfect human labels and for a
noisy annotation service on the task (``task.annotation``): the campaign
charges the votes the service bought, prices future labels
repeats-inclusive and folds the residual aggregated-label error into its
accuracy target (``MCALConfig.label_quality``).  With
``sweep_async`` the M(.) sweep overlaps the host-side fits and search; with
``fit_async`` each retrain and its measurement run on the fit engine's
worker and fold at the next consumer (:meth:`MCALCampaign._sync_fit`).
Both are record-identical to the synchronous campaign.  A campaign with a
trace attached emits the reference's decision events (``campaign_begin``,
``bootstrap``, ``charge``, ``measure``, ``powerlaw_fit``, ``search``,
``iteration``, ``acquisition``, ``done``, ``commit``) and its
observability events (``state_save``, ``resume``, the runtimes' sweep and
fit events), and ``state_dict``/``load_state_dict`` persist the loop at the
reference's schema (``STATE_VERSION``), so a state file written by either
package resumes in the other.  ``attach_metrics``, ``attach_faults`` and
``attach_health`` wire the runtime metrics registry, the chaos injector
(with the ``campaign.iteration`` kill point) and the streaming health
engine through the campaign, its task and its annotation service; all
three emit observability kinds only, so an instrumented, monitored or
chaos campaign whose retries succeed diffs clean against a plain one.

:func:`select_architecture` runs several campaigns over one
:class:`SharedPool` (labels bought once, every candidate trains and pays
its own training into the shared ledger) with delta frozen at delta0
until the argmin-C* candidate is settled, then continues that one alone —
the paper's CNN18/Res18/Res50 selection (§4).  ``budget`` in MCALConfig
switches the search to the budget-constrained variant (min error s.t.
cost <= budget).
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import selection as sel
from repro_torch.core.cost import (CostLedger, LabelQuality, LabelingService,
                                   TrainCostModel)
from repro_torch.core.powerlaw import PowerLaw, fit_power_law
from repro_torch.core.search import (SearchResult, adapt_delta, budget_search,
                                     joint_search)
from repro_torch.faults.errors import StragglerTimeout
from repro_torch.trace.store import sanitize as _trace_sanitize

DEFAULT_THETAS = tuple(round(0.05 * i, 2) for i in range(1, 21))

# campaign state_dict schema version (the reference's): v2 carries
# "version" and the "trace" append cursor
STATE_VERSION = 2


@dataclasses.dataclass(frozen=True)
class MCALConfig:
    eps_target: float = 0.05
    thetas: Tuple[float, ...] = DEFAULT_THETAS
    delta0_frac: float = 0.01
    test_frac: float = 0.05
    metric: str = "margin"          # M(.)
    l_metric: str = "margin"        # L(.)
    stability_tol: float = 0.05     # Delta (Alg. 1 line 19)
    beta: float = 0.05              # delta-adaptation slack (line 20)
    bailout_frac: float = 0.10      # exploration tax x%
    bailout_min_s: float = 0.25     # "cannot machine-label any": |S*|/|X| floor
    cost_exponent: int = 1          # per-iteration cost ~ |B|^exponent
    max_iters: int = 200
    min_fit_points: int = 3
    seed: int = 0
    keep_surface: bool = False      # keep each search's (|B|, theta)
                                    # grid on its IterationRecord
    budget: Optional[float] = None  # set -> budget-constrained variant
    sweep_async: bool = False       # overlap the M(.) sweep with the
                                    # host-side fits + joint search
    fit_async: bool = False         # defer each retrain + its measurement
                                    # onto the fit-engine worker
    label_quality: Optional[LabelQuality] = None
                                    # noisy annotation-service economics:
                                    # residual aggregated-label error is
                                    # folded into the accuracy target and
                                    # future human labels are priced
                                    # repeats-inclusive in the joint
                                    # search (None = perfect labels)


@dataclasses.dataclass
class IterationRecord:
    i: int
    B_size: int
    delta: int
    eps_theta: Dict[float, float]
    cstar: float
    B_opt: int
    theta_opt: float
    feasible: bool
    stable: bool
    human_spent: float
    training_spent: float
    search: Optional[SearchResult] = None   # keep_surface only

    def to_dict(self) -> Dict:
        """JSON form — the ``iteration`` trace event and the state file's
        history entry (``search`` stays in memory)."""
        return {
            "i": int(self.i), "B_size": int(self.B_size),
            "delta": int(self.delta),
            "eps_theta": {str(t): float(e)
                          for t, e in self.eps_theta.items()},
            "cstar": float(self.cstar), "B_opt": int(self.B_opt),
            "theta_opt": float(self.theta_opt),
            "feasible": bool(self.feasible), "stable": bool(self.stable),
            "human_spent": float(self.human_spent),
            "training_spent": float(self.training_spent)}

    @classmethod
    def from_dict(cls, d: Dict) -> "IterationRecord":
        return cls(
            i=int(d["i"]), B_size=int(d["B_size"]), delta=int(d["delta"]),
            eps_theta={float(t): float(e)
                       for t, e in d["eps_theta"].items()},
            cstar=float(d["cstar"]), B_opt=int(d["B_opt"]),
            theta_opt=float(d["theta_opt"]), feasible=bool(d["feasible"]),
            stable=bool(d["stable"]),
            human_spent=float(d["human_spent"]),
            training_spent=float(d["training_spent"]))


@dataclasses.dataclass
class MCALResult:
    labels: np.ndarray
    machine_mask: np.ndarray
    ledger: Dict
    history: List[IterationRecord]
    decision: str                  # hybrid | human_all | budget
    B_size: int
    S_size: int
    theta_final: float
    measured_error: float          # vs groundtruth (simulation oracle)
    arch_name: str = ""

    @property
    def total_cost(self) -> float:
        return self.ledger["total"]

    def to_dict(self, with_history: bool = True) -> Dict:
        """JSON form — the ``commit`` trace event.  The label arrays stay
        out; ``pool_size`` keeps their shape for :meth:`from_dict`."""
        d = {
            "decision": str(self.decision), "B_size": int(self.B_size),
            "S_size": int(self.S_size),
            "theta_final": float(self.theta_final),
            "measured_error": float(self.measured_error),
            "arch_name": str(self.arch_name),
            "pool_size": int(len(self.labels)),
            "ledger": {k: (int(v) if isinstance(v, (int, np.integer))
                           else float(v))
                       for k, v in self.ledger.items()},
        }
        if with_history:
            d["history"] = [r.to_dict() for r in self.history]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "MCALResult":
        n = int(d.get("pool_size", 0))
        return cls(
            labels=np.full(n, -1, np.int64),
            machine_mask=np.zeros(n, bool), ledger=dict(d["ledger"]),
            history=[IterationRecord.from_dict(r)
                     for r in d.get("history", [])],
            decision=str(d["decision"]), B_size=int(d["B_size"]),
            S_size=int(d["S_size"]),
            theta_final=float(d["theta_final"]),
            measured_error=float(d["measured_error"]),
            arch_name=str(d.get("arch_name", "")))


def _fitted_payload(laws: Dict[float, PowerLaw],
                    cm: TrainCostModel) -> Dict:
    """The persistable form of one round of power-law/cost fits — shared
    by ``state_dict`` and the ``powerlaw_fit`` trace event."""
    return {
        # np.inf (plain power law) is not strict JSON -> None
        "laws": {str(t): {
            "alpha": law.alpha, "gamma": law.gamma,
            "k": None if not np.isfinite(law.k) else law.k,
            "resid_std": law.resid_std, "n_points": law.n_points}
            for t, law in laws.items()},
        "cost_model": {"c_u": cm.c_u, "exponent": cm.exponent},
    }


def oracle_labels(task, idx: np.ndarray) -> np.ndarray:
    """TRUE labels for evaluation only.  Tasks expose ``oracle_labels`` so
    that measurement never routes through ``human_label``: with a noisy
    annotation service attached, that path returns aggregated noisy votes
    and consumes priced annotation requests."""
    fn = getattr(task, "oracle_labels", None)
    return fn(idx) if fn is not None else task.human_label(idx)


class SharedPool:
    """Label store shared across campaigns (architecture selection buys
    each label once): which rows are test/train and what each one cost."""

    def __init__(self, pool_size: int, ledger: Optional[CostLedger] = None):
        self.pool_size = pool_size
        self.labels = np.full(pool_size, -1, np.int64)
        self.is_test = np.zeros(pool_size, bool)
        self.in_B = np.zeros(pool_size, bool)
        self.T_idx: Optional[np.ndarray] = None
        self.B_idx: np.ndarray = np.zeros((0,), np.int64)
        self.ledger = ledger or CostLedger()

    def buy_labels(self, task, idx: np.ndarray, service: LabelingService):
        """THE charging site: every purchased label pays through
        ``CostLedger.pay_human`` at the service's tier rates — with an
        annotation service on the task, repeats-inclusive (the votes the
        service reports for the call, so adaptive-repeats batches are
        charged exactly what they consumed)."""
        idx = np.asarray(idx, np.int64)
        fresh = idx[self.labels[idx] < 0]
        if len(fresh):
            ann = getattr(task, "annotation", None)
            v0 = ann.votes_bought if ann is not None else 0
            self.labels[fresh] = task.human_label(fresh)
            votes = (ann.votes_bought - v0) if ann is not None \
                else len(fresh)
            self.ledger.pay_human(len(fresh), service, votes=votes)

    def unlabeled_candidates(self) -> np.ndarray:
        mask = (~self.is_test) & (~self.in_B)
        return np.nonzero(mask)[0]


class MCALCampaign:
    def __init__(self, task, service: LabelingService, cfg: MCALConfig,
                 shared: Optional[SharedPool] = None):
        self.task = task
        self.service = service
        self.cfg = cfg
        self.pool = shared or SharedPool(task.pool_size)
        self.rng = np.random.default_rng(cfg.seed)
        self.history: List[IterationRecord] = []
        # per-theta (B, eps) measurement history
        self.eps_hist: Dict[float, List[Tuple[int, float]]] = {
            t: [] for t in cfg.thetas}
        self.train_sizes: List[int] = []
        self.train_costs: List[float] = []
        self.delta = 0
        self.cstar_old: Optional[float] = None
        self.stable = False
        self.done = False
        self.done_reason = ""
        # this campaign's own training spend: C* predictions compare
        # architectures as if each ran alone (the shared ledger still
        # collects every candidate's spend as the exploration tax)
        self.own_training = 0.0
        self.freeze_delta = False   # exploration keeps delta at delta0
        self.decision = "hybrid"
        self.B_opt = 0
        self.theta_opt = 0.0
        # k-center anchor cache: features of B under the CURRENT classifier
        # (invalidated every retrain, rebuilt from B_idx on demand/resume)
        self._anchor_feats: Optional[np.ndarray] = None
        # in-flight async M(.) sweep: (submitted k, SweepFuture)
        self._pending: Optional[Tuple[int, object]] = None
        # in-flight async retrain + measurement: (|B| at submit, FitFuture)
        self._fit_pending: Optional[Tuple[int, object]] = None
        # memoized power-law/cost fits: (history key, laws, cost model)
        self._fit_models_cache: Optional[Tuple] = None
        # commit-sweep cursor wiring (set by the launcher: process-local
        # restart plumbing, not campaign policy)
        self.sweep_checkpoint_every = 0          # pages between cursor cuts
        self.on_sweep_checkpoint = None          # callback(SweepCheckpoint)
        self.resume_sweep_checkpoint = None      # cursor to resume from
        # straggler wall budgets for the async folds (seconds; None = wait
        # forever).  Launcher-set plumbing like the cursors above
        # (--sweep-timeout/--fit-timeout)
        self.sweep_timeout = None
        self.fit_timeout = None
        self._iter = 0
        # campaign event bus (attach_trace): None = tracing off
        self.trace = None
        # runtime metrics registry (attach_metrics): None = metrics off
        self.metrics = None
        # chaos injector (attach_faults): None = injection off
        self.faults = None
        # streaming health engine (attach_health): None = monitoring off
        self.health = None

    def attach_trace(self, trace) -> None:
        """Wire the event bus through this campaign's decision sites, the
        ledger's charging sites, the annotation service (vote rounds,
        top-ups, quality snapshots) and the task's sweep/fit runtimes.
        Call before ``bootstrap``/``load_state_dict``."""
        self.trace = trace
        self.pool.ledger.trace = trace
        self.pool.ledger.trace_name = "campaign"
        ann = getattr(self.task, "annotation", None)
        if ann is not None and hasattr(ann, "attach_trace"):
            ann.attach_trace(trace)
        if hasattr(self.task, "attach_trace"):
            self.task.attach_trace(trace)

    def attach_metrics(self, metrics) -> None:
        """Wire a runtime metrics registry (``repro_torch.obs``) through the
        campaign: loop-phase spans (bootstrap/iteration/commit) here,
        engine telemetry through the task's ``attach_metrics``, and the
        annotation service's queue and EM counters.  Metric events are
        OBSERVABILITY_KINDS, so an instrumented campaign's decision stream
        diffs clean against an uninstrumented sibling's."""
        self.metrics = metrics
        ann = getattr(self.task, "annotation", None)
        if ann is not None and hasattr(ann, "attach_metrics"):
            ann.attach_metrics(metrics)
        if hasattr(self.task, "attach_metrics"):
            self.task.attach_metrics(metrics)

    def attach_faults(self, faults, retry=None) -> None:
        """Wire a :class:`repro_torch.faults.FaultInjector` (and optional
        :class:`~repro_torch.faults.RetryPolicy`) through every fault site
        this campaign owns: the annotation request path (per service or
        per session), the task's sweep/fit workers, the trace store's
        flush and this loop's kill point.  Call AFTER ``attach_trace`` /
        ``attach_metrics`` so fault and retry events ride the same
        surfaces.  A chaos run whose retries succeed stays diff-clean
        against its fault-free sibling."""
        self.faults = faults
        if self.trace is not None:
            faults.attach_trace(self.trace)
            if hasattr(self.trace, "attach_faults"):
                self.trace.attach_faults(faults)
        if self.metrics is not None:
            faults.attach_metrics(self.metrics)
        ann = getattr(self.task, "annotation", None)
        if ann is not None and hasattr(ann, "attach_faults"):
            ann.attach_faults(faults, retry)
        if hasattr(self.task, "attach_faults"):
            self.task.attach_faults(faults, retry)

    def attach_health(self, health) -> None:
        """Wire a :class:`repro_torch.obs.health.HealthEngine` to the
        iteration boundary: after every iteration it samples the ledger
        and fit state and emits its hysteresis-gated ``alert`` events.
        Call AFTER ``attach_trace``/``attach_metrics`` — the engine
        inherits this campaign's trace and registry unless it has its
        own."""
        self.health = health
        if health.trace is None and self.trace is not None:
            health.attach_trace(self.trace)
        if health.metrics is None and self.metrics is not None:
            health.attach_metrics(self.metrics)

    def _mspan(self, name: str):
        """A named campaign-phase span, or a no-op context when metrics
        are off."""
        if self.metrics is None:
            return contextlib.nullcontext()
        return self.metrics.span(name)

    def _emit(self, kind: str, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **_trace_sanitize(payload))

    # -- bootstrap ----------------------------------------------------------
    def bootstrap(self, *, adopt: bool = False):
        """Buy T and B0 and train; ``adopt`` takes both from the shared
        pool another campaign bootstrapped (no rng draw, nothing bought)."""
        with self._mspan("bootstrap"):
            return self._bootstrap_impl(adopt=adopt)

    def _bootstrap_impl(self, *, adopt: bool = False):
        X = self.task.pool_size
        p = self.pool
        if self.trace is not None:
            # config = campaign policy (decisions must match across
            # siblings); runtime = execution mode (normalized out by diff)
            cfgd = dataclasses.asdict(self.cfg)
            runtime = {"sweep_async": cfgd.pop("sweep_async"),
                       "fit_async": cfgd.pop("fit_async")}
            self._emit("campaign_begin", config=cfgd, runtime=runtime,
                       pool_size=int(X),
                       arch=getattr(self.task, "arch_name", ""))
        if not adopt:
            T_size = max(int(round(self.cfg.test_frac * X)), 16)
            p.T_idx = self.rng.choice(X, T_size, replace=False)
            p.is_test[p.T_idx] = True
            p.buy_labels(self.task, p.T_idx, self.service)
            delta0 = max(int(round(self.cfg.delta0_frac * X)), 8)
            b0 = self.rng.choice(p.unlabeled_candidates(), delta0,
                                 replace=False)
            p.in_B[b0] = True
            p.B_idx = b0
            p.buy_labels(self.task, b0, self.service)
        self.delta = len(p.B_idx)
        self._emit("bootstrap", T_size=int(len(p.T_idx)),
                   B_size=int(len(p.B_idx)), adopt=bool(adopt))
        self._train_and_measure()

    # -- internals ----------------------------------------------------------
    def _train_and_measure(self):
        p = self.pool
        self._anchor_feats = None   # the representation moves every retrain
        nB = len(p.B_idx)
        if self.cfg.fit_async and hasattr(self.task, "submit_train"):
            # the retrain and its measurement run on the fit worker; the
            # cost is paid up front (it must be known without training —
            # a measured-cost task takes the synchronous path), and
            # _sync_fit() folds the measurement at the next consumer, so
            # the records equal the synchronous campaign's
            c = (self.task.train_cost(nB)
                 if hasattr(self.task, "train_cost") else None)
            if c is not None:
                self._pay_training(nB, c)
                T_idx, labels_T = p.T_idx, p.labels[p.T_idx]

                def measure():
                    stats_T, _ = self.task.score(T_idx)
                    return stats_T, self.task.eval_correct(T_idx, labels_T)

                self._fit_pending = (nB, self.task.submit_train(
                    p.B_idx, p.labels[p.B_idx], then=measure))
                return
        c = self.task.train(p.B_idx, p.labels[p.B_idx])
        self._pay_training(nB, c)
        stats_T, _ = self.task.score(p.T_idx)
        correct = self.task.eval_correct(p.T_idx, p.labels[p.T_idx])
        self._record_measurement(nB, stats_T, correct)

    def _pay_training(self, nB: int, c: float):
        p = self.pool
        p.ledger.pay_training(c)
        self.own_training += c
        self.train_sizes.append(nB)
        self.train_costs.append(c)

    def _record_measurement(self, nB: int, stats_T, correct):
        curve = sel.machine_label_error_curve(
            stats_T, correct, self.cfg.thetas, self.cfg.l_metric)
        for t, e in zip(self.cfg.thetas, curve):
            self.eps_hist[t].append((nB, float(e)))
        # emitted at fold time on the main thread, so the decision stream
        # is position-identical to the synchronous campaign's
        self._emit("measure", B=int(nB),
                   eps={str(t): float(e)
                        for t, e in zip(self.cfg.thetas, curve)})

    def _sync_fit(self):
        """Fold an in-flight async retrain: record its measurement exactly
        as the synchronous path would have (its cost was paid at
        submit)."""
        if self._fit_pending is None:
            return
        nB, fut = self._fit_pending
        self._fit_pending = None
        try:
            _c, (stats_T, correct) = fut.result(self.fit_timeout)
        except StragglerTimeout:
            if self.metrics is not None:
                self.metrics.inc("straggler_timeouts_total", engine="fit")
            raise
        self._record_measurement(nB, stats_T, correct)

    def _fit_models(self) -> Tuple[Dict[float, PowerLaw], TrainCostModel]:
        """Fit the per-theta truncated power laws + the training-cost
        model, memoized on the measurement-history key (a resumed campaign
        restores the persisted fits into this cache)."""
        key = (len(self.train_sizes),
               sum(len(v) for v in self.eps_hist.values()))
        if self._fit_models_cache is not None \
                and self._fit_models_cache[0] == key:
            return self._fit_models_cache[1], self._fit_models_cache[2]
        laws = {}
        for t, pts in self.eps_hist.items():
            sizes = [s for s, _ in pts]
            errs = [e for _, e in pts]
            laws[t] = fit_power_law(sizes, errs,
                                    truncated=len(pts) >= self.cfg.min_fit_points)
        cm = TrainCostModel(exponent=self.cfg.cost_exponent).fit(
            self.train_sizes, self.train_costs)
        self._fit_models_cache = (key, laws, cm)
        self._emit("powerlaw_fit", train_points=int(key[0]),
                   **_fitted_payload(laws, cm))
        return laws, cm

    # -- noisy-annotation economics ---------------------------------------
    def _quality(self) -> LabelQuality:
        return self.cfg.label_quality or LabelQuality()

    def _effective_service(self) -> LabelingService:
        """Future human labels priced repeats-inclusive: what every
        prediction (joint search, delta adaptation, bailout/budget
        thresholds) must use."""
        return self._quality().effective_service(self.service)

    def search(self, keep_surface: Optional[bool] = None) -> SearchResult:
        self._sync_fit()
        laws, cm = self._fit_models()
        p = self.pool
        kw = dict(pool_size=self.task.pool_size, test_size=len(p.T_idx),
                  current_B=len(p.B_idx), spent=self.own_training,
                  laws=laws, cost_model=cm, delta=self.delta,
                  service=self._effective_service())
        if self.cfg.budget is not None:
            res = budget_search(budget=self.cfg.budget, **kw)
        else:
            # residual aggregated-label error eats into the target: the
            # machine-label slice must clear what is left of it
            res = joint_search(
                eps_target=self._quality().effective_target(
                    self.cfg.eps_target),
                keep_surface=self.cfg.keep_surface
                if keep_surface is None else keep_surface, **kw)
        self._emit("search", cost=res.cost, B_opt=int(res.B_opt),
                   theta_opt=float(res.theta_opt),
                   machine_labeled=int(res.machine_labeled),
                   feasible=bool(res.feasible),
                   human_all_cost=res.human_all_cost)
        return res

    # -- one loop body --------------------------------------------------------
    def iteration(self, *, acquire: bool = True,
                  forced_acquisition: Optional[np.ndarray] = None):
        """One loop body; ``acquire=False`` stops before the purchase, and
        ``forced_acquisition`` buys the given rows instead of M(.)'s
        (architecture selection).  Neither submits the async M(.)
        sweep."""
        with self._mspan("iteration"):
            rec = self._iteration_impl(acquire=acquire,
                                       forced_acquisition=forced_acquisition)
        if self.metrics is not None:
            self.metrics.inc("campaign_iterations_total")
            self.metrics.set_gauge("campaign_spent_total",
                                   float(self.pool.ledger.total))
        if self.health is not None:
            self.health.tick_campaign(self)
        return rec

    def _iteration_impl(self, *, acquire: bool = True,
                        forced_acquisition: Optional[np.ndarray] = None):
        assert not self.done
        if self.faults is not None:
            # the kill point sits BEFORE any mutation of this iteration
            # (and before the async-fit fold), so an InjectedKill here
            # leaves the campaign exactly at the previous iteration's
            # state — what the autosave sidecar persists
            self.faults.check("campaign.iteration")
        self._sync_fit()   # fold last iteration's async retrain first
        p = self.pool
        X = self.task.pool_size
        # async overlap: launch this iteration's M(.) sweep before the
        # host-side fits + search; acquire() folds it.  Submitted at the
        # current delta: the rankings are prefix-stable, so acquire() trims
        # to a smaller take, and a larger adapted delta re-ranks.
        self._pending = None
        if (acquire and forced_acquisition is None and self.cfg.sweep_async
                and self.cfg.metric != "random"
                and hasattr(self.task, "submit_candidates")):
            cand = p.unlabeled_candidates()
            k = min(self.delta, len(cand))
            if k > 0:
                anchors = (self._anchor_features()
                           if self.cfg.metric == "kcenter" else None)
                self._pending = (k, self.task.submit_candidates(
                    self.cfg.metric, k, cand, anchors=anchors))
        res = self.search()
        self.B_opt, self.theta_opt = res.B_opt, res.theta_opt

        # stability (line 19) + delta adaptation (line 20)
        stable_now = (self.cstar_old is not None and res.cost > 0 and
                      abs(res.cost - self.cstar_old) / res.cost
                      <= self.cfg.stability_tol)
        if stable_now:
            self.stable = True
        self.cstar_old = res.cost

        rec = IterationRecord(
            i=self._iter, B_size=len(p.B_idx), delta=self.delta,
            eps_theta={t: self.eps_hist[t][-1][1] for t in self.cfg.thetas},
            cstar=res.cost, B_opt=res.B_opt, theta_opt=res.theta_opt,
            feasible=res.feasible, stable=self.stable,
            human_spent=p.ledger.human, training_spent=p.ledger.training,
            search=res if self.cfg.keep_surface else None)
        self.history.append(rec)
        self._emit("iteration", **rec.to_dict())
        self._iter += 1

        if self.cfg.budget is not None:
            # budget variant: stop training when the next acquisition would
            # break the budget (reserve the residual human labels' worth)
            next_spend = (self.delta *
                          self._effective_service().price_per_label +
                          self._fit_models()[1].iteration_cost(
                              len(p.B_idx) + self.delta))
            if p.ledger.total + float(next_spend) > self.cfg.budget:
                self._finish("budget")
                return rec
        else:
            # bail-out (paper §5.1 footnote): exploration tax exceeded while
            # the classifier still cannot machine-label any meaningful
            # fraction (ImageNet behaviour) -> human-label everything.
            human_all = X * self._effective_service().price_per_label
            no_meaningful_S = (not res.feasible or res.theta_opt == 0.0 or
                               res.machine_labeled < self.cfg.bailout_min_s * X)
            if no_meaningful_S and \
                    p.ledger.training > self.cfg.bailout_frac * human_all:
                self.decision = "human_all"
                self._finish("bailout")
                return rec

        if self.stable and not self.freeze_delta:
            nd = adapt_delta(
                current_B=len(p.B_idx), B_opt=res.B_opt, cstar=res.cost,
                spent=self.own_training, pool_size=X, test_size=len(p.T_idx),
                machine_labeled=res.machine_labeled,
                cost_model=self._fit_models()[1],
                service=self._effective_service(), beta=self.cfg.beta)
            if nd > 0:
                self.delta = nd

        # Alg. 1 line 9: continue only while growing B is predicted to
        # reduce cost (C* < C(B_opt + delta) <=> B_opt > |B|), gated on the
        # fit having min_fit_points and a stable C*.  Exploration-frozen
        # campaigns (architecture selection) never end here.
        enough = len(self.train_sizes) >= self.cfg.min_fit_points
        if enough and self.stable and res.feasible and \
                res.B_opt <= len(p.B_idx) and not self.freeze_delta:
            self._finish("converged")
            return rec

        if self._iter >= self.cfg.max_iters:
            self._finish("max_iters")
            return rec

        if acquire:
            self.acquire(forced_acquisition)
        return rec

    def acquire(self, forced: Optional[np.ndarray] = None):
        """Buy delta labels ranked by M(.) (or the ``forced`` rows as
        given), retrain, re-measure.  An async ranking sweep launched by
        ``iteration`` is folded here and its prefix trimmed to the final
        take."""
        p = self.pool
        cand = p.unlabeled_candidates()
        pending, self._pending = self._pending, None
        if len(cand) == 0:
            if pending is not None:
                pending[1].cancel()
            self._finish("pool_exhausted")
            return
        if forced is not None:
            if pending is not None:
                pending[1].cancel()
            pick = np.asarray(forced, np.int64)
        else:
            take = min(self.delta, len(cand))
            if self.stable and self.B_opt > len(p.B_idx):
                take = min(take, self.B_opt - len(p.B_idx))
            pick = None
            if pending is not None:
                if take <= pending[0]:
                    try:
                        out = pending[1].result(self.sweep_timeout)
                    except StragglerTimeout:
                        if self.metrics is not None:
                            self.metrics.inc("straggler_timeouts_total",
                                             engine="sweep")
                        raise
                    full = out[0] if isinstance(out, tuple) else out
                    pick = np.asarray(full[:take], np.int64)
                else:   # the adapted delta outgrew the submitted sweep
                    pending[1].cancel()
            if pick is None:
                pick = self._rank_candidates(take, cand)
        if self.trace is not None:
            # a CRC over the ordered picks pins the acquisition bit-exactly
            # across sibling runs without the index set in the trace
            pick_arr = np.ascontiguousarray(np.asarray(pick, np.int64))
            self._emit("acquisition", n=int(len(pick_arr)),
                       digest=int(zlib.crc32(pick_arr.tobytes())),
                       forced=bool(forced is not None))
        p.buy_labels(self.task, pick, self.service)
        p.in_B[pick] = True
        p.B_idx = np.concatenate([p.B_idx, pick])
        self._train_and_measure()

    def _finish(self, reason: str):
        """End the loop, recording WHY (budget | bailout | converged |
        max_iters | pool_exhausted | fleet_ceiling | quarantined); an
        in-flight async sweep is dropped."""
        self.done = True
        self.done_reason = reason
        self._emit("done", reason=reason)
        self._drop_pending()

    def _drop_pending(self):
        """Cancel (best-effort) and forget an in-flight async M(.) sweep."""
        if self._pending is not None:
            self._pending[1].cancel()
            self._pending = None

    def _anchor_features(self) -> Optional[np.ndarray]:
        """k-center anchor set: features of the human-labeled set B under
        the CURRENT classifier, cached per training round and rebuilt from
        ``B_idx`` alone (one feature sweep on resume)."""
        p = self.pool
        if len(p.B_idx) == 0:
            return None
        if self._anchor_feats is None:
            if hasattr(self.task, "anchor_features"):
                self._anchor_feats = self.task.anchor_features(p.B_idx)
            else:
                self._anchor_feats = np.asarray(
                    self.task.score(p.B_idx)[1], np.float32)
        return self._anchor_feats

    def _rank_candidates(self, k: int, cand: np.ndarray) -> np.ndarray:
        """M(.): pick ``k`` of ``cand`` — the task's paged top-k for the
        uncertainty metrics (the host ranking of its scores for a task
        without one, the emulator), its device k-center, or (``random``)
        the host reference path."""
        if k <= 0:
            return np.zeros((0,), np.int64)
        if self.cfg.metric in sel.UNCERTAINTY_METRICS and \
                hasattr(self.task, "topk_candidates"):
            return self.task.topk_candidates(self.cfg.metric, k, cand)
        if self.cfg.metric == "kcenter":
            pick, _ = self.task.kcenter_candidates(
                k, cand, anchors=self._anchor_features())
            return pick
        stats = (self.task.score(cand)[0]
                 if self.cfg.metric in sel.UNCERTAINTY_METRICS else None)
        return sel.select_for_training(self.cfg.metric, k, stats=stats,
                                       candidates=cand, rng=self.rng)

    def propose_acquisition(self, k: int) -> np.ndarray:
        """Rank candidates by this campaign's M(.) without buying or
        charging anything (a pending async retrain is folded first)."""
        self._sync_fit()
        cand = self.pool.unlabeled_candidates()
        return self._rank_candidates(min(k, len(cand)), cand)

    def _machine_label(self, idx: np.ndarray):
        """L(.): one paged sweep over ``idx`` -> (rows most-confident-
        first, machine labels row-aligned with ``idx``), cutting a
        resumable cursor every ``sweep_checkpoint_every`` pages (and
        resuming one) where the launcher asks for it."""
        kw = {}
        if self.sweep_checkpoint_every or \
                self.resume_sweep_checkpoint is not None:
            kw = dict(checkpoint=self.resume_sweep_checkpoint,
                      checkpoint_every=self.sweep_checkpoint_every,
                      on_checkpoint=self.on_sweep_checkpoint)
            self.resume_sweep_checkpoint = None   # consumed
        order, pred = self.task.machine_label_sweep(idx, self.cfg.l_metric,
                                                    **kw)
        return np.asarray(order, np.int64), np.asarray(pred, np.int64)

    # -- commit ----------------------------------------------------------------
    def commit(self) -> MCALResult:
        with self._mspan("commit"):
            return self._commit_impl()

    def _commit_impl(self) -> MCALResult:
        self._sync_fit()
        p = self.pool
        X = self.task.pool_size
        remaining = p.unlabeled_candidates()
        machine_mask = np.zeros(X, bool)

        if self.cfg.budget is not None and len(remaining):
            # afford as many residual human labels as the budget allows;
            # machine-label the most confident rest (accuracy is what gives)
            afford = max(self.cfg.budget - p.ledger.total, 0.0)
            n_human = min(
                int(afford / self._effective_service().price_per_label),
                len(remaining))
            m = len(remaining) - n_human
            order, pred = self._machine_label(remaining)
            S_idx = remaining[order[:m]]
            residual = remaining[order[m:]]
            if m:
                p.labels[S_idx] = pred[order[:m]]
                machine_mask[S_idx] = True
            p.buy_labels(self.task, residual, self.service)
            gt = oracle_labels(self.task, np.arange(X))
            return self._emit_commit(MCALResult(
                labels=p.labels.copy(), machine_mask=machine_mask,
                ledger=p.ledger.snapshot(), history=self.history,
                decision="budget", B_size=len(p.B_idx), S_size=int(m),
                theta_final=m / max(len(remaining), 1),
                measured_error=float(np.mean(p.labels != gt)),
                arch_name=self.task.arch_name))

        if self.decision == "human_all" or self.theta_opt <= 0.0 \
                or len(remaining) == 0:
            p.buy_labels(self.task, remaining, self.service)
            self.decision = "human_all"
            theta_final, S_size = 0.0, 0
        else:
            # measured (not predicted) feasibility at the final model
            stats_T, _ = self.task.score(p.T_idx)
            correct = self.task.eval_correct(p.T_idx, p.labels[p.T_idx])
            fine = np.linspace(0.01, 1.0, 100)
            curve = sel.machine_label_error_curve(
                stats_T, correct, fine, self.cfg.l_metric)
            S_frac = fine * len(remaining) / X
            # the human-labeled (1 - S/X) share carries the annotation
            # service's residual aggregated-label error; the machine slice
            # must fit in what is left of the target
            overall = S_frac * curve + \
                (1.0 - S_frac) * self._quality().residual_error
            ok = np.nonzero(overall <= self.cfg.eps_target)[0]
            theta_final = float(fine[ok[-1]]) if len(ok) else 0.0
            m = int(round(theta_final * len(remaining)))
            if m <= 0:
                p.buy_labels(self.task, remaining, self.service)
                self.decision = "human_all"
                theta_final, S_size = 0.0, 0
            else:
                order, pred = self._machine_label(remaining)
                S_idx = remaining[order[:m]]
                residual = remaining[order[m:]]
                p.labels[S_idx] = pred[order[:m]]
                machine_mask[S_idx] = True
                p.buy_labels(self.task, residual, self.service)
                S_size = m

        # the evaluation oracle, never human_label (see oracle_labels)
        gt = oracle_labels(self.task, np.arange(X))
        measured_error = float(np.mean(p.labels != gt))
        return self._emit_commit(MCALResult(
            labels=p.labels.copy(), machine_mask=machine_mask,
            ledger=p.ledger.snapshot(), history=self.history,
            decision=self.decision, B_size=len(p.B_idx), S_size=S_size,
            theta_final=theta_final, measured_error=measured_error,
            arch_name=self.task.arch_name))

    def _emit_commit(self, res: MCALResult) -> MCALResult:
        """The terminal decision event, flushed at once."""
        if self.trace is not None:
            self._emit("commit", **res.to_dict(with_history=False))
            self.trace.flush()
        return res

    def run(self) -> MCALResult:
        self.bootstrap()
        while not self.done:
            self.iteration()
        return self.commit()

    def close(self) -> None:
        """Cancel any in-flight async sweep or retrain and join the task's
        worker threads (idempotent; the results stay)."""
        self._drop_pending()
        if self._fit_pending is not None:
            self._fit_pending[1].cancel()
            self._fit_pending = None
        if hasattr(self.task, "close"):
            self.task.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- preemption ---------------------------------------------------------
    def state_dict(self) -> Dict:
        """JSON-serializable loop state at the reference's schema: a
        preempted campaign resumes mid-loop from it (the classifier is
        retrained from the persisted label set)."""
        self._sync_fit()
        p = self.pool
        fitted = None
        if self.train_sizes:
            fitted = _fitted_payload(*self._fit_models())
        state = {
            "version": STATE_VERSION,
            "fitted": fitted,
            "pack_keys": (self.task.pack_cache_keys()
                          if hasattr(self.task, "pack_cache_keys")
                          else None),
            "history": [r.to_dict() for r in self.history],
            "rng": self.rng.bit_generator.state,
            # the annotation service's state (None for perfect labels):
            # its request cursor, ledger and worker statistics — with the
            # persisted labels, what makes a resumed noisy campaign replay
            # its future requests bit-identically
            "annotation": (self.task.annotation.state_dict()
                           if getattr(self.task, "annotation", None)
                           is not None else None),
            "labels": p.labels.tolist(),
            "is_test": np.nonzero(p.is_test)[0].tolist(),
            "B_idx": p.B_idx.tolist(),
            "ledger": p.ledger.as_dict(),
            "eps_hist": {str(t): v for t, v in self.eps_hist.items()},
            "train_sizes": self.train_sizes,
            "train_costs": self.train_costs,
            "delta": self.delta,
            "cstar_old": self.cstar_old,
            "stable": self.stable,
            "own_training": self.own_training,
            "iter": self._iter,
            "done": bool(self.done),
            "decision": self.decision,
            "B_opt": int(self.B_opt),
            "theta_opt": float(self.theta_opt),
            "freeze_delta": bool(self.freeze_delta),
        }
        # the trace append cursor: flush first, so the persisted cursor
        # points inside the file
        if self.trace is not None:
            self._emit("state_save", iter=self._iter,
                       B_size=int(len(p.B_idx)))
            self.trace.flush()
            state["trace"] = {"next_seq": int(self.trace.next_seq)}
        else:
            state["trace"] = None
        return state

    def load_state_dict(self, s: Dict):
        v = int(s.get("version", 1))
        if v > STATE_VERSION:
            raise ValueError(
                f"campaign state has schema version {v}, but this build "
                f"understands at most version {STATE_VERSION}")
        # fold an in-flight async retrain first: it would race the resume
        # retrain below on the same engine buffers
        self._sync_fit()
        p = self.pool
        p.labels = np.asarray(s["labels"], np.int64)
        p.is_test[:] = False
        p.is_test[np.asarray(s["is_test"], np.int64)] = True
        p.T_idx = np.asarray(s["is_test"], np.int64)
        p.B_idx = np.asarray(s["B_idx"], np.int64)
        p.in_B[:] = False
        p.in_B[p.B_idx] = True
        p.ledger = CostLedger.from_dict(s["ledger"])
        if self.trace is not None:
            p.ledger.trace = self.trace
            p.ledger.trace_name = "campaign"
        ann = getattr(self.task, "annotation", None)
        if ann is not None and s.get("annotation") is not None:
            ann.load_state_dict(s["annotation"])
            if self.trace is not None and hasattr(ann, "attach_trace"):
                ann.attach_trace(self.trace)
        self.eps_hist = {float(t): [tuple(x) for x in v]
                         for t, v in s["eps_hist"].items()}
        self.train_sizes = list(s["train_sizes"])
        self.train_costs = list(s["train_costs"])
        self.delta = int(s["delta"])
        self.cstar_old = s["cstar_old"]
        self.stable = bool(s["stable"])
        self.own_training = float(s["own_training"])
        self._iter = int(s["iter"])
        self.done = bool(s.get("done", False))
        self.decision = str(s.get("decision", "hybrid"))
        self.B_opt = int(s.get("B_opt", 0))
        self.theta_opt = float(s.get("theta_opt", 0.0))
        self.freeze_delta = bool(s.get("freeze_delta", False))
        self.history = [IterationRecord.from_dict(r)
                        for r in s.get("history", [])]
        if "rng" in s:
            self.rng = np.random.default_rng()
            self.rng.bit_generator.state = s["rng"]
        self._pending = None
        self._fit_pending = None
        # the persisted fits go into the memo, so the first search() after
        # resume refits nothing
        self._fit_models_cache = None
        fitted = s.get("fitted")
        if fitted:
            laws = {float(t): PowerLaw(
                alpha=f["alpha"], gamma=f["gamma"],
                k=np.inf if f["k"] is None else f["k"],
                resid_std=f["resid_std"], n_points=int(f["n_points"]))
                for t, f in fitted["laws"].items()}
            cm = TrainCostModel(c_u=fitted["cost_model"]["c_u"],
                                exponent=int(fitted["cost_model"]["exponent"]))
            key = (len(self.train_sizes),
                   sum(len(v) for v in self.eps_hist.values()))
            self._fit_models_cache = (key, laws, cm)
        # retrain the classifier on the persisted label set (its cost was
        # paid before the checkpoint), then warm the engines' buckets
        self._anchor_feats = None
        self.task.train(p.B_idx, p.labels[p.B_idx])
        if hasattr(self.task, "prewarm_caches"):
            self.task.prewarm_caches(s.get("pack_keys"))
        if self.cfg.metric == "kcenter":
            self._anchor_features()
        # observability only: replay and diff skip it
        self._emit("resume", iter=self._iter, B_size=int(len(p.B_idx)))


def run_mcal(task, service: LabelingService,
             cfg: MCALConfig = MCALConfig(),
             trace: Optional[object] = None,
             metrics: Optional[object] = None,
             faults: Optional[object] = None,
             retry: Optional[object] = None,
             health: Optional[object] = None) -> MCALResult:
    camp = MCALCampaign(task, service, cfg)
    if trace is not None:
        camp.attach_trace(trace)
    if metrics is not None:
        camp.attach_metrics(metrics)
    if faults is not None:
        camp.attach_faults(faults, retry)
    if health is not None:
        # last: the engine inherits whatever trace/metrics are attached
        camp.attach_health(health)
    return camp.run()


def select_architecture(
    tasks: Dict[str, object], service: LabelingService,
    cfg: MCALConfig = MCALConfig(), max_explore_iters: int = 24,
) -> Tuple[str, MCALResult, Dict[str, List[IterationRecord]]]:
    """Paper §4: explore every candidate classifier over one shared pool
    with delta frozen at delta0, then continue the argmin-C* campaign
    alone.  Labels are bought once; every candidate pays its own training
    into the shared ledger (the exploration tax).  Returns ``(winner,
    result, {name: history})``."""
    names = list(tasks)
    pool = SharedPool(tasks[names[0]].pool_size)
    camps = {n: MCALCampaign(tasks[n], service, cfg, shared=pool)
             for n in names}
    for c in camps.values():
        c.freeze_delta = True       # exploration stays at delta0
    camps[names[0]].bootstrap()
    for n in names[1:]:
        camps[n].bootstrap(adopt=True)

    def argmin_cstar():
        cs = {n: camps[n].cstar_old if camps[n].cstar_old is not None
              else np.inf for n in names}
        return min(cs, key=cs.get)

    rounds, leader_votes, last_leader = 0, 0, None
    while rounds < max_explore_iters:
        # the leader rotates: its M(.) picks the next acquisition for all
        leader = camps[names[rounds % len(names)]]
        # elect early once the C* ranking is settled: every campaign has
        # its fit and the argmin is unchanged 3 rounds running
        if all(c.stable for c in camps.values()) or leader_votes >= 3:
            break
        pick = leader.propose_acquisition(leader.delta)
        for i, n in enumerate(names):
            # every campaign adopts the same acquisition; only the first
            # mutates B, the others retrain on the grown shared pool
            camps[n].iteration(acquire=(i == 0), forced_acquisition=pick)
            if i == 0:
                continue
            camps[n]._train_and_measure()
        for c in camps.values():
            # fold the async retrains (with fit_async every candidate's
            # ran at once) before the election reads the histories
            c._sync_fit()
        cur = argmin_cstar()
        enough = all(len(c.train_sizes) >= cfg.min_fit_points
                     for c in camps.values())
        leader_votes = leader_votes + 1 if (enough and cur == last_leader) \
            else 0
        last_leader = cur
        if any(c.done for c in camps.values()):
            break
        rounds += 1

    for c in camps.values():
        c._sync_fit()
    winner = argmin_cstar()
    wc = camps[winner]
    wc.freeze_delta = False
    wc.stable = False   # re-establish C* stability in the continuation
    while not wc.done:
        wc.iteration()
    result = wc.commit()
    return winner, result, {n: camps[n].history for n in names}
