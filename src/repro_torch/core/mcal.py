"""The MCAL campaign loop (paper Alg. 1), synchronous subset of
``repro.core.mcal``.

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

Every decision is the reference's, for perfect human labels.  Left out
for later slices: the trace, metrics, fault and health wiring, the
noisy-annotation economics (``label_quality``), the async sweep/fit
paths, ``state_dict`` resume and ``select_architecture`` (with the forced
acquisitions and frozen delta it drives).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import selection as sel
from repro_torch.core.cost import CostLedger, LabelingService, TrainCostModel
from repro_torch.core.powerlaw import PowerLaw, fit_power_law
from repro_torch.core.search import (SearchResult, adapt_delta, budget_search,
                                     joint_search)

DEFAULT_THETAS = tuple(round(0.05 * i, 2) for i in range(1, 21))


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
    budget: Optional[float] = None  # set -> budget-constrained variant


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


class SharedPool:
    """Label store: which rows are test/train and what each one cost."""

    def __init__(self, pool_size: int):
        self.pool_size = pool_size
        self.labels = np.full(pool_size, -1, np.int64)
        self.is_test = np.zeros(pool_size, bool)
        self.in_B = np.zeros(pool_size, bool)
        self.T_idx: Optional[np.ndarray] = None
        self.B_idx: np.ndarray = np.zeros((0,), np.int64)
        self.ledger = CostLedger()

    def buy_labels(self, task, idx: np.ndarray, service: LabelingService):
        """THE charging site: every purchased label pays through
        ``CostLedger.pay_human`` at the service's tier rates."""
        idx = np.asarray(idx, np.int64)
        fresh = idx[self.labels[idx] < 0]
        if len(fresh):
            self.labels[fresh] = task.human_label(fresh)
            self.ledger.pay_human(len(fresh), service, votes=len(fresh))

    def unlabeled_candidates(self) -> np.ndarray:
        mask = (~self.is_test) & (~self.in_B)
        return np.nonzero(mask)[0]


class MCALCampaign:
    def __init__(self, task, service: LabelingService, cfg: MCALConfig):
        self.task = task
        self.service = service
        self.cfg = cfg
        self.pool = SharedPool(task.pool_size)
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
        self.own_training = 0.0
        self.decision = "hybrid"
        self.B_opt = 0
        self.theta_opt = 0.0
        # k-center anchor cache: features of B under the CURRENT classifier
        # (invalidated every retrain)
        self._anchor_feats: Optional[np.ndarray] = None
        # memoized power-law/cost fits: (history key, laws, cost model)
        self._fit_models_cache: Optional[Tuple] = None
        self._iter = 0

    # -- bootstrap ----------------------------------------------------------
    def bootstrap(self):
        X = self.task.pool_size
        p = self.pool
        T_size = max(int(round(self.cfg.test_frac * X)), 16)
        p.T_idx = self.rng.choice(X, T_size, replace=False)
        p.is_test[p.T_idx] = True
        p.buy_labels(self.task, p.T_idx, self.service)
        delta0 = max(int(round(self.cfg.delta0_frac * X)), 8)
        b0 = self.rng.choice(p.unlabeled_candidates(), delta0, replace=False)
        p.in_B[b0] = True
        p.B_idx = b0
        p.buy_labels(self.task, b0, self.service)
        self.delta = len(p.B_idx)
        self._train_and_measure()

    # -- internals ----------------------------------------------------------
    def _train_and_measure(self):
        p = self.pool
        self._anchor_feats = None   # the representation moves every retrain
        nB = len(p.B_idx)
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

    def _fit_models(self) -> Tuple[Dict[float, PowerLaw], TrainCostModel]:
        """Fit the per-theta truncated power laws + the training-cost
        model, memoized on the measurement-history key."""
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
        return laws, cm

    def search(self) -> SearchResult:
        laws, cm = self._fit_models()
        p = self.pool
        kw = dict(pool_size=self.task.pool_size, test_size=len(p.T_idx),
                  current_B=len(p.B_idx), spent=self.own_training,
                  laws=laws, cost_model=cm, delta=self.delta,
                  service=self.service)
        if self.cfg.budget is not None:
            return budget_search(budget=self.cfg.budget, **kw)
        return joint_search(eps_target=self.cfg.eps_target, **kw)

    # -- one loop body --------------------------------------------------------
    def iteration(self):
        assert not self.done
        p = self.pool
        X = self.task.pool_size
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
            human_spent=p.ledger.human, training_spent=p.ledger.training)
        self.history.append(rec)
        self._iter += 1

        if self.cfg.budget is not None:
            # budget variant: stop training when the next acquisition would
            # break the budget (reserve the residual human labels' worth)
            next_spend = (self.delta * self.service.price_per_label +
                          self._fit_models()[1].iteration_cost(
                              len(p.B_idx) + self.delta))
            if p.ledger.total + float(next_spend) > self.cfg.budget:
                self._finish("budget")
                return rec
        else:
            # bail-out (paper §5.1 footnote): exploration tax exceeded while
            # the classifier still cannot machine-label any meaningful
            # fraction (ImageNet behaviour) -> human-label everything.
            human_all = X * self.service.price_per_label
            no_meaningful_S = (not res.feasible or res.theta_opt == 0.0 or
                               res.machine_labeled < self.cfg.bailout_min_s * X)
            if no_meaningful_S and \
                    p.ledger.training > self.cfg.bailout_frac * human_all:
                self.decision = "human_all"
                self._finish("bailout")
                return rec

        if self.stable:
            nd = adapt_delta(
                current_B=len(p.B_idx), B_opt=res.B_opt, cstar=res.cost,
                spent=self.own_training, pool_size=X, test_size=len(p.T_idx),
                machine_labeled=res.machine_labeled,
                cost_model=self._fit_models()[1],
                service=self.service, beta=self.cfg.beta)
            if nd > 0:
                self.delta = nd

        # Alg. 1 line 9: continue only while growing B is predicted to
        # reduce cost (C* < C(B_opt + delta) <=> B_opt > |B|), gated on the
        # fit having min_fit_points and a stable C*.
        enough = len(self.train_sizes) >= self.cfg.min_fit_points
        if enough and self.stable and res.feasible and \
                res.B_opt <= len(p.B_idx):
            self._finish("converged")
            return rec

        if self._iter >= self.cfg.max_iters:
            self._finish("max_iters")
            return rec

        self.acquire()
        return rec

    def acquire(self):
        """Buy delta labels ranked by M(.), retrain, re-measure."""
        p = self.pool
        cand = p.unlabeled_candidates()
        if len(cand) == 0:
            self._finish("pool_exhausted")
            return
        take = min(self.delta, len(cand))
        if self.stable and self.B_opt > len(p.B_idx):
            take = min(take, self.B_opt - len(p.B_idx))
        pick = self._rank_candidates(take, cand)
        p.buy_labels(self.task, pick, self.service)
        p.in_B[pick] = True
        p.B_idx = np.concatenate([p.B_idx, pick])
        self._train_and_measure()

    def _finish(self, reason: str):
        """End the loop, recording WHY (budget | bailout | converged |
        max_iters | pool_exhausted)."""
        self.done = True
        self.done_reason = reason

    def _anchor_features(self) -> Optional[np.ndarray]:
        """k-center anchor set: features of the human-labeled set B under
        the CURRENT classifier, cached per training round."""
        p = self.pool
        if len(p.B_idx) == 0:
            return None
        if self._anchor_feats is None:
            self._anchor_feats = self.task.anchor_features(p.B_idx)
        return self._anchor_feats

    def _rank_candidates(self, k: int, cand: np.ndarray) -> np.ndarray:
        """M(.): pick ``k`` of ``cand`` — the task's device top-k for the
        uncertainty metrics, its device k-center, or (``random``) the host
        reference path."""
        if k <= 0:
            return np.zeros((0,), np.int64)
        if self.cfg.metric in sel.UNCERTAINTY_METRICS:
            return self.task.topk_candidates(self.cfg.metric, k, cand)
        if self.cfg.metric == "kcenter":
            pick, _ = self.task.kcenter_candidates(
                k, cand, anchors=self._anchor_features())
            return pick
        return sel.select_for_training(self.cfg.metric, k, candidates=cand,
                                       rng=self.rng)

    def _machine_label(self, idx: np.ndarray):
        """L(.): one scoring pass over ``idx`` -> (rows most-confident-
        first, machine labels row-aligned with ``idx``)."""
        order, pred = self.task.machine_label_sweep(idx, self.cfg.l_metric)
        return np.asarray(order, np.int64), np.asarray(pred, np.int64)

    # -- commit ----------------------------------------------------------------
    def commit(self) -> MCALResult:
        p = self.pool
        X = self.task.pool_size
        remaining = p.unlabeled_candidates()
        machine_mask = np.zeros(X, bool)

        if self.cfg.budget is not None and len(remaining):
            # afford as many residual human labels as the budget allows;
            # machine-label the most confident rest (accuracy is what gives)
            afford = max(self.cfg.budget - p.ledger.total, 0.0)
            n_human = min(int(afford / self.service.price_per_label),
                          len(remaining))
            m = len(remaining) - n_human
            order, pred = self._machine_label(remaining)
            S_idx = remaining[order[:m]]
            residual = remaining[order[m:]]
            if m:
                p.labels[S_idx] = pred[order[:m]]
                machine_mask[S_idx] = True
            p.buy_labels(self.task, residual, self.service)
            gt = self.task.oracle_labels(np.arange(X))
            return MCALResult(
                labels=p.labels.copy(), machine_mask=machine_mask,
                ledger=p.ledger.snapshot(), history=self.history,
                decision="budget", B_size=len(p.B_idx), S_size=int(m),
                theta_final=m / max(len(remaining), 1),
                measured_error=float(np.mean(p.labels != gt)),
                arch_name=self.task.arch_name)

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
            ok = np.nonzero(S_frac * curve <= self.cfg.eps_target)[0]
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

        gt = self.task.oracle_labels(np.arange(X))
        measured_error = float(np.mean(p.labels != gt))
        return MCALResult(
            labels=p.labels.copy(), machine_mask=machine_mask,
            ledger=p.ledger.snapshot(), history=self.history,
            decision=self.decision, B_size=len(p.B_idx), S_size=S_size,
            theta_final=theta_final, measured_error=measured_error,
            arch_name=self.task.arch_name)

    def run(self) -> MCALResult:
        self.bootstrap()
        while not self.done:
            self.iteration()
        return self.commit()


def run_mcal(task, service: LabelingService,
             cfg: MCALConfig = MCALConfig()) -> MCALResult:
    return MCALCampaign(task, service, cfg).run()
