# Streaming health engine.  Framework-free: consumes the metrics registry and
# campaign/tenant state the transports already expose; emits judgment.
"""Campaign health: detectors, hysteresis-gated alerts, SLO verdicts.

Two PRs' worth of telemetry (the trace event bus, the metrics registry)
record what a campaign *did*; this module is the layer that *judges* it
while it runs.  A :class:`HealthEngine` ticks at the natural decision
boundaries — every ``MCALCampaign.iteration()`` for a solo run, every
``FleetController.rebalance()`` for a fleet — samples the campaign(s)
and the registry, runs the detector suite, and emits deduplicated,
hysteresis-gated ``alert`` / ``alert_clear`` / ``slo_breach`` events
into whatever trace it is attached to.  All three kinds are
``OBSERVABILITY_KINDS``: replay and diff ignore them, so a monitored
campaign's decision stream stays byte-identical to its monitor-off
sibling's.

Detector suite (each skipped silently when its input is not measurable):

* ``budget_burn`` — per-round burn projected against the tenant's
  allocation (fleet) or ``cfg.budget`` (solo): fires when the projected
  rounds-to-exhaustion drops inside ``burn_horizon`` (payload carries
  the ETA), escalating to ``critical`` once the next round would blow
  it.
* ``annotator_drift`` — the annotation service's running residual-error
  estimate vs the :class:`~repro_torch.core.cost.LabelQuality` residual the
  joint search assumed: fires when reality is worse than the
  calibration by more than ``drift_tol`` (the Liao et al. concern —
  the search is optimizing against a stale quality model).
* ``fit_quality`` — power-law fit degradation: the worst log-space
  residual std among fits with enough points exceeds ``fit_resid_max``
  (the C*-vs-iteration machinery is extrapolating from a curve that no
  longer fits its own history).
* ``cache_storm`` — compile-cache miss storm: per-tick
  ``pack_cache_misses_total`` delta at least ``cache_miss_burst`` and
  outpacing hits (fresh buckets are eating the shared engines' reuse).
* ``queue_saturation`` — any broker ``queue_depth`` gauge above
  ``queue_depth_max``.
* ``fault_pressure`` — the resilience counters: any straggler
  timeout or quarantine this tick, or a retries+faults burst at least
  ``fault_burst``.

**Hysteresis + dedup.**  Each ``(tenant, detector)`` pair is a tiny
state machine: ``up_ticks`` consecutive breaching samples raise ONE
``alert``; while it is firing, further breaches emit nothing; only
``down_ticks`` consecutive healthy samples clear it (one
``alert_clear``).  A metric flapping across its threshold therefore
produces one alert and one clear, not an event per flap.

**Determinism.**  Ticks are counted, not timed.  The ledger/fit-derived
detectors and the enforceable SLO clauses are pure functions of the
decision state, so two identical runs emit byte-equal alert sequences
(:func:`alert_sequence` extracts exactly the comparable fields).  The
registry-derived detectors (cache/queue/fault) and the latency clause
read runtime telemetry and may legitimately differ across modes; they
alert but never drive enforcement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.export import queue_stats, snapshot_counter
from repro_torch.obs.slo import SLOSpec, evaluate_slo

__all__ = ["ALERT_KINDS", "HealthConfig", "HealthEngine",
           "alert_sequence", "hist_quantile"]

# the health engine's event vocabulary — classified OBSERVABILITY_KINDS
# in repro_torch.trace.replay, so replay/diff never see them
ALERT_KINDS = frozenset({"alert", "alert_clear", "slo_breach"})

# detector severities (budget_burn escalates to critical on imminence)
_SEVERITY = {
    "budget_burn": "warn", "annotator_drift": "warn",
    "fit_quality": "warn", "cache_storm": "warn",
    "queue_saturation": "warn", "fault_pressure": "critical",
}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds + hysteresis widths.  Defaults raise fast
    (one breaching tick) and clear slow (two healthy ticks) — the
    classic anti-flap asymmetry."""

    up_ticks: int = 1           # consecutive breaches to raise
    down_ticks: int = 2         # consecutive healthy ticks to clear
    burn_horizon: float = 3.0   # alert when exhaustion is <= N rounds out
    drift_tol: float = 0.05     # residual-error drift tolerance (abs)
    fit_resid_max: float = 0.35  # log-space residual-std ceiling
    fit_min_points: int = 3     # fits with fewer points are not judged
    cache_miss_burst: float = 8.0   # per-tick compile misses = a storm
    queue_depth_max: float = 64.0
    fault_burst: float = 4.0    # per-tick faults+retries


class _AlertState:
    """One (tenant, detector) hysteresis cell."""

    __slots__ = ("firing", "breaches", "oks")

    def __init__(self):
        self.firing = False
        self.breaches = 0
        self.oks = 0


class HealthEngine:
    """The streaming judge.  Attach a trace (alert events ride it) and
    optionally a metrics registry (both an input — counters, span
    histograms — and an output: ``health_alerts_total``).  ``slo`` is an
    optional :class:`~repro_torch.obs.slo.SLOSpec`; without one the detector
    suite still runs."""

    def __init__(self, slo: Optional[SLOSpec] = None,
                 config: Optional[HealthConfig] = None, *,
                 trace=None, metrics=None):
        self.slo = slo
        self.config = config or HealthConfig()
        self.trace = trace
        self.metrics = metrics
        self.tick = 0
        self._state: Dict[Tuple[str, str], _AlertState] = {}
        self._last_spent: Dict[str, float] = {}
        self._last_counters: Optional[Dict[str, float]] = None
        self.alerts_raised = 0
        self.alerts_cleared = 0
        self.breaches = 0

    # -- wiring -------------------------------------------------------------
    def attach_trace(self, trace) -> None:
        self.trace = trace

    def attach_metrics(self, metrics) -> None:
        self.metrics = metrics

    def _emit(self, kind: str, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **payload)

    # -- sampling -----------------------------------------------------------
    def observe_campaign(self, campaign, tenant: str = "",
                         budget: Optional[float] = None) -> Dict:
        """One deterministic sample of a campaign's decision state —
        everything the ledger/fit detectors and the enforceable SLO
        clauses read.  ``budget`` overrides ``cfg.budget`` (the fleet
        passes the tenant's live allocation).  Duck-typed reads only:
        no engine, no device work, and crucially no fit is ever FORCED
        (the memoized fit cache is read as-is, the
        ``Tenant.next_spend`` rule)."""
        led = campaign.pool.ledger.snapshot()
        cfg = campaign.cfg
        quality = getattr(cfg, "label_quality", None)
        assumed = float(quality.residual_error) if quality is not None \
            else 0.0
        ann = getattr(campaign.task, "annotation", None)
        observed = None
        if ann is not None and hasattr(ann, "estimated_residual_error"):
            observed = float(ann.estimated_residual_error())
        fit_resid = None
        projected_quality = None
        cache = getattr(campaign, "_fit_models_cache", None)
        if cache is not None:
            laws = cache[1]
            resids = [law.resid_std for law in laws.values()
                      if law.n_points >= self.config.fit_min_points]
            if resids:
                fit_resid = float(max(resids))
            theta = getattr(campaign, "theta_opt", None)
            b_opt = getattr(campaign, "B_opt", None)
            if theta is not None and b_opt is not None \
                    and theta in laws:
                eps = float(laws[theta].predict(int(b_opt)))
                projected_quality = 1.0 - eps - assumed
        labels = int(led.get("human_labels", 0))
        spent = float(led.get("total", 0.0))
        return {
            "tenant": str(tenant),
            "spent": spent,
            "labels": labels,
            "cost_per_label": (spent / labels) if labels > 0 else None,
            "budget": (float(budget) if budget is not None
                       else getattr(cfg, "budget", None)),
            "done": bool(campaign.done),
            "assumed_residual": assumed,
            "observed_residual": observed,
            "fit_resid": fit_resid,
            "projected_quality": projected_quality,
            "iteration_p95": self._iteration_p95(tenant),
        }

    def _iteration_p95(self, tenant: str) -> Optional[float]:
        """Iteration-latency p95 from the registry's span histogram
        (None with metrics off — the latency clause simply never
        fires)."""
        if self.metrics is None:
            return None
        for h in self.metrics.snapshot().get("histograms", ()):
            if h["name"] != "span_seconds":
                continue
            labels = h.get("labels", {})
            if labels.get("name") != "iteration":
                continue
            if tenant and labels.get("tenant", "") not in ("", tenant):
                continue
            return hist_quantile(h, 0.95)
        return None

    def _registry_sample(self) -> Optional[Dict]:
        """The fleet-scope telemetry sample (tenant ``""``): registry
        counter totals + queue gauges.  None with metrics off."""
        if self.metrics is None:
            return None
        snap = self.metrics.snapshot()
        counters = {name: snapshot_counter(snap, name) for name in (
            "pack_cache_hits_total", "pack_cache_misses_total",
            "retries_total", "faults_injected_total",
            "straggler_timeouts_total", "tenants_quarantined_total")}
        return {"tenant": "", "counters": counters,
                "queues": queue_stats(snap)}

    # -- the tick boundaries ------------------------------------------------
    def tick_campaign(self, campaign, tenant: str = "") -> List[Dict]:
        """Solo boundary: one campaign, one sample, plus the registry
        scope.  Returns the current SLO breach verdicts."""
        self.tick += 1
        verdicts = self._judge(self.observe_campaign(campaign,
                                                     tenant=tenant))
        self._judge_registry()
        return verdicts

    def tick_fleet(self, tenants: Iterable, tick: Optional[int] = None
                   ) -> List[Dict]:
        """Fleet boundary (``FleetController.rebalance``): sample every
        tenant in ``tenant_id`` order (a total, config-independent
        order — the event stream must not depend on construction
        order), then the registry scope.  Returns the current breach
        verdicts for ALL tenants, the list ``--slo-enforce`` walks."""
        self.tick = self.tick + 1 if tick is None else int(tick)
        verdicts: List[Dict] = []
        for t in sorted(tenants, key=lambda t: t.tenant_id):
            verdicts.extend(self._judge(self.observe_campaign(
                t.campaign, tenant=t.tenant_id, budget=t.allocation)))
        self._judge_registry()
        return verdicts

    def tick_samples(self, samples: Iterable[Dict]) -> List[Dict]:
        """Drive the engine from pre-built samples (tests, simulation,
        offline re-judgment of a recorded run)."""
        self.tick += 1
        verdicts: List[Dict] = []
        for s in samples:
            if "counters" in s or "queues" in s:
                self._judge_telemetry(s)
            else:
                verdicts.extend(self._judge(s))
        return verdicts

    # -- detectors ----------------------------------------------------------
    def _judge(self, s: Dict) -> List[Dict]:
        """Run the per-tenant detectors + SLO clauses over one sample,
        advancing the hysteresis cells.  Detector order is fixed."""
        tenant = s["tenant"]
        self._detect_burn(s)
        self._detect_drift(s)
        self._detect_fit(s)
        verdicts = evaluate_slo(self.slo, s)
        breached = {v["slo"]: v for v in verdicts}
        for clause in (self.slo.clauses() if self.slo is not None else ()):
            v = breached.get(clause)
            self._step(tenant, f"slo:{clause}", v is not None,
                       kind="slo_breach",
                       payload=(dict(v) if v is not None else None))
        return verdicts

    def _detect_burn(self, s: Dict) -> None:
        budget, spent = s.get("budget"), s["spent"]
        if budget is None or s["done"]:
            # no allocation to burn against (or nothing left to spend):
            # leave the cell untouched rather than count a healthy tick
            return
        tenant = s["tenant"]
        burn = spent - self._last_spent.get(tenant, 0.0)
        self._last_spent[tenant] = spent
        remaining = budget - spent
        if remaining <= 0.0:
            eta = 0.0
        elif burn > 0.0:
            eta = remaining / burn
        else:
            eta = float("inf")
        firing = eta <= self.config.burn_horizon
        self._step(tenant, "budget_burn", firing, payload={
            "spent": spent, "budget": float(budget),
            "burn_per_round": burn,
            "eta_rounds": (None if eta == float("inf") else eta),
            "severity": ("critical" if eta <= 1.0 else "warn")})

    def _detect_drift(self, s: Dict) -> None:
        observed = s.get("observed_residual")
        if observed is None:
            return
        drift = observed - s["assumed_residual"]
        self._step(s["tenant"], "annotator_drift",
                   drift > self.config.drift_tol, payload={
                       "assumed": s["assumed_residual"],
                       "observed": observed, "drift": drift})

    def _detect_fit(self, s: Dict) -> None:
        resid = s.get("fit_resid")
        if resid is None:
            return
        self._step(s["tenant"], "fit_quality",
                   resid > self.config.fit_resid_max, payload={
                       "resid_std": resid,
                       "ceiling": self.config.fit_resid_max})

    def _judge_registry(self) -> None:
        s = self._registry_sample()
        if s is not None:
            self._judge_telemetry(s)

    def _judge_telemetry(self, s: Dict) -> None:
        """The registry-scope detectors: counter deltas + queue gauges.
        The first sample only establishes the delta baseline — startup
        compiles are expected, not a storm."""
        counters = s.get("counters", {})
        queues = s.get("queues", {})
        last, self._last_counters = self._last_counters, dict(counters)
        if last is not None:
            d = {k: counters.get(k, 0.0) - last.get(k, 0.0)
                 for k in counters}
            misses = d.get("pack_cache_misses_total", 0.0)
            hits = d.get("pack_cache_hits_total", 0.0)
            self._step("", "cache_storm",
                       misses >= self.config.cache_miss_burst
                       and misses > hits,
                       payload={"misses": misses, "hits": hits})
            hard = (d.get("straggler_timeouts_total", 0.0)
                    + d.get("tenants_quarantined_total", 0.0))
            soft = (d.get("retries_total", 0.0)
                    + d.get("faults_injected_total", 0.0))
            self._step("", "fault_pressure",
                       hard >= 1.0 or soft >= self.config.fault_burst,
                       payload={"stragglers_or_quarantines": hard,
                                "faults_and_retries": soft})
        depth = max((st.get("depth", 0.0) for st in queues.values()),
                    default=0.0)
        self._step("", "queue_saturation",
                   depth > self.config.queue_depth_max,
                   payload={"depth": depth, "queues": sorted(queues)})

    # -- the hysteresis/dedup cell ------------------------------------------
    def _step(self, tenant: str, detector: str, firing: bool, *,
              payload: Optional[Dict] = None, kind: str = "alert") -> None:
        cell = self._state.setdefault((tenant, detector), _AlertState())
        if firing:
            cell.breaches += 1
            cell.oks = 0
            if not cell.firing and cell.breaches >= self.config.up_ticks:
                cell.firing = True
                self.alerts_raised += 1
                if kind == "slo_breach":
                    self.breaches += 1
                body = dict(payload or {})
                for k in ("tick", "tenant", "detector"):
                    body.pop(k, None)   # envelope fields win
                body.setdefault("severity",
                                _SEVERITY.get(detector, "warn"))
                self._emit(kind, tick=self.tick, tenant=tenant,
                           detector=detector, **body)
                if self.metrics is not None:
                    self.metrics.inc("health_alerts_total",
                                     detector=detector)
        else:
            cell.oks += 1
            cell.breaches = 0
            if cell.firing and cell.oks >= self.config.down_ticks:
                cell.firing = False
                self.alerts_cleared += 1
                self._emit("alert_clear", tick=self.tick, tenant=tenant,
                           detector=detector)

    # -- introspection ------------------------------------------------------
    def active(self) -> List[Tuple[str, str]]:
        """Currently firing (tenant, detector) pairs, sorted."""
        return sorted(k for k, c in self._state.items() if c.firing)

    def counts(self) -> Dict:
        return {"ticks": int(self.tick),
                "alerts_raised": int(self.alerts_raised),
                "alerts_cleared": int(self.alerts_cleared),
                "slo_breaches": int(self.breaches),
                "active": ["/".join(filter(None, k)) or k[1]
                           for k in self.active()]}


def hist_quantile(h: Dict, q: float) -> Optional[float]:
    """Approximate quantile from a snapshot histogram dict (upper bucket
    bound at the first cumulative count crossing ``q``; the recorded max
    for the overflow bucket).  None for an empty histogram."""
    total = int(h.get("count", 0))
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for bound, count in zip(h["buckets"], h["counts"]):
        cum += int(count)
        if cum >= target:
            return float(bound)
    return float(h["max"]) if h.get("max") is not None else None


def alert_sequence(trace_path: str) -> List[Dict]:
    """The judgment stream as executed, read back from a trace: ordered
    ``{tick, tenant, detector, state}`` records (``state`` is ``raise``,
    ``clear``, or ``breach``).  The determinism assertion — same run,
    same judgments — compares exactly this across sibling runs (wall
    timestamps and payload telemetry excluded by construction)."""
    from repro_torch.trace.store import read_trace
    state = {"alert": "raise", "alert_clear": "clear",
             "slo_breach": "breach"}
    return [{"tick": int(e.payload.get("tick", -1)),
             "tenant": str(e.payload.get("tenant", "")),
             "detector": str(e.payload.get("detector", "")),
             "state": state[e.kind]}
            for e in read_trace(trace_path) if e.kind in ALERT_KINDS]
