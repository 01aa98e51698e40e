# Declarative SLO specs + breach evaluation.  Framework-free: the health
# engine and report tooling import this without touching the engines.
"""Service-level objectives for a labeling campaign.

An SLO spec is a small declarative JSON document::

    {"cost_per_label_max": 0.15,
     "iteration_p95_max": 30.0,
     "projected_quality_min": 0.80}

Three clauses, all optional (``null``/absent = not contracted):

* ``cost_per_label_max`` — ceiling on committed campaign spend per
  committed human label (``ledger.total / ledger.human_labels``), the
  paper's own objective read as a running invariant: MCAL exists to keep
  this number below the human-only baseline.
* ``iteration_p95_max`` — ceiling on the iteration-latency p95 in
  seconds, read from the metrics registry's ``span_seconds{name=
  "iteration"}`` histogram.  Wall-clock, hence **advisory**: it
  alerts but is never enforced (see below).
* ``projected_quality_min`` — floor on the projected achievable quality
  ``1 - (predicted machine-label error at the planned operating point)
  - (assumed annotator residual)``, read from the campaign's memoized
  power-law fits — the search's own forecast, judged continuously.

**Determinism contract.**  Breach verdicts for the cost and quality
clauses are pure functions of the campaign ledger and the measurement
history, so two identical runs produce identical verdict sequences at
every :meth:`~repro_torch.core.tenant.FleetController.rebalance` boundary —
which is why ``--slo-enforce`` may drive the downgrade cascade off
them.  The latency clause reads wall-clock histograms; its verdicts
carry ``enforceable: False`` and the controller never acts on them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

__all__ = ["SLOSpec", "evaluate_slo", "SLO_CLAUSES"]

# evaluation (and therefore event-stream) order is fixed: verdict
# sequences must not depend on dict iteration order
SLO_CLAUSES = ("cost_per_label", "iteration_p95", "projected_quality")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One campaign's (or fleet's) service-level contract.  ``None``
    clauses are simply not evaluated."""

    cost_per_label_max: Optional[float] = None
    iteration_p95_max: Optional[float] = None
    projected_quality_min: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "SLOSpec":
        """Strict load: unknown keys are rejected, not silently dropped
        (a typoed clause name must not read as 'no contract')."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(d) - known)
        if extra:
            raise ValueError(
                f"unknown SLO clause(s) {extra}; known: {sorted(known)}")
        kw = {k: (None if v is None else float(v)) for k, v in d.items()}
        for k, v in kw.items():
            if v is not None and v <= 0.0:
                raise ValueError(f"SLO clause {k} must be positive "
                                 f"(got {v!r})")
        return cls(**kw)

    @classmethod
    def load(cls, path: str) -> "SLOSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def clauses(self) -> List[str]:
        """The contracted clause names, in evaluation order."""
        out = []
        if self.cost_per_label_max is not None:
            out.append("cost_per_label")
        if self.iteration_p95_max is not None:
            out.append("iteration_p95")
        if self.projected_quality_min is not None:
            out.append("projected_quality")
        return out


def evaluate_slo(spec: Optional[SLOSpec], obs: Dict) -> List[Dict]:
    """Judge one observation against the spec.

    ``obs`` is a plain dict (assembled by the health engine) with keys
    ``tenant`` plus the measured clause inputs ``cost_per_label``,
    ``iteration_p95``, ``projected_quality`` — any of them ``None``
    when not yet measurable (no labels committed, no fits, metrics
    off), in which case that clause is skipped rather than breached.

    Returns breach verdicts in fixed clause order::

        {"tenant", "slo", "value", "limit", "enforceable"}
    """
    if spec is None:
        return []
    tenant = str(obs.get("tenant", ""))
    out: List[Dict] = []

    def breach(name: str, value, limit, *, enforceable: bool) -> None:
        out.append({"tenant": tenant, "slo": name, "value": float(value),
                    "limit": float(limit), "enforceable": bool(enforceable)})

    v = obs.get("cost_per_label")
    if spec.cost_per_label_max is not None and v is not None \
            and v > spec.cost_per_label_max:
        breach("cost_per_label", v, spec.cost_per_label_max,
               enforceable=True)
    v = obs.get("iteration_p95")
    if spec.iteration_p95_max is not None and v is not None \
            and v > spec.iteration_p95_max:
        breach("iteration_p95", v, spec.iteration_p95_max,
               enforceable=False)      # wall-clock: advisory only
    v = obs.get("projected_quality")
    if spec.projected_quality_min is not None and v is not None \
            and v < spec.projected_quality_min:
        breach("projected_quality", v, spec.projected_quality_min,
               enforceable=True)
    return out
