"""Cost models: human labeling services + iterative training cost (Eqn. 4).

Training cost: with per-iteration cost proportional to the current training
set size (fixed epochs) and acquisitions of ``delta`` per iteration, total
cost from scratch to ``B`` is the paper's Eqn. 4::

    C_t(B, delta) = 1/2 * c_u * B * (B/delta + 1)

``c_u`` ($ per sample-iteration) is profiled on real hardware by timing the
train step (see :mod:`repro_torch.core.task`).  The cubic variant (epochs
proportional to size -> per-iteration cost ~ size^2) is exposed through
``exponent=2``; any exponent falls back to an explicit schedule sum.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LabelingService:
    """Per-request pricing of one annotation service.

    ``tiers`` is an optional marginal volume-discount schedule: sorted
    ``(min_requests, price)`` breakpoints — requests past ``min_requests``
    (cumulative, across the whole campaign) are priced at that tier's
    rate, like cloud-annotation volume pricing sheets.  ``cost(n, start)``
    integrates the schedule over the request interval
    ``[start, start + n)``, so tier boundaries are honored mid-batch.
    With repeated labeling every VOTE is one priced request —
    :meth:`CostLedger.pay_human` threads its cumulative request counter
    through ``start``.
    """

    name: str
    price_per_label: float  # $ per request at the base tier
    tiers: Optional[Tuple[Tuple[int, float], ...]] = None

    def __post_init__(self):
        if self.tiers:
            bounds = [int(b) for b, _ in self.tiers]
            assert bounds == sorted(bounds) and bounds[0] >= 0, \
                "tiers must be sorted (min_requests, price) breakpoints"

    def price_at(self, count: int) -> float:
        """Marginal $ price of request number ``count`` (0-based)."""
        price = self.price_per_label
        for bound, p in self.tiers or ():
            if count >= bound:
                price = p
            else:
                break
        return price

    def cost(self, n: int, start: int = 0) -> float:
        """$ for requests ``start .. start + n - 1`` (piecewise over the
        tier schedule; flat ``n * price_per_label`` without tiers)."""
        n = int(n)
        if n <= 0:
            return 0.0
        if not self.tiers:
            return float(n) * self.price_per_label
        start = int(start)
        end = start + n
        edges = [b for b, _ in self.tiers if start < b < end]
        total, lo = 0.0, start
        for edge in edges + [end]:
            total += (edge - lo) * self.price_at(lo)
            lo = edge
        return total

    def scaled(self, repeats: float) -> "LabelingService":
        """The effective per-LABEL service under an expected ``repeats``
        votes per label — what cost predictions (Eqn. 4's joint search)
        should price future human labels at.  Tier boundaries are kept in
        label units (flattened to the base rate: predictions stay simple
        and slightly conservative under volume discounts)."""
        if repeats == 1.0:
            return self
        return LabelingService(self.name,
                               self.price_per_label * float(repeats))


AMAZON = LabelingService("amazon", 0.04)
SATYAM = LabelingService("satyam", 0.003)
SERVICES = {s.name: s for s in (AMAZON, SATYAM)}


@dataclasses.dataclass(frozen=True)
class LabelQuality:
    """The economics of imperfect human labels (noisy annotation service).

    ``residual_error`` is the expected error rate of the AGGREGATED
    labels the service returns (majority / Dawid-Skene over ``repeats``
    noisy votes) — it eats into the campaign's accuracy target, since
    even a perfect classifier trained and measured on such labels cannot
    beat it.  ``avg_repeats`` is the expected priced votes per purchased
    label — future human labels in Eqn. 4's joint search must be priced
    repeats-inclusive or the (|B|, theta) optimum is computed against a
    fictional cheaper service.  ``AnnotationService.expected_quality()``
    derives both from the annotator pool's confusion matrices.
    """

    residual_error: float = 0.0
    avg_repeats: float = 1.0

    def effective_target(self, eps_target: float) -> float:
        """The machine-labeling error budget left after the aggregated
        human labels spend their share (conservative: the residual is
        charged on the whole pool)."""
        return max(eps_target - self.residual_error, 0.0)

    def effective_service(self, service: LabelingService) -> LabelingService:
        return service.scaled(self.avg_repeats)


def schedule_sizes(start: int, end: int, delta: int) -> np.ndarray:
    """Training-set sizes at each retrain when growing start -> end by delta."""
    if end <= start:
        return np.zeros((0,), np.int64)
    delta = max(int(delta), 1)
    return np.arange(start + delta, end + 1, delta, dtype=np.int64)


@dataclasses.dataclass
class TrainCostModel:
    """Per-iteration training cost = c_u * size^exponent."""

    c_u: float = 0.0
    exponent: int = 1

    def iteration_cost(self, size) -> np.ndarray:
        return self.c_u * np.asarray(size, np.float64) ** self.exponent

    def cost_from_scratch(self, B: float, delta: float) -> float:
        """Eqn. 4 closed form (exponent 1); schedule sum otherwise."""
        B = float(B)
        delta = max(float(delta), 1.0)
        if self.exponent == 1:
            return 0.5 * self.c_u * B * (B / delta + 1.0)
        sizes = schedule_sizes(0, int(round(B)), int(round(delta)))
        return float(np.sum(self.iteration_cost(sizes)))

    def cost_to_grow(self, start: float, end: float, delta: float) -> float:
        """Future training cost to grow an existing set start -> end."""
        if end <= start:
            return 0.0
        if self.exponent == 1:
            # sum over sizes start+delta, start+2delta, ..., end
            delta = max(float(delta), 1.0)
            m = int(np.ceil((end - start) / delta))
            sizes = np.minimum(start + delta * np.arange(1, m + 1), end)
            return float(self.c_u * np.sum(sizes))
        sizes = schedule_sizes(int(round(start)), int(round(end)),
                               int(round(delta)))
        return float(np.sum(self.iteration_cost(sizes)))

    def fit(self, sizes: Sequence[float], costs: Sequence[float]) -> "TrainCostModel":
        """Least-squares through the origin of cost vs size^exponent."""
        s = np.asarray(sizes, np.float64) ** self.exponent
        c = np.asarray(costs, np.float64)
        denom = float(np.dot(s, s))
        self.c_u = float(np.dot(s, c) / denom) if denom > 0 else 0.0
        return self


@dataclasses.dataclass
class CostLedger:
    """Running account of a labeling campaign.

    ``human_labels`` counts distinct items human-labeled;
    ``human_votes`` counts priced annotation REQUESTS — with repeated
    labeling (noisy multi-annotator oracles) one label costs several
    votes, and tier pricing is applied against the cumulative request
    count, so the ledger threads it through every charge.

    When a campaign trace is attached (``trace``/``trace_name``), every
    charge emits a ``charge`` event carrying the running balance — the
    ledger itself is the charging site, so nothing can spend without
    leaving an audit line.  The trace attachment is runtime wiring, not
    account state: ``as_dict``/``from_dict`` ignore it and a restored
    ledger must be re-attached by its owner.
    """

    human: float = 0.0
    training: float = 0.0
    human_labels: int = 0
    human_votes: int = 0
    trace: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    trace_name: str = dataclasses.field(
        default="campaign", repr=False, compare=False)

    def _emit_charge(self, what: str, **extra) -> None:
        if self.trace is not None:
            self.trace.emit("charge", ledger=self.trace_name, what=what,
                            human=self.human, training=self.training,
                            human_labels=self.human_labels,
                            human_votes=self.human_votes,
                            total=self.total, **extra)

    def pay_human(self, n: int, service: LabelingService, *,
                  repeats: int = 1, votes: Optional[int] = None) -> float:
        """Charge ``n`` freshly labeled items.  ``repeats`` (uniform) or
        ``votes`` (exact, e.g. under an adaptive-repeats policy) sets how
        many priced requests they took; ``n = 0`` charges nothing."""
        n = int(n)
        v = int(votes) if votes is not None else n * max(int(repeats), 1)
        if n <= 0 and v <= 0:
            return 0.0
        c = service.cost(v, start=self.human_votes)
        self.human += c
        self.human_labels += max(n, 0)
        self.human_votes += v
        self._emit_charge("human", n=max(n, 0), votes=v, cost=c)
        return c

    def pay_votes(self, v: int, service: LabelingService) -> float:
        """Charge ``v`` top-up annotation requests that buy no NEW labels
        (adaptive-repeats rounds re-asking about already-counted items)."""
        return self.pay_human(0, service, votes=v)

    def pay_training(self, c: float) -> float:
        self.training += c
        self._emit_charge("training", cost=float(c))
        return c

    @property
    def total(self) -> float:
        return self.human + self.training

    def as_dict(self) -> dict:
        """The persistable fields, round-trippable via :meth:`from_dict`
        (campaign ``state_dict`` embeds exactly this)."""
        return {"human": self.human, "training": self.training,
                "human_labels": self.human_labels,
                "human_votes": self.human_votes}

    @classmethod
    def from_dict(cls, d: dict) -> "CostLedger":
        return cls(human=float(d["human"]), training=float(d["training"]),
                   human_labels=int(d["human_labels"]),
                   # pre-annotation checkpoints priced one vote per label
                   human_votes=int(d.get("human_votes",
                                         d["human_labels"])))

    def snapshot(self) -> dict:
        return dict(self.as_dict(), total=self.total)
