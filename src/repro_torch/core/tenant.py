"""Multi-tenant fleet accounting: many campaigns, one budget envelope.

One :class:`Tenant` is one :class:`~repro_torch.core.mcal.MCALCampaign` plus
the fleet-facing state the orchestrator schedules it by: a priority, a
per-tenant budget allocation, its own trace, and the downgrade knobs the
:class:`FleetController` can turn when the FLEET (not the tenant)
overspends.

The controller rolls every tenant's campaign ledger into a fleet view
and enforces an optional hard global ceiling between scheduling rounds.
Over-ceiling relief is a criticality-ordered downgrade cascade — always
the same three passes, always walking tenants in ``(priority asc,
tenant_id asc)`` order, always stopping at the first state that fits
under the ceiling, so the same priority config produces the same
downgrade sequence every run (and the fleet trace replays it):

1. **pause** — the lowest-priority running tenants sit out the next
   scheduling round (acquisitions cost nothing while paused; pauses
   lift automatically at the next rebalance);
2. **shrink_votes** — tenants on a repeated-labeling policy get a
   halved-repeats, no-top-up session policy (future labels cost fewer
   priced votes; applied at most once per tenant);
3. **force_commit** — tenants are ended early (``done`` reason
   ``fleet_ceiling``), Pyrrhus-style: they commit with what they have.

Under-spenders subsidize over-askers first: surplus against per-tenant
allocations is pooled and granted in ``(priority desc, tenant_id asc)``
order before any downgrade runs, so a fleet that fits in aggregate
never downgrades anyone.

Everything the controller does is emitted into a FLEET trace (kinds
:data:`FLEET_KINDS` — a separate file from any tenant's decision
stream, which stays diffable against its solo-run sibling).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.mcal import MCALCampaign, MCALConfig

# the fleet controller's own event vocabulary (fleet trace, not any
# tenant's): pass to trace.replay.diff(kinds=FLEET_KINDS) to assert two
# fleet runs made identical budget decisions
FLEET_KINDS = frozenset({
    "fleet_begin", "fleet_round", "redistribute", "downgrade",
    "quarantine", "fleet_done",
})

# the cascade, in relief order (least to most destructive)
DOWNGRADE_ACTIONS = ("pause", "shrink_votes", "force_commit")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's fleet-facing contract.  ``priority`` orders the
    downgrade cascade (HIGHER survives longer); ``budget`` is this
    tenant's allocation inside the fleet envelope (None = uncapped, and
    the tenant neither contributes surplus nor receives grants)."""

    tenant_id: str
    priority: int = 0
    budget: Optional[float] = None
    seed: int = 0
    cfg: MCALConfig = MCALConfig()

    @classmethod
    def from_dict(cls, d: Dict) -> "TenantSpec":
        """The ``--tenants`` config-file form: MCALConfig fields ride in
        a nested ``cfg`` dict (unknown keys are rejected by the
        dataclass constructor, not silently dropped)."""
        cfg = MCALConfig(**d.get("cfg", {}))
        return cls(tenant_id=str(d["tenant_id"]),
                   priority=int(d.get("priority", 0)),
                   budget=(None if d.get("budget") is None
                           else float(d["budget"])),
                   seed=int(d.get("seed", 0)), cfg=cfg)


class Tenant:
    """One campaign inside a fleet: the campaign itself plus the
    scheduling/downgrade state the controller owns."""

    def __init__(self, spec: TenantSpec, campaign: MCALCampaign,
                 trace=None):
        self.spec = spec
        self.campaign = campaign
        self.trace = trace
        self.allocation = spec.budget       # moves under redistribution
        self.paused = False                 # one-round acquisition pause
        self.votes_shrunk = False           # shrink_votes applied
        self.forced = False                 # force_commit applied
        self.quarantined = False            # isolated after a fault
        self.quarantine_error = ""          # what ended it (for reports)
        self._shrink_ratio = 1.0            # projected label-price scale

    # -- identity ----------------------------------------------------------
    @property
    def tenant_id(self) -> str:
        return self.spec.tenant_id

    @property
    def priority(self) -> int:
        return self.spec.priority

    # -- fleet accounting --------------------------------------------------
    @property
    def spent(self) -> float:
        """This tenant's campaign-ledger total (the fleet roll-up sums
        exactly these — the service-side ledger is the same requests
        seen from the annotation endpoint, not extra money)."""
        return self.campaign.pool.ledger.total

    @property
    def done(self) -> bool:
        return self.campaign.done

    @property
    def running(self) -> bool:
        return not self.campaign.done

    def next_spend(self) -> float:
        """Projected cost of this tenant's NEXT scheduling round: delta
        labels at the effective (repeats-inclusive) price plus one
        retrain at the fitted per-iteration cost — the same projection
        the budget variant's stop rule uses, read from the memoized fit
        cache so projecting never emits a ``powerlaw_fit`` the solo run
        would not have."""
        c = self.campaign
        if c.done or self.paused:
            return 0.0
        delta = max(int(c.delta), 1)
        price = c._effective_service().price_per_label
        if self._shrink_ratio < 1.0:
            price *= self._shrink_ratio
        spend = delta * price
        cache = c._fit_models_cache
        if cache is not None:
            spend += float(cache[2].iteration_cost(
                len(c.pool.B_idx) + delta))
        return float(spend)

    # -- downgrade knobs (FleetController only) ----------------------------
    def apply_downgrade(self, action: str) -> bool:
        """Apply one cascade action; True iff it changed anything (the
        controller only emits — and only counts relief for — actions
        that actually landed)."""
        if not self.running:
            return False
        if action == "pause":
            if self.paused:
                return False
            self.paused = True
            return True
        if action == "shrink_votes":
            return self._shrink_votes()
        if action == "force_commit":
            if self.forced:
                return False
            self.forced = True
            self.campaign._drop_pending()
            self.campaign._finish("fleet_ceiling")
            return True
        raise ValueError(f"unknown downgrade action {action!r}")

    def _shrink_votes(self) -> bool:
        """Halve the tenant's repeated-labeling spend: swap the session
        policy for a ``max(1, repeats // 2)``-vote, no-top-up one.  Only
        meaningful for tenants on an :class:`AnnotationSession` with a
        multi-vote policy; applied at most once."""
        from repro_torch.annotation.service import RepeatPolicy
        if self.votes_shrunk:
            return False
        ann = getattr(self.campaign.task, "annotation", None)
        if ann is None or not hasattr(ann, "set_policy"):
            return False
        pol = ann.policy
        if pol.cap <= 1:
            return False
        shrunk = max(1, pol.repeats // 2)
        ann.set_policy(RepeatPolicy(repeats=shrunk,
                                    aggregator=pol.aggregator))
        self.votes_shrunk = True
        self._shrink_ratio = shrunk / float(pol.cap)
        return True

    def close(self) -> None:
        self.campaign.close()


class FleetController:
    """The between-rounds budget authority over a tenant fleet.

    ``rebalance`` is called at every scheduling-round boundary (by the
    orchestrator, in serial and concurrent modes alike — at the same
    points, so its decisions are mode-independent): lift last round's
    pauses, redistribute surplus, then — if the projected fleet spend
    still breaches the global ceiling — run the downgrade cascade.
    Pure function of the tenants' ledgers and the priority config; every
    decision emits into the fleet trace."""

    def __init__(self, tenants: List[Tenant],
                 global_budget: Optional[float] = None, trace=None, *,
                 health=None, slo_enforce: bool = False):
        ids = [t.tenant_id for t in tenants]
        assert len(set(ids)) == len(ids), f"duplicate tenant ids: {ids}"
        self.tenants = list(tenants)
        self.global_budget = global_budget
        self.trace = trace
        self.round = 0
        # streaming health engine (repro_torch.obs.health): ticked at every
        # rebalance boundary; with slo_enforce its ENFORCEABLE breach
        # verdicts drive the downgrade cascade (same walk order)
        self.health = health
        self.slo_enforce = bool(slo_enforce)
        self._slo_strikes: Dict[str, int] = {}
        if trace is not None:
            trace.emit("fleet_begin", ceiling=global_budget, tenants=[
                {"tenant_id": t.tenant_id, "priority": t.priority,
                 "budget": t.allocation} for t in self.tenants])

    def _emit(self, kind: str, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **payload)

    # -- the fleet ledger roll-up ------------------------------------------
    def spent(self) -> float:
        return sum(t.spent for t in self.tenants)

    def projected(self) -> float:
        return sum(t.spent + t.next_spend() for t in self.tenants)

    def ledger_snapshot(self) -> Dict:
        """Fleet roll-up + per-tenant balances (the ``--report`` fleet
        view and the ``fleet_done`` payload)."""
        per = {t.tenant_id: dict(t.campaign.pool.ledger.snapshot(),
                                 allocation=t.allocation,
                                 priority=t.priority, paused=t.paused,
                                 votes_shrunk=t.votes_shrunk,
                                 forced=t.forced, done=t.done)
               for t in self.tenants}
        return {"ceiling": self.global_budget, "total": self.spent(),
                "projected": self.projected(), "tenants": per}

    # -- cascade order ------------------------------------------------------
    def _cascade_order(self) -> List[Tenant]:
        """Least critical first: (priority asc, tenant_id asc) — ties
        break on the id, so the order is total and config-deterministic."""
        return sorted((t for t in self.tenants if t.running),
                      key=lambda t: (t.priority, t.tenant_id))

    # -- the round boundary -------------------------------------------------
    def rebalance(self) -> Dict:
        """One round boundary: lift pauses, redistribute, downgrade if
        the ceiling is still breached.  Returns the round summary (also
        emitted as ``fleet_round``)."""
        for t in self.tenants:
            t.paused = False            # pauses last exactly one round
        self._redistribute()
        downgrades = []
        if self.global_budget is not None:
            downgrades = self._cascade()
        if self.health is not None:
            verdicts = self.health.tick_fleet(self.tenants,
                                              tick=self.round)
            if self.slo_enforce and verdicts:
                downgrades = downgrades + self._enforce_slo(verdicts)
        summary = {"round": int(self.round), "spent": float(self.spent()),
                   "projected": float(self.projected()),
                   "ceiling": self.global_budget,
                   "downgrades": downgrades}
        self._emit("fleet_round", **summary)
        self.round += 1
        return summary

    def _redistribute(self) -> None:
        """Under-spenders' surplus flows to over-askers before anyone is
        downgraded.  Surplus/need are measured against the per-tenant
        allocations (uncapped tenants sit out both sides); grants land
        in (priority desc, tenant_id asc) order — the most critical
        over-asker is topped up first."""
        capped = [t for t in self.tenants if t.allocation is not None]
        surplus = 0.0
        for t in sorted(capped, key=lambda t: (t.priority, t.tenant_id)):
            # a finished tenant's leftover allocation is the canonical
            # surplus (its next_spend is 0, so the same formula covers it)
            free = t.allocation - (t.spent + t.next_spend())
            if free > 0.0:
                surplus += free
                t.allocation -= free
        if surplus <= 0.0:
            return
        takers = sorted((t for t in capped if t.running),
                        key=lambda t: (-t.priority, t.tenant_id))
        for t in takers:
            need = (t.spent + t.next_spend()) - t.allocation
            if need <= 0.0:
                continue
            grant = min(need, surplus)
            if grant <= 0.0:
                break
            t.allocation += grant
            surplus -= grant
            self._emit("redistribute", round=int(self.round),
                       tenant=t.tenant_id, amount=float(grant),
                       remaining_pool=float(surplus))

    def _cascade(self) -> List[Dict]:
        """The criticality-ordered downgrade cascade: three passes,
        least-destructive first, each walking tenants least-critical
        first and stopping the moment the projection fits under the
        ceiling.  Deterministic by construction — the walk order is a
        pure function of the priority config, and each step's projection
        depends only on the tenants' ledgers."""
        applied: List[Dict] = []
        for action in DOWNGRADE_ACTIONS:
            if self.projected() <= self.global_budget:
                break
            for t in self._cascade_order():
                if self.projected() <= self.global_budget:
                    break
                if t.apply_downgrade(action):
                    ev = {"round": int(self.round),
                          "tenant": t.tenant_id, "action": action,
                          "projected": float(self.projected()),
                          "ceiling": float(self.global_budget)}
                    applied.append(ev)
                    self._emit("downgrade", **ev)
        return applied

    def _enforce_slo(self, verdicts: List[Dict]) -> List[Dict]:
        """``--slo-enforce``: breach verdicts drive the downgrade
        cascade.  Only ENFORCEABLE clauses count (the deterministic
        ledger/fit-derived ones — wall-clock latency breaches alert but
        never downgrade).  Breaching tenants are walked in the same
        ``(priority asc, tenant_id asc)`` order as the budget cascade;
        each consecutive breached rebalance escalates one cascade step —
        pause first, then shrink_votes, then force_commit — so a breach
        that a round of sitting out (or cheaper votes) cures never costs
        the tenant its campaign.  Verdicts are pure functions of the
        tenants' ledgers and fits, so the walk (hence the ``downgrade``
        event stream) is deterministic."""
        breached: Dict[str, str] = {}
        for v in verdicts:
            if v.get("enforceable"):
                breached.setdefault(v["tenant"], v["slo"])
        applied: List[Dict] = []
        for t in self._cascade_order():
            if t.tenant_id not in breached:
                continue
            strike = self._slo_strikes.get(t.tenant_id, 0)
            self._slo_strikes[t.tenant_id] = strike + 1
            for action in DOWNGRADE_ACTIONS[min(strike,
                                                len(DOWNGRADE_ACTIONS)
                                                - 1):]:
                if t.apply_downgrade(action):
                    ev = {"round": int(self.round),
                          "tenant": t.tenant_id, "action": action,
                          "slo": breached[t.tenant_id],
                          "projected": float(self.projected()),
                          "ceiling": (float(self.global_budget)
                                      if self.global_budget is not None
                                      else None)}
                    applied.append(ev)
                    self._emit("downgrade", **ev)
                    break
        return applied

    def resolve_stall(self) -> None:
        """Every running tenant is paused and the ceiling still binds:
        waiting cannot help (nothing gets cheaper while paused), so the
        orchestrator ends the stall by forcing the remaining tenants to
        commit, least-critical first — the cascade's terminal action,
        applied fleet-wide, still fully deterministic and traced."""
        for t in self._cascade_order():
            if t.apply_downgrade("force_commit"):
                self._emit("downgrade", round=int(self.round),
                           tenant=t.tenant_id, action="force_commit",
                           projected=float(self.projected()),
                           ceiling=(float(self.global_budget)
                                    if self.global_budget is not None
                                    else None))

    def quarantine(self, tenant: Tenant, error: BaseException,
                   phase: str = "iteration") -> bool:
        """Isolate a tenant whose round died on a TERMINAL resilience
        fault (retries exhausted, straggler wall budget blown) instead
        of nuking the fleet: its campaign ends with ``done`` reason
        ``quarantined`` (pending async work dropped), its remaining
        allocation flows into the next ``rebalance``'s surplus walk
        (a done tenant projects ``next_spend() == 0``, so the existing
        redistribution picks the headroom up unchanged), and the
        decision is emitted as a fleet-trace ``quarantine`` event.
        Sibling tenants' decision streams stay diffable against their
        solo runs — quarantine only ever REMOVES a spender.  Returns
        True iff this call performed the isolation (idempotent)."""
        if tenant.quarantined:
            return False
        tenant.quarantined = True
        tenant.quarantine_error = f"{type(error).__name__}: {error}"
        c = tenant.campaign
        c._drop_pending()
        if getattr(c, "_fit_pending", None) is not None:
            c._fit_pending[1].cancel()
            c._fit_pending = None
        if not c.done:
            c._finish("quarantined")
        self._emit("quarantine", round=int(self.round),
                   tenant=tenant.tenant_id, phase=phase,
                   error=tenant.quarantine_error)
        return True

    def finish(self) -> Dict:
        """Terminal fleet event: the final roll-up, flushed."""
        snap = self.ledger_snapshot()
        self._emit("fleet_done", **snap)
        if self.trace is not None:
            self.trace.flush()
        return snap


def downgrade_sequence(trace_path: str) -> List[Dict]:
    """The cascade as executed, read back from a fleet trace: ordered
    ``{round, tenant, action}`` records — the determinism assertion
    ("same priority config => same downgrade order") compares exactly
    this across runs."""
    from repro_torch.trace.store import read_trace
    return [{"round": int(e.payload["round"]),
             "tenant": str(e.payload["tenant"]),
             "action": str(e.payload["action"])}
            for e in read_trace(trace_path) if e.kind == "downgrade"]
