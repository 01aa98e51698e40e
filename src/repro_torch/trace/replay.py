"""Replay and first-divergence diff over campaign traces
(``repro.trace.replay``; :func:`replay` builds the port's own records).

Every emitter behind the trace is deterministic and checkpointable, so a
campaign's trace IS its trajectory: :func:`replay` reconstructs the full
run — iteration records, running ledger, decisions, the committed result
— from the event log alone, bit-identical to the live campaign's
``MCALResult`` and with ZERO engine recompute (no training, no scoring,
no annotation requests; the only work is JSON parsing).

Event kinds split into two classes:

* **decision events** (:data:`REPLAY_KINDS`) — the deterministic stream
  every sibling run of the same campaign policy must produce identically:
  config, bootstrap, every ledger charge, every measurement, every
  power-law fit, every joint-search outcome, every acquisition, every
  iteration record, the termination reason, and the commit.  Replay reads
  only these, and :func:`diff` compares only these — so a sync campaign
  and its ``--sweep-async``/``--fit-async`` sibling diff clean even
  though their raw streams interleave worker-thread events differently.
* **observability events** (:data:`OBSERVABILITY_KINDS`) — scheduling
  and quality telemetry (sweep cursor cuts, fit submit/fold timestamps,
  vote rounds and adaptive top-ups, annotator-quality snapshots, state
  saves, resumes).  ``launch/report.py`` renders these; replay and diff
  ignore them, because their count and interleaving legitimately vary
  with runtime mode and preemption.

:func:`diff` normalizes the one intentional sibling difference out of the
decision stream — ``campaign_begin``'s ``runtime`` block (the async
flags) — and returns the FIRST event where two traces disagree, with the
differing payload fields named.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.trace.store import TraceError, TraceEvent, read_trace

# the deterministic decision stream (replay input, diff domain)
REPLAY_KINDS = frozenset({
    "campaign_begin", "bootstrap", "charge", "measure", "powerlaw_fit",
    "search", "acquisition", "iteration", "done", "commit",
})

# telemetry: counts/interleavings vary with runtime mode and preemption
# (metric_span / metric_snapshot are the reference's repro.obs metrics stream — they
# interleave with the decision events but never enter replay or diff)
OBSERVABILITY_KINDS = frozenset({
    "state_save", "resume", "vote_round", "topup", "annotator_snapshot",
    "sweep_cut", "sweep_done", "fit_submit", "fit_done",
    "metric_span", "metric_snapshot",
    # the resilience layer's telemetry (repro.faults): injected faults,
    # retry re-issues, and fleet quarantine decisions ride the trace but
    # never enter replay/diff — a chaos run whose retries all succeed
    # diffs CLEAN against its fault-free sibling (the bench_faults /
    # test_faults acceptance invariant)
    "fault_injected", "retry", "quarantine", "autosave",
    # the health engine's judgment stream (repro.obs.health): raised /
    # cleared alerts and SLO breach verdicts are observations ABOUT the
    # decision stream, never part of it — a monitored campaign diffs
    # clean against its monitor-off sibling
    "alert", "alert_clear", "slo_breach",
})

ALL_KINDS = REPLAY_KINDS | OBSERVABILITY_KINDS


@dataclasses.dataclass
class ReplayedCampaign:
    """A campaign trajectory reconstructed from its trace alone.

    ``history`` holds live-equal ``IterationRecord`` objects, ``ledger``
    the final campaign ledger snapshot (with ``total``), ``result`` the
    committed ``MCALResult`` (None for a trace cut before commit —
    preempted or still running).  ``charges`` is the full charge stream
    (campaign AND service ledgers) for audit/burn-rate analysis.
    """

    campaign: str
    config: Dict
    runtime: Dict
    pool_size: int
    history: List                       # List[IterationRecord]
    ledger: Dict
    charges: List[Dict]
    decision: Optional[str]
    done_reason: Optional[str]
    result: Optional[object]            # MCALResult | None
    events: List[TraceEvent]

    @property
    def total_cost(self) -> float:
        return float(self.ledger.get("total", 0.0))

    @property
    def votes(self) -> int:
        return int(self.ledger.get("human_votes", 0))


def replay(path: str, *, campaign: Optional[str] = None
           ) -> ReplayedCampaign:
    """Reconstruct a campaign's trajectory from its trace — records,
    ledger, decisions, committed result — without touching a single
    engine.  Validates the trace structurally on the way: contiguous
    monotone sequence numbers and monotone-non-decreasing campaign
    ledger balances."""
    # lazy: core.mcal imports the store (a cycle at import time)
    from repro_torch.core.mcal import IterationRecord, MCALResult

    events = read_trace(path, campaign=campaign)
    if not events:
        raise TraceError(f"{path}: empty trace")
    for prev, e in zip(events, events[1:]):
        if e.seq != prev.seq + 1:
            raise TraceError(
                f"{path}: sequence gap {prev.seq} -> {e.seq} — the trace "
                f"was corrupted or mixes campaigns")

    config: Dict = {}
    runtime: Dict = {}
    pool_size = 0
    history: List = []
    charges: List[Dict] = []
    ledger: Dict = {"human": 0.0, "training": 0.0, "human_labels": 0,
                    "human_votes": 0, "total": 0.0}
    decision: Optional[str] = None
    done_reason: Optional[str] = None
    result = None

    for e in events:
        p = e.payload
        if e.kind == "campaign_begin":
            config = dict(p.get("config", {}))
            runtime = dict(p.get("runtime", {}))
            pool_size = int(p.get("pool_size", 0))
        elif e.kind == "charge":
            charges.append(dict(p, seq=e.seq, ts=e.ts))
            if p.get("ledger") == "campaign":
                if p["total"] < ledger["total"] - 1e-9:
                    raise TraceError(
                        f"{path}: campaign ledger regressed at seq "
                        f"{e.seq} (${ledger['total']:.4f} -> "
                        f"${p['total']:.4f})")
                ledger = {k: p[k] for k in ("human", "training",
                                            "human_labels", "human_votes",
                                            "total")}
        elif e.kind == "iteration":
            history.append(IterationRecord.from_dict(p))
        elif e.kind == "done":
            done_reason = str(p.get("reason", ""))
        elif e.kind == "commit":
            result = MCALResult.from_dict(dict(p, history=[]))
            result.history = history
            decision = result.decision
            ledger = dict(result.ledger)

    return ReplayedCampaign(
        campaign=events[0].campaign, config=config, runtime=runtime,
        pool_size=pool_size, history=history, ledger=ledger,
        charges=charges, decision=decision, done_reason=done_reason,
        result=result, events=events)


@dataclasses.dataclass
class TraceDiff:
    """The first divergence between two traces' decision streams.
    ``index`` counts FILTERED events (position in the compared streams);
    ``fields`` names the differing payload keys when the kinds agree.
    A kind of ``"<end>"`` means that trace ran out of events first."""

    index: int
    kind_a: str
    kind_b: str
    seq_a: int
    seq_b: int
    payload_a: Dict
    payload_b: Dict
    fields: List[str]

    def describe(self) -> str:
        if "<end>" in (self.kind_a, self.kind_b):
            short, tail = (("a", self.kind_b) if self.kind_a == "<end>"
                           else ("b", self.kind_a))
            return (f"traces diverge at event #{self.index}: trace "
                    f"{short} ends, the other continues with {tail!r}")
        if self.kind_a != self.kind_b:
            return (f"traces diverge at event #{self.index}: "
                    f"{self.kind_a!r} (seq {self.seq_a}) vs "
                    f"{self.kind_b!r} (seq {self.seq_b})")
        return (f"traces diverge at event #{self.index} "
                f"({self.kind_a!r}, seq {self.seq_a}/{self.seq_b}): "
                f"fields {', '.join(self.fields)}")


def _normalized(e: TraceEvent):
    payload = dict(e.payload)
    if e.kind == "campaign_begin":
        # the one intentional sibling difference: sync vs async execution
        # mode changes scheduling, provably not decisions — normalize it
        # out so --sweep-async/--fit-async siblings diff clean
        payload.pop("runtime", None)
    return e.kind, payload


def diff(path_a: str, path_b: str, *,
         kinds: Sequence[str] = REPLAY_KINDS) -> Optional[TraceDiff]:
    """First divergence between two traces' ``kinds``-filtered streams
    (None when they agree).  Wall-clock timestamps, sequence numbers,
    campaign ids, and observability events never count as divergence —
    only decision kinds and payloads do."""
    kinds = frozenset(kinds)
    ev_a = [e for e in read_trace(path_a) if e.kind in kinds]
    ev_b = [e for e in read_trace(path_b) if e.kind in kinds]
    for i, (a, b) in enumerate(zip(ev_a, ev_b)):
        ka, pa = _normalized(a)
        kb, pb = _normalized(b)
        if ka == kb and pa == pb:
            continue
        fields = (sorted(k for k in set(pa) | set(pb)
                         if pa.get(k) != pb.get(k)) if ka == kb else [])
        return TraceDiff(index=i, kind_a=ka, kind_b=kb, seq_a=a.seq,
                         seq_b=b.seq, payload_a=pa, payload_b=pb,
                         fields=fields)
    if len(ev_a) != len(ev_b):
        i = min(len(ev_a), len(ev_b))
        a = ev_a[i] if i < len(ev_a) else None
        b = ev_b[i] if i < len(ev_b) else None
        return TraceDiff(
            index=i,
            kind_a=a.kind if a else "<end>", kind_b=b.kind if b else "<end>",
            seq_a=a.seq if a else -1, seq_b=b.seq if b else -1,
            payload_a=dict(a.payload) if a else {},
            payload_b=dict(b.payload) if b else {}, fields=[])
    return None
