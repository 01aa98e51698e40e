"""Live campaign observability from the trace alone.

Renders a running (or finished) campaign's cost-vs-iteration curve,
ledger burn rate, and annotator quality drift straight from its trace
file — including one that is still being written (``read_trace``
tolerates the mid-write truncated final line), so an operator can watch
a campaign without touching the process driving it:

    PYTHONPATH=src python -m repro_torch.launch.report TRACE.jsonl
    PYTHONPATH=src python -m repro_torch.launch.report TRACE.jsonl --watch 5
    PYTHONPATH=src python -m repro_torch.launch.report TRACE.jsonl --json

The positional path may also be a fleet TRACE DIR (the orchestrator's
``--trace-dir``): every tenant trace renders, plus the fleet's
``metrics.jsonl`` when present.  ``--metrics`` adds the runtime panel
(per-engine time breakdown, compile-cache hit rates, queue depths,
burn rate vs throughput) from the ``metric_span``/``metric_snapshot``
events — recorded telemetry only, nothing is recomputed.  ``--health``
adds the judgment panel (active alerts, SLO breaches, recent
``alert``/``alert_clear``/``slo_breach`` events; in a fleet dir the
stream rides ``fleet.jsonl``) — combined with ``--watch`` it is a live
alert panel.

Everything here reads events only — no torch, no engines, no recompute
(:func:`summarize` imports nothing heavier than the trace store and
the framework-free ``repro_torch.obs`` rollups).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.trace.store import TraceError, read_trace

# rate denominators below this span (seconds) are noise, not signal: a
# single-burst charge stream or a freshly-resumed trace re-emits its
# events microseconds apart, and dividing by that would report an
# absurd (or inf/NaN) burn rate instead of "no rate yet"
MIN_RATE_SPAN = 1e-3


def summarize(path: str) -> Dict:
    """One pass over the trace -> the observability summary the text and
    JSON views render.  Safe on a trace mid-write."""
    events = read_trace(path)
    out: Dict = {
        "trace": path, "campaign": events[0].campaign if events else "",
        "events": len(events), "status": "empty" if not events else
        "running", "config": {}, "runtime": {}, "pool_size": 0,
        "iterations": [], "ledger": None, "service_ledger": None,
        "burn": None, "annotator": [], "sweeps": {"cuts": 0, "done": 0},
        "fits": {"submitted": 0, "folded": 0},
        "saves": 0, "resumes": 0, "done_reason": None, "commit": None,
        "faults": {"injected": 0, "retries": 0, "autosaves": 0,
                   "by_site": {}},
    }
    if not events:
        return out

    charges: List = []          # campaign-ledger charge events
    for e in events:
        p = e.payload
        if e.kind == "campaign_begin":
            out["config"] = dict(p.get("config", {}))
            out["runtime"] = dict(p.get("runtime", {}))
            out["pool_size"] = int(p.get("pool_size", 0))
        elif e.kind == "charge":
            if p.get("ledger") == "campaign":
                charges.append(e)
                out["ledger"] = {k: p[k] for k in (
                    "human", "training", "human_labels", "human_votes",
                    "total")}
            else:
                out["service_ledger"] = {k: p[k] for k in (
                    "human", "human_votes", "total")}
        elif e.kind == "iteration":
            out["iterations"].append({
                "i": p["i"], "B_size": p["B_size"], "delta": p["delta"],
                "cstar": p["cstar"], "B_opt": p["B_opt"],
                "theta_opt": p["theta_opt"], "stable": p["stable"],
                "human_spent": p["human_spent"],
                "training_spent": p["training_spent"]})
        elif e.kind == "annotator_snapshot":
            acc = p.get("worker_accuracy") or []
            out["annotator"].append({
                "ts": e.ts, "residual_error": p.get("residual_error"),
                "avg_repeats": p.get("avg_repeats"),
                "min_worker_accuracy": min(acc) if acc else None,
                "mean_worker_accuracy": (sum(acc) / len(acc)
                                         if acc else None)})
        elif e.kind == "sweep_cut":
            out["sweeps"]["cuts"] += 1
        elif e.kind == "sweep_done":
            out["sweeps"]["done"] += 1
        elif e.kind == "fit_submit":
            out["fits"]["submitted"] += 1
        elif e.kind == "fit_done":
            out["fits"]["folded"] += 1
        elif e.kind == "state_save":
            out["saves"] += 1
        elif e.kind == "resume":
            out["resumes"] += 1
        elif e.kind == "fault_injected":
            out["faults"]["injected"] += 1
            site = p.get("site", "?")
            out["faults"]["by_site"][site] = (
                out["faults"]["by_site"].get(site, 0) + 1)
        elif e.kind == "retry":
            out["faults"]["retries"] += 1
        elif e.kind == "autosave":
            out["faults"]["autosaves"] += 1
        elif e.kind == "done":
            out["done_reason"] = p.get("reason")
            out["status"] = f"done:{p.get('reason')}"
        elif e.kind == "commit":
            out["commit"] = {k: p.get(k) for k in (
                "decision", "B_size", "S_size", "theta_final",
                "measured_error")}
            out["commit"]["total_cost"] = p.get("ledger", {}).get("total")
            out["status"] = "committed"

    # ledger burn rate: $ per wall-clock second over the charge stream,
    # plus a recent window (the live number an operator actually watches)
    if len(charges) >= 2:
        span = charges[-1].ts - charges[0].ts
        spent = (charges[-1].payload["total"] - charges[0].payload["total"])
        recent = charges[-min(len(charges), 8):]
        rspan = recent[-1].ts - recent[0].ts
        rspent = (recent[-1].payload["total"] - recent[0].payload["total"])
        out["burn"] = {
            "per_second": spent / span if span > MIN_RATE_SPAN else None,
            "recent_per_second": (rspent / rspan
                                  if rspan > MIN_RATE_SPAN else None),
            "window_seconds": span}
    return out


def render(s: Dict) -> str:
    """The terminal view of one :func:`summarize` pass."""
    lines = [f"campaign {s['campaign']}  [{s['status']}]  "
             f"{s['events']} events  pool={s['pool_size']}"]
    rt = s["runtime"]
    if rt:
        lines.append("runtime: " + ", ".join(f"{k}={v}"
                                             for k, v in rt.items()))
    if s["iterations"]:
        lines.append("")
        lines.append(f"{'it':>4} {'|B|':>7} {'delta':>6} {'C*':>10} "
                     f"{'B_opt':>7} {'theta':>6} {'human$':>9} "
                     f"{'train$':>9} {'stable':>6}")
        for r in s["iterations"]:
            lines.append(
                f"{r['i']:>4} {r['B_size']:>7} {r['delta']:>6} "
                f"{r['cstar']:>10.2f} {r['B_opt']:>7} "
                f"{r['theta_opt']:>6.2f} {r['human_spent']:>9.2f} "
                f"{r['training_spent']:>9.2f} "
                f"{'yes' if r['stable'] else '':>6}")
    if s["ledger"]:
        led = s["ledger"]
        lines.append("")
        lines.append(
            f"ledger: total ${led['total']:.2f}  (human ${led['human']:.2f}"
            f" / training ${led['training']:.2f}  "
            f"{led['human_labels']} labels, {led['human_votes']} votes)")
    if s["burn"] and s["burn"]["per_second"] is not None:
        b = s["burn"]
        rate = b["recent_per_second"]
        rate = b["per_second"] if rate is None else rate
        lines.append(f"burn rate: ${rate:.3f}/s (recent)  "
                     f"${b['per_second']:.3f}/s overall over "
                     f"{b['window_seconds']:.1f}s")
    if s["annotator"]:
        first, last = s["annotator"][0], s["annotator"][-1]
        lines.append(
            f"annotators: residual error {first['residual_error']:.3f} -> "
            f"{last['residual_error']:.3f}, avg repeats "
            f"{last['avg_repeats']:.2f}, worker accuracy "
            f"min {last['min_worker_accuracy']:.2f} / "
            f"mean {last['mean_worker_accuracy']:.2f} "
            f"({len(s['annotator'])} snapshots)")
    ov = s["fits"]
    if ov["submitted"] or s["sweeps"]["cuts"] or s["sweeps"]["done"]:
        lines.append(
            f"runtimes: {ov['folded']}/{ov['submitted']} async fits "
            f"folded, {s['sweeps']['done']} sweeps "
            f"({s['sweeps']['cuts']} cursor cuts)")
    if s["saves"] or s["resumes"]:
        lines.append(f"fault tolerance: {s['saves']} state saves, "
                     f"{s['resumes']} resumes")
    f = s.get("faults") or {}
    if f.get("injected") or f.get("retries") or f.get("autosaves"):
        sites = ", ".join(f"{k}×{v}" for k, v in
                          sorted(f.get("by_site", {}).items()))
        lines.append(
            f"fault pressure: {f.get('injected', 0)} injected"
            + (f" ({sites})" if sites else "")
            + f", {f.get('retries', 0)} retries, "
              f"{f.get('autosaves', 0)} autosaves")
    if s["commit"]:
        c = s["commit"]
        lines.append(
            f"COMMITTED: {c['decision']}  |B|={c['B_size']} "
            f"S={c['S_size']} theta={c['theta_final']:.2f}  "
            f"measured_error={c['measured_error']:.4f}  "
            f"total ${c['total_cost']:.2f}")
    elif s["done_reason"]:
        lines.append(f"loop done ({s['done_reason']}), not yet committed")
    return "\n".join(lines)


def summarize_metrics(paths: List[str]) -> Dict:
    """Fold the ``metric_span`` stream and the last ``metric_snapshot``
    from one or more trace files into the ``--metrics`` panel's data.

    Recorded telemetry only: span rows come from ``repro_torch.obs.export``'s
    framework-free rollups; the registry snapshot (counters/gauges/histograms)
    is whatever the campaign last emitted — nothing is recomputed."""
    from repro_torch.obs.export import (cache_hit_rates, queue_stats,
                                  snapshot_counter, span_rollup)
    events = []
    for p in paths:
        events.extend(read_trace(p))
    spans = span_rollup(events)
    snapshot = None
    for e in events:
        if e.kind == "metric_snapshot":
            snapshot = e.payload.get("snapshot")
    rows = [{"name": name, "tenant": tenant, **stats}
            for (name, tenant), stats in sorted(
                spans.items(),
                key=lambda kv: -kv[1]["seconds"])]
    return {
        "spans": rows,
        "snapshot": snapshot,
        "cache": cache_hit_rates(snapshot) if snapshot else {},
        "queues": queue_stats(snapshot) if snapshot else {},
        "rows_swept": (snapshot_counter(snapshot, "sweep_rows_total")
                       if snapshot else 0.0),
        "votes": (snapshot_counter(snapshot, "annotation_votes_total")
                  if snapshot else 0.0),
    }


def render_metrics(ms: Dict, burn: Optional[Dict] = None) -> str:
    """The terminal view of one :func:`summarize_metrics` pass."""
    lines = ["", "== metrics =="]
    rows = ms["spans"]
    if rows:
        total = sum(r["seconds"] for r in rows) or 1.0
        tenants = any(r["tenant"] for r in rows)
        head = f"{'span':<12}"
        if tenants:
            head += f" {'tenant':<10}"
        head += (f" {'count':>6} {'total_s':>9} {'mean_ms':>9} "
                 f"{'max_ms':>9} {'share':>6} {'err':>4}")
        lines.append(head)
        for r in rows:
            line = f"{r['name']:<12}"
            if tenants:
                line += f" {r['tenant'] or '-':<10}"
            mean = r["seconds"] / r["count"] if r["count"] else 0.0
            line += (f" {r['count']:>6} {r['seconds']:>9.3f} "
                     f"{mean * 1e3:>9.2f} {r['max'] * 1e3:>9.2f} "
                     f"{100.0 * r['seconds'] / total:>5.1f}% "
                     f"{r['errors']:>4}")
            lines.append(line)
    else:
        lines.append("(no metric_span events)")
    if ms["cache"]:
        parts = []
        for eng, c in sorted(ms["cache"].items()):
            parts.append(f"{eng} {int(c['hits'])}/"
                         f"{int(c['hits'] + c['misses'])} hits "
                         f"({100.0 * c['rate']:.1f}%)")
        lines.append("compile cache: " + "  ".join(parts))
    if ms["queues"]:
        parts = []
        for q, st in sorted(ms["queues"].items()):
            part = f"{q} depth={int(st.get('depth', 0))}"
            if st.get("waits"):
                part += (f" waits={int(st['waits'])}"
                         f" mean={st['wait_mean'] * 1e3:.1f}ms"
                         f" max={st['wait_max'] * 1e3:.1f}ms")
            parts.append(part)
        lines.append("queues: " + "  ".join(parts))
    # burn rate vs throughput: $/s from the campaign ledger stream next
    # to the device-side row/vote counters the registry accumulated
    sweep_s = sum(r["seconds"] for r in rows if r["name"] == "sweep")
    if ms["rows_swept"]:
        thr = (f"{ms['rows_swept']:.0f} rows swept"
               + (f" ({ms['rows_swept'] / sweep_s:,.0f} rows/s in sweeps)"
                  if sweep_s > MIN_RATE_SPAN else ""))
        if ms["votes"]:
            thr += f", {ms['votes']:.0f} votes"
        rate = None
        if burn:
            rate = burn.get("recent_per_second") or burn.get("per_second")
        if rate is not None:
            thr += f"  @ ${rate:.3f}/s burn"
        lines.append("throughput: " + thr)
    return "\n".join(lines)


def summarize_health(paths: List[str]) -> Dict:
    """Fold the health engine's judgment stream (``alert`` /
    ``alert_clear`` / ``slo_breach`` events) from one or more traces
    into the ``--health`` panel's data.

    Replaying the hysteresis output is trivial because the engine
    already deduplicated it: an ``alert``/``slo_breach`` event opens a
    ``(tenant, detector)`` incident, the matching ``alert_clear``
    closes it — whatever is still open at end-of-trace is the live
    alert set."""
    from repro_torch.obs.health import ALERT_KINDS
    events = []
    for p in paths:
        events.extend(e for e in read_trace(p) if e.kind in ALERT_KINDS)
    events.sort(key=lambda e: e.ts)
    active: Dict[Tuple[str, str], Dict] = {}
    log: List[Dict] = []
    raised = cleared = breaches = 0
    for e in events:
        p = e.payload
        key = (str(p.get("tenant", "")), str(p.get("detector", "")))
        row = {"ts": e.ts, "tick": p.get("tick"), "tenant": key[0],
               "detector": key[1], "kind": e.kind,
               "severity": p.get("severity", "warn")}
        log.append(row)
        if e.kind == "alert_clear":
            cleared += 1
            active.pop(key, None)
        else:
            raised += 1
            if e.kind == "slo_breach":
                breaches += 1
            active[key] = row
    return {
        "alerts_raised": raised, "alerts_cleared": cleared,
        "slo_breaches": breaches, "events": log,
        "active": [active[k] for k in sorted(active)],
    }


def render_health(hs: Dict, tail: int = 8) -> str:
    """The terminal view of one :func:`summarize_health` pass — the
    live alert panel ``--watch --health`` re-renders."""
    lines = ["", "== health =="]
    if not hs["events"]:
        lines.append("(no health events — engine not attached, "
                     "or nothing to report)")
        return "\n".join(lines)
    lines.append(
        f"{hs['alerts_raised']} raised / {hs['alerts_cleared']} cleared "
        f"({hs['slo_breaches']} SLO breaches), "
        f"{len(hs['active'])} active")
    for a in hs["active"]:
        who = a["tenant"] or "fleet"
        lines.append(f"  ACTIVE [{a['severity']}] {who}: {a['detector']}"
                     f"  (since tick {a['tick']})")
    recent = hs["events"][-tail:]
    lines.append(f"last {len(recent)} events:")
    mark = {"alert": "!", "slo_breach": "x", "alert_clear": "-"}
    for r in recent:
        who = r["tenant"] or "fleet"
        lines.append(f"  {mark.get(r['kind'], '?')} tick {r['tick']:>3}  "
                     f"{who:<10} {r['detector']:<22} {r['kind']}")
    return "\n".join(lines)


def _trace_paths(path: str) -> Tuple[List[str], List[str]]:
    """(campaign traces, metric-event sources) for a file or fleet dir.

    A file is both its own campaign trace and its own metrics stream
    (solo campaigns interleave metric events into the one trace).  A
    fleet dir contributes every tenant trace plus the orchestrator's
    standalone ``metrics.jsonl``; ``fleet.jsonl`` is control-plane only
    and renders through neither view."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        camps = [os.path.join(path, n) for n in names
                 if n.endswith(".jsonl")
                 and n not in ("fleet.jsonl", "metrics.jsonl")]
        if not camps:
            raise FileNotFoundError(
                f"no campaign traces in {path!r} yet")
        metrics = [os.path.join(path, n) for n in names
                   if n == "metrics.jsonl"]
        return camps, metrics + camps
    return [path], [path]


def _health_paths(path: str) -> List[str]:
    """Where ``--health`` reads alert events: a solo trace carries its
    own judgment stream; in a fleet dir the health engine rides the
    orchestrator's ``fleet.jsonl`` (tenant traces are still scanned —
    a tenant may have attached its own engine solo-style)."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        return [os.path.join(path, n) for n in names
                if n.endswith(".jsonl") and n != "metrics.jsonl"]
    return [path]


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description="live view of an MCAL campaign trace")
    ap.add_argument("trace", help="trace JSONL path (may be mid-write) "
                                  "or a fleet trace dir")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="re-render every N seconds until the campaign "
                         "commits (0 = render once)")
    ap.add_argument("--metrics", action="store_true",
                    help="append the runtime metrics panel (per-engine "
                         "time breakdown, cache hit rates, queue depths, "
                         "burn vs throughput)")
    ap.add_argument("--metrics-file", default=None, metavar="PATH",
                    help="read metric events from PATH instead of the "
                         "trace itself")
    ap.add_argument("--health", action="store_true",
                    help="append the health panel (active alerts, SLO "
                         "breaches, recent judgment events) — with "
                         "--watch this is a live alert panel")
    args = ap.parse_args(argv)
    while True:
        try:
            camps, msources = _trace_paths(args.trace)
            if args.metrics_file:
                msources = [args.metrics_file]
            summaries = [summarize(p) for p in camps]
            ms = summarize_metrics(msources) if args.metrics else None
            hs = (summarize_health(_health_paths(args.trace))
                  if args.health else None)
        except (TraceError, OSError) as exc:
            # a watched trace can vanish mid-poll (rotation, the writer
            # re-creating its dir, a tenant not started yet) — in watch
            # mode that is a transient, not an error: re-wait
            if not args.watch:
                raise
            print(f"# waiting for {args.trace}: {exc}", flush=True)
            time.sleep(args.watch)
            continue
        if args.json:
            blob: Dict = (summaries[0] if len(summaries) == 1
                          else {"tenants": summaries})
            if ms is not None:
                blob = dict(blob)
                blob["metrics"] = {k: v for k, v in ms.items()
                                   if k != "snapshot"}
                blob["metrics"]["snapshot"] = ms["snapshot"]
            if hs is not None:
                blob = dict(blob)
                blob["health"] = hs
            print(json.dumps(blob, indent=2))
        else:
            for i, s in enumerate(summaries):
                if i:
                    print()
                print(render(s))
            if ms is not None:
                burn = (summaries[0]["burn"]
                        if len(summaries) == 1 else None)
                print(render_metrics(ms, burn))
            if hs is not None:
                print(render_health(hs))
        done = all(s["commit"] is not None for s in summaries)
        if not args.watch or done:
            return
        time.sleep(args.watch)
        print()


if __name__ == "__main__":
    main()
