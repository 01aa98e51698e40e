# Metrics exporters + report-side rollups.  Framework-free: report tooling
# imports this without touching the engine stack.
"""Export surfaces for :class:`repro_torch.obs.MetricsRegistry` snapshots.

Three consumers share this module:

* ``write_prometheus`` renders a snapshot in the Prometheus textfile
  exposition format (node_exporter textfile-collector style) so a
  long-running campaign can be scraped by pointing the collector at
  the file the launcher rewrites each iteration.
* ``span_rollup`` / ``cache_hit_rates`` / ``queue_stats`` fold the raw
  snapshot (or a stream of ``metric_span`` events) into the per-engine
  breakdowns that ``launch/report.py --metrics`` renders.
* the benchmark harness embeds raw snapshots into ``BENCH_*.json``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "write_prometheus", "prometheus_lines", "span_rollup",
    "cache_hit_rates", "queue_stats", "snapshot_counter",
]


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def _labels(labels: Dict[str, str], extra: Tuple[Tuple[str, str], ...] = ()
            ) -> str:
    items = sorted(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in items)
    return "{" + body + "}"


def _sanitize_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def prometheus_lines(snapshot: Dict, prefix: str = "repro_") -> List[str]:
    """Render a registry snapshot as Prometheus exposition-format lines.

    Counters keep their ``_total`` suffix convention from the call
    sites; histograms expand to cumulative ``_bucket{le=...}`` series
    plus ``_sum`` / ``_count``."""
    out: List[str] = []
    seen_type: set = set()

    def head(name: str, kind: str):
        if name not in seen_type:
            seen_type.add(name)
            out.append(f"# TYPE {name} {kind}")

    for c in snapshot.get("counters", ()):
        name = _sanitize_name(prefix + c["name"])
        head(name, "counter")
        out.append(f"{name}{_labels(c['labels'])} {_fmt(c['value'])}")
    for g in snapshot.get("gauges", ()):
        name = _sanitize_name(prefix + g["name"])
        head(name, "gauge")
        out.append(f"{name}{_labels(g['labels'])} {_fmt(g['value'])}")
    for h in snapshot.get("histograms", ()):
        name = _sanitize_name(prefix + h["name"])
        head(name, "histogram")
        cum = 0
        for bound, count in zip(list(h["buckets"]) + [math.inf],
                                h["counts"]):
            cum += int(count)
            le = "+Inf" if bound == math.inf else _fmt(bound)
            out.append(f"{name}_bucket"
                       f"{_labels(h['labels'], (('le', le),))} {cum}")
        out.append(f"{name}_sum{_labels(h['labels'])} {_fmt(h['sum'])}")
        out.append(f"{name}_count{_labels(h['labels'])} {int(h['count'])}")
    return out


def write_prometheus(snapshot: Dict, path: str,
                     prefix: str = "repro_") -> None:
    """Atomic-enough textfile write: the collector convention tolerates
    torn reads poorly, so write to a sidecar and rename."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(prometheus_lines(snapshot, prefix)) + "\n")
    os.replace(tmp, path)


# -- report-side rollups ----------------------------------------------------

def span_rollup(events: Iterable) -> Dict[Tuple[str, str], Dict]:
    """Fold ``metric_span`` trace events into per-(span name, tenant)
    totals: ``{(name, tenant): {count, seconds, max, errors}}``.
    ``events`` yields anything with ``.kind`` / ``.payload`` (TraceEvent)
    or plain dicts."""
    out: Dict[Tuple[str, str], Dict] = {}
    for e in events:
        kind = getattr(e, "kind", None) or e.get("kind")
        if kind != "metric_span":
            continue
        p = getattr(e, "payload", None)
        if p is None:
            p = e.get("payload", e)
        labels = p.get("labels") or {}
        key = (str(p.get("name", "?")), str(labels.get("tenant", "")))
        s = out.setdefault(key, {"count": 0, "seconds": 0.0, "max": 0.0,
                                 "errors": 0})
        sec = float(p.get("seconds", 0.0))
        s["count"] += 1
        s["seconds"] += sec
        if sec > s["max"]:
            s["max"] = sec
        if p.get("status") != "ok":
            s["errors"] += 1
    return out


def snapshot_counter(snapshot: Optional[Dict], name: str,
                     **labels) -> float:
    """Sum every counter series matching ``name`` whose labels include
    the given key/values (extra labels on the series are fine)."""
    if not snapshot:
        return 0.0
    want = {str(k): str(v) for k, v in labels.items()}
    total = 0.0
    for c in snapshot.get("counters", ()):
        if c["name"] != name:
            continue
        have = c.get("labels", {})
        if all(have.get(k) == v for k, v in want.items()):
            total += float(c["value"])
    return total


def cache_hit_rates(snapshot: Optional[Dict]) -> Dict[str, Dict]:
    """Per-engine pack-shape compile-cache hit rates from the
    ``pack_cache_{hits,misses}_total{engine=...}`` counters."""
    out: Dict[str, Dict] = {}
    if not snapshot:
        return out
    engines: set = set()
    for c in snapshot.get("counters", ()):
        if c["name"] in ("pack_cache_hits_total",
                         "pack_cache_misses_total"):
            engines.add(c.get("labels", {}).get("engine", "?"))
    for eng in sorted(engines):
        hits = snapshot_counter(snapshot, "pack_cache_hits_total",
                                engine=eng)
        misses = snapshot_counter(snapshot, "pack_cache_misses_total",
                                  engine=eng)
        total = hits + misses
        out[eng] = {"hits": int(hits), "misses": int(misses),
                    "rate": (hits / total) if total else None}
    return out


def queue_stats(snapshot: Optional[Dict]) -> Dict[str, Dict]:
    """Broker queue depth gauges + wait histograms, keyed by queue."""
    out: Dict[str, Dict] = {}
    if not snapshot:
        return out
    for g in snapshot.get("gauges", ()):
        if g["name"] == "queue_depth":
            q = g.get("labels", {}).get("queue", "?")
            out.setdefault(q, {})["depth"] = float(g["value"])
    for h in snapshot.get("histograms", ()):
        if h["name"] == "queue_wait_seconds":
            q = h.get("labels", {}).get("queue", "?")
            s = out.setdefault(q, {})
            s["waits"] = int(h["count"])
            s["wait_mean"] = (h["sum"] / h["count"]) if h["count"] else 0.0
            s["wait_max"] = h["max"] if h["max"] is not None else 0.0
    return out
