"""The port's runtime metrics and profiling layer (``repro_torch.obs``),
held against the JAX package's (``tests/test_obs.py``).

Unit level, on the port's copies: log-bucket histogram bounds, registry
thread safety, span nesting and exception unwinding, bound (per-tenant)
labels, the Prometheus exposition — byte-equal to the reference's for the
same recorded events — and the span fence, which waits on a CUDA event
recorded on the fenced value's stream (on the CPU there is nothing to wait
for, and the span still counts as fenced, as in the reference).

System level: the same instrumented live campaign records the same set of
metric names and label keys in both packages; an instrumented campaign
diffs clean against its uninstrumented sibling; ``report --metrics``
renders a solo campaign and a fleet from recorded telemetry alone; and
``profile_block`` writes a Chrome trace.  Exact throughout (names, label
keys, bytes); only wall-clock values differ.
"""
import json
import math
import os
import threading
import time

import numpy as np
import pytest

import repro.obs as jobs
from repro_torch.obs import (MetricsRegistry, cache_hit_rates, log_buckets,
                             profile_block, prometheus_lines, queue_stats,
                             span_rollup)
from repro_torch.obs.metrics import _Hist


def test_log_buckets_cover_range_log_spaced():
    b = log_buckets(1e-3, 10.0, per_decade=2)
    assert b[0] == pytest.approx(1e-3)
    assert b[-1] >= 10.0
    ratios = [b[i + 1] / b[i] for i in range(len(b) - 1)]
    assert all(r == pytest.approx(math.sqrt(10.0)) for r in ratios)
    with pytest.raises(ValueError):
        log_buckets(0.0, 1.0)
    with pytest.raises(ValueError):
        log_buckets(2.0, 1.0)


def test_histogram_bucket_boundaries():
    h = _Hist((1.0, 10.0, 100.0))
    # upper-edge inclusive: v <= bounds[i] lands in bucket i
    for v, slot in ((0.5, 0), (1.0, 0), (1.0001, 1), (10.0, 1),
                    (99.0, 2), (100.0, 2), (101.0, 3), (1e9, 3)):
        before = list(h.counts)
        h.observe(v)
        assert h.counts[slot] == before[slot] + 1, (v, slot)
    assert h.count == 8
    assert h.min == 0.5 and h.max == 1e9
    assert h.sum == pytest.approx(0.5 + 1.0 + 1.0001 + 10.0 + 99.0
                                  + 100.0 + 101.0 + 1e9)
    # bounded memory: bucket count never grows with observations
    assert len(h.counts) == 4


def test_histogram_empty_minmax_null():
    d = _Hist((1.0,)).to_dict()
    assert d["min"] is None and d["max"] is None and d["count"] == 0


# ---------------------------------------------------------------------------
# registry: counters/gauges/labels/thread safety
# ---------------------------------------------------------------------------


def test_counters_gauges_label_keyed():
    m = MetricsRegistry()
    m.inc("hits_total", engine="scoring")
    m.inc("hits_total", 2.0, engine="fit")
    m.inc("hits_total", engine="scoring")
    m.set_gauge("depth", 3.0, queue="ann")
    assert m.add_gauge("depth", -1.0, queue="ann") == 2.0
    snap = m.snapshot()
    vals = {tuple(sorted(c["labels"].items())): c["value"]
            for c in snap["counters"] if c["name"] == "hits_total"}
    assert vals[(("engine", "scoring"),)] == 2.0
    assert vals[(("engine", "fit"),)] == 2.0
    assert snap["gauges"][0]["value"] == 2.0


def test_label_name_cannot_collide_with_metric_params():
    # spans label their histogram rows name=<span name>; the registry's
    # positional-only params must not swallow such labels
    m = MetricsRegistry()
    m.inc("c_total", 1.0, name="x", value="y")
    m.observe("span_seconds", 0.5, name="sweep")
    snap = m.snapshot()
    assert snap["counters"][0]["labels"] == {"name": "x", "value": "y"}
    assert snap["histograms"][0]["labels"] == {"name": "sweep"}


def test_registry_thread_safety_under_concurrent_rounds():
    m = MetricsRegistry()
    threads, per, n = 8, 500, []

    def tenant_round(t):
        with m.bind(tenant=f"t{t}"):
            for i in range(per):
                m.inc("iters_total")
                m.observe("lat", i * 1e-4)
                m.add_gauge("depth", 1)
                m.add_gauge("depth", -1)

    ths = [threading.Thread(target=tenant_round, args=(t,))
           for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    snap = m.snapshot()
    counters = [c for c in snap["counters"] if c["name"] == "iters_total"]
    assert len(counters) == threads             # one series per tenant
    assert sum(c["value"] for c in counters) == threads * per
    hists = [h for h in snap["histograms"] if h["name"] == "lat"]
    assert sum(h["count"] for h in hists) == threads * per
    gauges = [g for g in snap["gauges"] if g["name"] == "depth"]
    assert all(g["value"] == 0.0 for g in gauges)   # balanced +1/-1


def test_bind_merges_and_explicit_labels_win():
    m = MetricsRegistry()
    with m.bind(tenant="t0", engine="fleet"):
        m.inc("x_total", engine="fit")   # explicit engine wins
    m.inc("x_total", engine="fit")       # outside bind: no tenant label
    snap = m.snapshot()
    labels = sorted(tuple(sorted(c["labels"].items()))
                    for c in snap["counters"])
    assert labels == [(("engine", "fit"),),
                      (("engine", "fit"), ("tenant", "t0"))]


# ---------------------------------------------------------------------------
# spans: nesting, exception unwinding, decorator
# ---------------------------------------------------------------------------


class _FakeTrace:
    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append({"kind": kind, "payload": payload})


def test_span_nesting_paths():
    m = MetricsRegistry()
    tr = _FakeTrace()
    m.attach_trace(tr)
    with m.span("round"):
        with m.span("iteration"):
            with m.span("sweep"):
                pass
        with m.span("fit"):
            pass
    paths = [e["payload"]["path"] for e in tr.events]
    assert paths == ["round/iteration/sweep", "round/iteration",
                     "round/fit", "round"]


def test_span_exception_unwinds_stack_and_reraises():
    m = MetricsRegistry()
    tr = _FakeTrace()
    m.attach_trace(tr)
    with pytest.raises(ValueError, match="boom"):
        with m.span("outer"):
            with m.span("inner"):
                raise ValueError("boom")
    assert [e["payload"]["status"] for e in tr.events] == ["error", "error"]
    snap = m.snapshot()
    errs = {c["labels"]["name"]: c["value"] for c in snap["counters"]
            if c["name"] == "span_errors_total"}
    assert errs == {"inner": 1.0, "outer": 1.0}
    # the stack unwound: a fresh span is top-level again
    with m.span("clean"):
        pass
    assert tr.events[-1]["payload"]["path"] == "clean"


def test_span_decorator_and_fence():
    import torch

    m = MetricsRegistry()

    @m.span("scored")
    def score(x):
        return x * 2

    assert score(3) == 6
    with m.span("fenced") as sp:
        sp.fence(torch.arange(8) * 2.0)
    snap = m.snapshot()
    names = {h["labels"]["name"] for h in snap["histograms"]
             if h["name"] == "span_seconds"}
    assert names == {"scored", "fenced"}


def test_span_timing_is_wall_clock():
    m = MetricsRegistry()
    with m.span("nap"):
        time.sleep(0.02)
    h = m.snapshot()["histograms"][0]
    assert h["min"] >= 0.02


# ---------------------------------------------------------------------------
# exports: prometheus + profile_block
# ---------------------------------------------------------------------------


def test_prometheus_exposition_format(tmp_path):
    m = MetricsRegistry(buckets=(0.1, 1.0))
    m.inc("labels_total", 3.0, engine="fit")
    m.set_gauge("depth", 2.0)
    m.observe("lat_seconds", 0.05)
    m.observe("lat_seconds", 5.0)
    lines = prometheus_lines(m.snapshot())
    assert "# TYPE repro_labels_total counter" in lines
    assert 'repro_labels_total{engine="fit"} 3.0' in lines
    assert "repro_depth 2.0" in lines
    # cumulative buckets + overflow +Inf == count
    assert "repro_lat_seconds_bucket{le=\"0.1\"} 1" in lines
    assert "repro_lat_seconds_bucket{le=\"+Inf\"} 2" in lines
    assert "repro_lat_seconds_count 2" in lines
    p = tmp_path / "m.prom"
    m.write_prometheus(str(p))
    assert p.read_text().splitlines() == lines
    assert not os.path.exists(str(p) + ".tmp")   # atomic rename


def test_profile_block_disabled_and_exception_transparent(tmp_path):
    with profile_block("", enabled=True) as on:
        assert on is False
    with profile_block(str(tmp_path), enabled=False) as on:
        assert on is False
    with pytest.raises(RuntimeError, match="body"):
        with profile_block("", enabled=True):
            raise RuntimeError("body")



def test_profile_block_that_cannot_start_runs_the_body(tmp_path,
                                                       monkeypatch, capsys):
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler backend")
    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with profile_block(str(tmp_path)) as on:
        ran.append(on)
    assert ran == [False]
    assert "continuing without" in capsys.readouterr().err


def test_profile_block_writes_a_chrome_trace(tmp_path):
    import torch

    from repro_torch.obs.profiling import trace_path
    with profile_block(str(tmp_path)) as on:
        assert on is True
        torch.ones(64, 64) @ torch.ones(64, 64)
    blob = json.loads(open(trace_path(str(tmp_path))).read())
    assert any("mm" in str(e.get("name", "")) for e in blob["traceEvents"])


# ---------------------------------------------------------------------------
# byte-equal exposition, the fence
# ---------------------------------------------------------------------------


def _record(m):
    """The same events into either package's registry."""
    rng = np.random.default_rng(3)
    for i in range(50):
        m.inc("pack_cache_hits_total", engine="scoring")
        m.inc("sweep_rows_total", float(rng.integers(1, 9000)))
        m.observe("span_seconds", float(rng.lognormal(-4, 2)),
                  name="sweep", sink="topk", tenant=f"t{i % 3}")
        m.observe("sweep_fold_seconds", float(rng.uniform(0, 0.1)))
        m.set_gauge("campaign_spent_total", float(rng.uniform(0, 99)))
        m.add_gauge("queue_depth", float(rng.integers(-1, 2)),
                    queue="annotation")
    with m.bind(tenant="t9"):
        m.inc("faults_injected_total", site="worker.pool-sweep",
              kind="crash")
        m.inc("label\"with\\quotes", note="a\nb")
    m.observe("span_seconds", 1e9, name="overflow")
    m.observe("span_seconds", 0.0, name="underflow")


def test_prometheus_exposition_equals_reference(tmp_path):
    mine, ref = MetricsRegistry(), jobs.MetricsRegistry()
    _record(mine)
    _record(ref)
    assert mine.snapshot() == ref.snapshot()
    assert prometheus_lines(mine.snapshot()) == \
        jobs.prometheus_lines(ref.snapshot())
    a, b = tmp_path / "port.prom", tmp_path / "jax.prom"
    mine.write_prometheus(str(a))
    ref.write_prometheus(str(b))
    assert a.read_bytes() == b.read_bytes()


def test_rollups_equal_reference():
    mine, ref = MetricsRegistry(), jobs.MetricsRegistry()
    _record(mine)
    _record(ref)
    assert cache_hit_rates(mine.snapshot()) == \
        jobs.cache_hit_rates(ref.snapshot())
    assert queue_stats(mine.snapshot()) == jobs.queue_stats(ref.snapshot())


class _Trace:
    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


def test_cpu_fence_counts_as_fenced_without_waiting():
    import torch

    from repro_torch.obs.metrics import _fence_event
    tr = _Trace()
    m = MetricsRegistry(trace=tr)
    with m.span("fit", n_pad=256) as sp:
        sp.fence({"loss": torch.ones(3)})       # CPU tensor: no event
    with m.span("plain"):
        pass
    spans = {p["name"]: p for k, p in tr.events if k == "metric_span"}
    assert spans["fit"]["fenced"] is True
    assert spans["plain"]["fenced"] is False
    assert _fence_event(torch.ones(2)) is None
    assert _fence_event((1, [None, {"a": "b"}])) is None


def test_fence_is_skipped_when_the_span_fails():
    tr = _Trace()
    m = MetricsRegistry(trace=tr)
    with pytest.raises(RuntimeError):
        with m.span("fit") as sp:
            sp.fence(object())
            raise RuntimeError("retrain died")
    (kind, p), = tr.events
    assert p["status"] == "error" and p["fenced"] is False


# ---------------------------------------------------------------------------
# one live campaign, both packages
# ---------------------------------------------------------------------------

POOL = 320


def _live_campaign(pkg, trace_path, metrics=None, metric="margin"):
    """A noisy, async live campaign (Dawid-Skene, adaptive repeats) with
    metric events interleaved into its trace."""
    if pkg == "jax":
        from repro.annotation import make_annotation_service as mk
        from repro.core import AMAZON, MCALCampaign, MCALConfig
        from repro.core.task import LiveTask
        from repro.trace import TraceStore
        kw = {}
    else:
        from repro_torch.annotation import make_annotation_service as mk
        from repro_torch.core import (AMAZON, LiveTask, MCALCampaign,
                                      MCALConfig)
        from repro_torch.trace import TraceStore
        kw = {"device": "cpu"}
    from repro_torch.data.synth import make_classification
    x, y = make_classification(POOL, num_classes=3, difficulty=0.3, seed=0)
    ann = mk(3, noise=0.2, repeats=3, max_repeats=5, adaptive=True,
             aggregator="ds", pricing=AMAZON, seed=0, **kw)
    task = LiveTask(features=x, groundtruth=y, num_classes=3, epochs=2,
                    score_microbatch=64, sweep_page=64, seed=0,
                    annotation=ann, **kw)
    cfg = MCALConfig(seed=0, max_iters=3, delta0_frac=0.1, test_frac=0.2,
                     metric=metric, sweep_async=True, fit_async=True,
                     label_quality=ann.expected_quality())
    camp = MCALCampaign(task, AMAZON, cfg)
    try:
        with TraceStore(str(trace_path), "obs-live") as tr:
            camp.attach_trace(tr)
            if metrics is not None:
                metrics.attach_trace(tr)
                camp.attach_metrics(metrics)
            res = camp.run()
            camp.close()
            if metrics is not None:
                metrics.emit_snapshot(scope="test")
    finally:
        camp.close()
    return res


def _schema(snapshot):
    """(kind, metric name, label keys) of every series in a snapshot; a
    span histogram also keeps its span name."""
    out = set()
    for kind in ("counters", "gauges", "histograms"):
        for s in snapshot[kind]:
            name = s["name"]
            if name == "span_seconds":
                name += ":" + s["labels"]["name"]
            out.add((kind, name, tuple(sorted(s["labels"]))))
    return out


@pytest.fixture(scope="module")
def live_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_live")
    out = {}
    for metric in ("margin", "kcenter"):
        m, jm = MetricsRegistry(), jobs.MetricsRegistry()
        on, off, ref = (d / f"on-{metric}.jsonl", d / f"off-{metric}.jsonl",
                        d / f"jax-{metric}.jsonl")
        out[metric] = dict(
            on=str(on), off=str(off), ref=str(ref), registry=m, jregistry=jm,
            res_on=_live_campaign("port", on, m, metric),
            res_off=_live_campaign("port", off, None, metric),
            res_ref=_live_campaign("jax", ref, jm, metric))
    return out


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
def test_metric_names_and_label_keys_equal_reference(live_runs, metric):
    r = live_runs[metric]
    got = _schema(r["registry"].snapshot())
    want = _schema(r["jregistry"].snapshot())
    assert got == want, (got ^ want)


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
def test_instrumented_campaign_diffs_clean_against_plain(live_runs, metric):
    from repro_torch.trace import diff, replay
    r = live_runs[metric]
    assert diff(r["off"], r["on"]) is None
    assert r["res_on"].total_cost == r["res_off"].total_cost
    assert r["res_on"].decision == r["res_off"].decision
    for got, want in zip(r["res_on"].history, r["res_off"].history):
        assert got.to_dict() == want.to_dict()
    rp = replay(r["on"])
    assert rp.total_cost == r["res_on"].total_cost


def test_registry_saw_every_campaign_site(live_runs):
    snap = live_runs["kcenter"]["registry"].snapshot()
    counters = {c["name"] for c in snap["counters"]}
    assert {"annotation_labels_total", "annotation_votes_total",
            "annotation_agg_rounds_total", "campaign_iterations_total",
            "pack_cache_hits_total", "pack_cache_misses_total",
            "sweep_pages_total", "sweep_rows_total"} <= counters
    spans = {h["labels"]["name"] for h in snap["histograms"]
             if h["name"] == "span_seconds"}
    assert {"bootstrap", "iteration", "commit", "annotate", "fit",
            "sweep", "kcenter"} <= spans
    engines = {c["labels"].get("engine") for c in snap["counters"]
               if c["name"].startswith("pack_cache_")}
    assert {"scoring", "fit", "votes"} <= engines


def test_fit_spans_are_fenced(live_runs):
    from repro_torch.trace.store import read_trace
    fit = [e.payload for e in read_trace(live_runs["margin"]["on"])
           if e.kind == "metric_span" and e.payload["name"] == "fit"]
    assert fit and all(p["fenced"] for p in fit)
    assert all(p["labels"]["n_pad"].isdigit() for p in fit)


def test_disabled_mode_is_identity_on_engine_sites():
    from repro_torch.core.selection_device import k_center_greedy_device
    rng = np.random.default_rng(0)
    X = rng.integers(0, 16, (128, 8)).astype(np.float32)
    m = MetricsRegistry()
    a = k_center_greedy_device(X, 10, device="cpu")
    b = k_center_greedy_device(X, 10, device="cpu", metrics=m)
    np.testing.assert_array_equal(a, b)
    spans = [h for h in m.snapshot()["histograms"]
             if h["name"] == "span_seconds"]
    assert spans and spans[0]["labels"]["name"] == "kcenter"


# ---------------------------------------------------------------------------
# report --metrics: solo + fleet, from recorded telemetry alone
# ---------------------------------------------------------------------------


def test_report_metrics_panel_solo(live_runs, capsys):
    from repro_torch.launch import report
    p_on = live_runs["margin"]["on"]
    report.main([p_on, "--metrics"])
    out = capsys.readouterr().out
    assert "== metrics ==" in out
    assert "iteration" in out and "annotate" in out
    assert "compile cache:" in out
    report.main([p_on, "--metrics", "--json"])
    blob = json.loads(capsys.readouterr().out)
    assert blob["metrics"]["spans"]
    assert blob["metrics"]["snapshot"]["counters"]


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    """An instrumented N=4 fleet over shared engines: tenant traces,
    a standalone metrics.jsonl and metrics.prom in one directory."""
    from repro_torch.core import AMAZON, MCALConfig
    from repro_torch.core.tenant import TenantSpec
    from repro_torch.data.synth import make_classification
    from repro_torch.launch.orchestrator import build_fleet

    d = str(tmp_path_factory.mktemp("fleet"))
    x, y = make_classification(400, num_classes=4, difficulty=0.3, seed=0)
    specs = [TenantSpec(f"t{i}", priority=i % 2, seed=i,
                        cfg=MCALConfig(seed=i, max_iters=2,
                                       delta0_frac=0.1, test_frac=0.2))
             for i in range(4)]
    m = MetricsRegistry()
    orch = build_fleet(x, y, specs, service=AMAZON, trace_dir=d,
                       concurrent=True, metrics=m, device="cpu",
                       engine_kw=dict(epochs=2, score_microbatch=128,
                                      sweep_page=128))
    try:
        orch.run()
    finally:
        m.write_prometheus(os.path.join(d, "metrics.prom"))
        orch.close()
    return d


def test_fleet_metrics_stream_separate_and_attributed(fleet_dir):
    from repro_torch.trace.store import read_trace
    events = read_trace(os.path.join(fleet_dir, "metrics.jsonl"))
    assert events and all(e.kind in ("metric_span", "metric_snapshot")
                          for e in events)
    roll = span_rollup(events)
    assert {t for (_, t) in roll if t} == {"t0", "t1", "t2", "t3"}
    assert all(("round", f"t{i}") in roll for i in range(4))
    snap = [e.payload["snapshot"] for e in events
            if e.kind == "metric_snapshot"][-1]
    rates = cache_hit_rates(snap)
    assert "scoring" in rates and rates["scoring"]["hits"] > 0
    assert "fit" in rates and rates["fit"]["hits"] > 0
    assert "compiled_programs" in {g["name"] for g in snap["gauges"]}


def test_tenant_decision_streams_stay_clean_under_metrics(fleet_dir,
                                                          tmp_path):
    from repro_torch.core import AMAZON, LiveTask, MCALCampaign, MCALConfig
    from repro_torch.data.synth import make_classification
    from repro_torch.trace import TraceStore, diff
    x, y = make_classification(400, num_classes=4, difficulty=0.3, seed=0)
    task = LiveTask(features=x, groundtruth=y, num_classes=4, seed=0,
                    epochs=2, score_microbatch=128, sweep_page=128,
                    device="cpu")
    camp = MCALCampaign(task, AMAZON,
                        MCALConfig(seed=0, max_iters=2, delta0_frac=0.1,
                                   test_frac=0.2))
    solo = tmp_path / "solo.jsonl"
    with TraceStore(str(solo), "t0") as tr:
        camp.attach_trace(tr)
        camp.run()
    camp.close()
    assert diff(str(solo), os.path.join(fleet_dir, "t0.jsonl")) is None


def test_report_metrics_panel_fleet(fleet_dir, capsys):
    from repro_torch.launch import report
    report.main([fleet_dir, "--metrics"])
    out = capsys.readouterr().out
    for t in ("t0", "t1", "t2", "t3"):
        assert f"campaign {t}" in out
    assert "== metrics ==" in out and "tenant" in out
    assert "compile cache:" in out
    prom = open(os.path.join(fleet_dir, "metrics.prom")).read()
    assert "# TYPE repro_span_seconds histogram" in prom


def test_report_watch_tolerates_vanished_trace(live_runs, tmp_path):
    import shutil

    from repro_torch.launch import report
    p_on = live_runs["margin"]["on"]
    target = tmp_path / "late.jsonl"
    done = []

    def watcher():
        report.main([str(target), "--watch", "0.05"])
        done.append(True)

    th = threading.Thread(target=watcher)
    th.start()
    time.sleep(0.15)                 # a few failing polls
    shutil.copy(p_on, target)        # the trace appears
    th.join(timeout=30.0)
    assert done, "watch loop did not recover after the trace appeared"


def test_report_non_watch_still_raises_on_missing(tmp_path):
    from repro_torch.launch import report
    with pytest.raises(OSError):
        report.main([str(tmp_path / "nope.jsonl")])


def test_queue_stats_rollup():
    m = MetricsRegistry()
    m.add_gauge("queue_depth", 1, queue="annotation")
    m.observe("queue_wait_seconds", 0.2, queue="annotation")
    m.observe("queue_wait_seconds", 0.4, queue="annotation")
    st = queue_stats(m.snapshot())["annotation"]
    assert st["depth"] == 1.0 and st["waits"] == 2
    assert st["wait_mean"] == pytest.approx(0.3)
    assert st["wait_max"] == pytest.approx(0.4)
