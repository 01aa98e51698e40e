"""The port's operator report (``repro_torch.launch.report``), held
against the JAX package's ``repro.launch.report``.

Both read the one trace schema, so each package's report must render the
other's traces exactly as its own: for a solo campaign trace and a fleet
trace directory from either package, with and without the ``--metrics``
and ``--health`` panels, the port's ``--json`` output equals the
reference's (exact JSON equality) and so does the text view.  ``--watch``
waits for a trace that has not appeared yet, and stops once every
campaign has committed.
"""
import json
import os
import shutil
import threading
import time

import pytest

from repro.launch import report as jreport
from repro_torch.launch import report

POOL = 320
CLASSES = 3
ENGINE_KW = dict(epochs=2, score_microbatch=128, sweep_page=128)
SLO = dict(cost_per_label_max=0.02, projected_quality_min=0.99)


def _solo(pkg, path):
    """A noisy async live campaign with metric events and the health
    engine's alerts interleaved into its trace."""
    if pkg == "jax":
        import repro.obs as obs
        from repro.annotation import make_annotation_service as mk
        from repro.core import AMAZON, MCALCampaign, MCALConfig
        from repro.core.task import LiveTask
        from repro.trace import TraceStore
        kw = {}
    else:
        import repro_torch.obs as obs
        from repro_torch.annotation import make_annotation_service as mk
        from repro_torch.core import (AMAZON, LiveTask, MCALCampaign,
                                      MCALConfig)
        from repro_torch.trace import TraceStore
        kw = {"device": "cpu"}
    from repro_torch.data.synth import make_classification
    x, y = make_classification(POOL, num_classes=CLASSES, difficulty=0.3,
                               seed=0)
    ann = mk(CLASSES, noise=0.2, repeats=3, aggregator="ds",
             pricing=AMAZON, seed=0, **kw)
    task = LiveTask(features=x, groundtruth=y, num_classes=CLASSES,
                    epochs=2, score_microbatch=64, sweep_page=64, seed=0,
                    annotation=ann, **kw)
    cfg = MCALConfig(seed=0, max_iters=3, delta0_frac=0.1, test_frac=0.2,
                     sweep_async=True, fit_async=True,
                     label_quality=ann.expected_quality())
    camp = MCALCampaign(task, AMAZON, cfg)
    m = obs.MetricsRegistry()
    with TraceStore(path, f"report-{pkg}") as tr:
        m.attach_trace(tr)
        camp.attach_trace(tr)
        camp.attach_metrics(m)
        camp.attach_health(obs.HealthEngine(obs.SLOSpec(**SLO)))
        try:
            camp.run()
        finally:
            camp.close()
        m.emit_snapshot(scope="campaign")


def _fleet(pkg, d):
    """An instrumented, monitored N=3 fleet: tenant traces, fleet.jsonl
    (with the health engine's alerts) and metrics.jsonl."""
    from repro_torch.data.synth import make_classification
    x, y = make_classification(POOL, num_classes=CLASSES, difficulty=0.3,
                               seed=0)
    if pkg == "jax":
        import repro.obs as obs
        from repro.core import AMAZON, MCALConfig
        from repro.core.tenant import TenantSpec
        from repro.launch.orchestrator import build_fleet
        kw = {}
    else:
        import repro_torch.obs as obs
        from repro_torch.core import AMAZON, MCALConfig
        from repro_torch.core.tenant import TenantSpec
        from repro_torch.launch.orchestrator import build_fleet
        kw = {"device": "cpu"}
    specs = [TenantSpec(f"t{i}", priority=i, seed=i,
                        cfg=MCALConfig(seed=i, max_iters=2,
                                       delta0_frac=0.1, test_frac=0.2))
             for i in range(3)]
    orch = build_fleet(x, y, specs, service=AMAZON, trace_dir=d,
                       concurrent=True, metrics=obs.MetricsRegistry(),
                       health=obs.HealthEngine(obs.SLOSpec(**SLO)),
                       engine_kw=ENGINE_KW, **kw)
    try:
        orch.run()
    finally:
        orch.close()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("report")
    out = {}
    for pkg in ("port", "jax"):
        out[f"{pkg}-solo"] = str(d / f"{pkg}.jsonl")
        _solo(pkg, out[f"{pkg}-solo"])
        out[f"{pkg}-fleet"] = str(d / f"{pkg}-fleet")
        _fleet(pkg, out[f"{pkg}-fleet"])
    return out


def _both(argv, capsys):
    report.main(list(argv))
    mine = capsys.readouterr().out
    jreport.main(list(argv))
    return mine, capsys.readouterr().out


PANELS = [[], ["--metrics"], ["--health"], ["--metrics", "--health"]]


@pytest.mark.parametrize("which", ["port-solo", "jax-solo", "port-fleet",
                                   "jax-fleet"])
@pytest.mark.parametrize("panels", PANELS, ids=["plain", "metrics",
                                                "health", "both"])
def test_json_equals_the_reference(traces, which, panels, capsys):
    mine, ref = _both([traces[which], "--json"] + panels, capsys)
    assert json.loads(mine) == json.loads(ref)
    blob = json.loads(mine)
    if "--metrics" in panels:
        assert blob["metrics"]["spans"]
        assert blob["metrics"]["snapshot"]["counters"]
    if "--health" in panels:
        assert blob["health"]["alerts_raised"] > 0


@pytest.mark.parametrize("which", ["port-solo", "jax-solo", "port-fleet",
                                   "jax-fleet"])
def test_text_view_equals_the_reference(traces, which, capsys):
    mine, ref = _both([traces[which], "--metrics", "--health"], capsys)
    # the span table orders rows by recorded seconds; both renderers
    # read the same events, so the whole text is equal
    assert mine == ref
    assert "== metrics ==" in mine and "== health ==" in mine


def test_solo_summary_reads_the_campaign(traces):
    s = report.summarize(traces["port-solo"])
    assert s["status"] == "committed"
    assert s["iterations"] and s["ledger"]["human_votes"] > 0
    assert s["annotator"] and s["fits"]["submitted"] > 0
    assert s == jreport.summarize(traces["port-solo"])


def test_metrics_file_option(traces, capsys):
    fleet = traces["port-fleet"]
    mfile = os.path.join(fleet, "metrics.jsonl")
    argv = [os.path.join(fleet, "t0.jsonl"), "--json", "--metrics",
            "--metrics-file", mfile]
    mine, ref = _both(argv, capsys)
    assert json.loads(mine) == json.loads(ref)
    assert {r["tenant"] for r in json.loads(mine)["metrics"]["spans"]} \
        >= {"t0", "t1", "t2"}


def test_watch_waits_for_a_trace_that_appears(traces, tmp_path):
    target = tmp_path / "late.jsonl"
    done = []

    def watcher():
        report.main([str(target), "--watch", "0.05"])
        done.append(True)

    th = threading.Thread(target=watcher)
    th.start()
    time.sleep(0.15)                 # a few polls find nothing
    shutil.copy(traces["jax-solo"], target)
    th.join(timeout=30.0)
    assert done, "watch loop did not recover after the trace appeared"


def test_watch_on_a_fleet_dir_stops_once_all_committed(traces, capsys):
    report.main([traces["port-fleet"], "--watch", "0.05"])
    out = capsys.readouterr().out
    assert out.count("COMMITTED") == 3


def test_missing_trace_raises_without_watch(tmp_path):
    with pytest.raises(OSError):
        report.main([str(tmp_path / "nope.jsonl")])
    empty = tmp_path / "fleet"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        report.main([str(empty)])
