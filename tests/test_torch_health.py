"""The port's health layer (``repro_torch.obs.health``/``obs.slo``) and the
fleet's SLO enforcement, held against the JAX package's
(``tests/test_health.py``).

* the reference's pure cases — SLO specs and verdicts, hysteresis cells,
  detector math, ``_enforce_slo``'s strike escalation — on the port's
  copies;
* the same sample streams (seeded, many tenants, every detector) give the
  port's ``HealthEngine`` and the reference's the same events, payloads
  included, and the same enforcement walks give the same downgrades;
* a monitored noisy replay campaign emits the reference's alert sequence
  and diffs clean against its monitor-off sibling; over-SLO fleets emit
  the reference's alert and downgrade sequences, deterministically.
All exact: the layer is host code over equal inputs.
"""
import json
import os

import numpy as np
import pytest

import repro.core.tenant as jtenant
import repro.obs as jobs
from repro_torch.obs import (ALERT_KINDS, HealthConfig, HealthEngine, SLOSpec,
                             alert_sequence, evaluate_slo, hist_quantile)


# ---------------------------------------------------------------- SLO spec

def test_slo_spec_rejects_unknown_clause():
    with pytest.raises(ValueError, match="unknown SLO clause"):
        SLOSpec.from_dict({"cost_per_label_max": 0.1, "latencyy": 1.0})


def test_slo_spec_rejects_nonpositive():
    with pytest.raises(ValueError, match="must be positive"):
        SLOSpec.from_dict({"cost_per_label_max": 0.0})


def test_slo_spec_load_and_clauses(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text(json.dumps({"cost_per_label_max": 0.15,
                             "projected_quality_min": 0.8}))
    spec = SLOSpec.load(str(p))
    assert spec.cost_per_label_max == 0.15
    assert spec.iteration_p95_max is None
    # evaluation order is fixed regardless of JSON key order
    assert spec.clauses() == ["cost_per_label", "projected_quality"]


def test_evaluate_slo_verdicts():
    spec = SLOSpec(cost_per_label_max=0.1, iteration_p95_max=2.0,
                   projected_quality_min=0.9)
    obs = {"tenant": "t0", "cost_per_label": 0.5, "iteration_p95": 3.0,
           "projected_quality": 0.5}
    v = evaluate_slo(spec, obs)
    assert [x["slo"] for x in v] == ["cost_per_label", "iteration_p95",
                                    "projected_quality"]
    by = {x["slo"]: x for x in v}
    assert by["cost_per_label"]["enforceable"] is True
    assert by["projected_quality"]["enforceable"] is True
    # wall-clock latency alerts but never drives the cascade
    assert by["iteration_p95"]["enforceable"] is False


def test_evaluate_slo_skips_unmeasured():
    spec = SLOSpec(cost_per_label_max=0.1, iteration_p95_max=2.0,
                   projected_quality_min=0.9)
    # nothing measurable yet (no labels, metrics off, no fits) -> no
    # breaches, not "everything breached"
    assert evaluate_slo(spec, {"tenant": "", "cost_per_label": None,
                               "iteration_p95": None,
                               "projected_quality": None}) == []
    assert evaluate_slo(None, {"tenant": ""}) == []


def test_hist_quantile():
    h = {"buckets": [0.1, 1.0, 10.0], "counts": [5, 4, 1],
         "count": 10, "sum": 4.0, "min": 0.01, "max": 7.5}
    assert hist_quantile(h, 0.5) == 0.1
    assert hist_quantile(h, 0.95) == 10.0
    assert hist_quantile({"buckets": [], "counts": [], "count": 0},
                         0.5) is None


# ------------------------------------------------- hysteresis cells (pure)

class _Sink:
    """Minimal trace duck-type: record emitted events."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


def _drift_sample(observed, tenant=""):
    return {"tenant": tenant, "spent": 0.0, "budget": None, "done": False,
            "assumed_residual": 0.1, "observed_residual": observed}


def test_flapping_metric_one_alert_one_clear():
    """The headline dedup/hysteresis contract: a metric flapping across
    its threshold every tick produces ONE alert; only sustained health
    clears it (one alert_clear)."""
    tr = _Sink()
    eng = HealthEngine(config=HealthConfig(drift_tol=0.05), trace=tr)
    for observed in (0.2, 0.1, 0.2, 0.1, 0.2, 0.1):   # flap 3x
        eng.tick_samples([_drift_sample(observed)])
    for _ in range(2):                                # sustained health
        eng.tick_samples([_drift_sample(0.1)])
    kinds = [k for k, _ in tr.events]
    assert kinds == ["alert", "alert_clear"]
    assert eng.counts()["alerts_raised"] == 1
    assert eng.counts()["alerts_cleared"] == 1
    assert eng.active() == []


def test_sustained_breach_emits_once():
    tr = _Sink()
    eng = HealthEngine(config=HealthConfig(), trace=tr)
    for _ in range(5):
        eng.tick_samples([_drift_sample(0.3)])
    assert [k for k, _ in tr.events] == ["alert"]
    assert eng.active() == [("", "annotator_drift")]


def test_up_ticks_delays_raise():
    tr = _Sink()
    eng = HealthEngine(config=HealthConfig(up_ticks=2), trace=tr)
    eng.tick_samples([_drift_sample(0.3)])
    assert tr.events == []               # one breach is not yet an alert
    eng.tick_samples([_drift_sample(0.3)])
    assert [k for k, _ in tr.events] == ["alert"]


def test_burn_eta_math_and_payload():
    tr = _Sink()
    eng = HealthEngine(config=HealthConfig(burn_horizon=3.0), trace=tr)

    def tick(spent):
        eng.tick_samples([{"tenant": "t", "spent": spent, "budget": 10.0,
                           "done": False, "assumed_residual": 0.0}])

    tick(2.0)    # burn 2, remaining 8, eta 4 -> healthy
    assert tr.events == []
    tick(5.0)    # burn 3, remaining 5, eta 1.67 -> fires (warn)
    assert len(tr.events) == 1
    kind, p = tr.events[0]
    assert kind == "alert" and p["detector"] == "budget_burn"
    assert p["severity"] == "warn"
    assert p["eta_rounds"] == pytest.approx(5.0 / 3.0)
    tick(9.0)    # still firing: deduplicated, no second event
    assert len(tr.events) == 1


def test_burn_skips_uncapped_and_done():
    tr = _Sink()
    eng = HealthEngine(trace=tr)
    eng.tick_samples([{"tenant": "t", "spent": 99.0, "budget": None,
                       "done": False, "assumed_residual": 0.0}])
    eng.tick_samples([{"tenant": "t", "spent": 99.0, "budget": 1.0,
                       "done": True, "assumed_residual": 0.0}])
    assert tr.events == []


def test_telemetry_detectors_first_sample_is_baseline():
    """cache_storm / fault_pressure / queue_saturation judge counter
    DELTAS — the first sample only establishes the baseline (startup
    compiles are not a storm), queues are judged immediately."""
    tr = _Sink()
    eng = HealthEngine(config=HealthConfig(cache_miss_burst=8.0,
                                           queue_depth_max=64.0), trace=tr)
    eng.tick_samples([{"tenant": "", "counters":
                       {"pack_cache_misses_total": 50.0,
                        "pack_cache_hits_total": 0.0}, "queues": {}}])
    assert tr.events == []               # baseline, not a 50-miss storm
    eng.tick_samples([{"tenant": "", "counters":
                       {"pack_cache_misses_total": 62.0,
                        "pack_cache_hits_total": 3.0},
                       "queues": {"sweep": {"depth": 100.0}}}])
    by = {p["detector"]: (k, p) for k, p in tr.events}
    assert by["cache_storm"][0] == "alert"
    assert by["cache_storm"][1]["misses"] == 12.0
    assert by["queue_saturation"][1]["depth"] == 100.0
    # one straggler/quarantine is instant critical fault pressure
    eng.tick_samples([{"tenant": "", "counters":
                       {"pack_cache_misses_total": 62.0,
                        "pack_cache_hits_total": 3.0,
                        "straggler_timeouts_total": 1.0}, "queues": {}}])
    fp = [p for k, p in tr.events if p.get("detector") == "fault_pressure"]
    assert fp and fp[0]["severity"] == "critical"


def test_slo_breach_stream_raises_and_clears():
    tr = _Sink()
    eng = HealthEngine(SLOSpec(cost_per_label_max=0.1), trace=tr)

    def tick(cpl):
        eng.tick_samples([{"tenant": "a", "spent": 1.0, "budget": None,
                           "done": False, "assumed_residual": 0.0,
                           "cost_per_label": cpl}])

    tick(0.5)
    tick(0.5)
    tick(0.05)
    tick(0.05)
    kinds = [k for k, _ in tr.events]
    assert kinds == ["slo_breach", "alert_clear"]
    assert eng.counts()["slo_breaches"] == 1
    assert tr.events[0][1]["limit"] == 0.1


# ------------------------------------- controller enforcement (FakeTenant)

class FakeTenant:
    """Controller-facing duck-type of :class:`repro_torch.core.tenant.Tenant`
    (the test_orchestrator pattern) — ledger hand-set, downgrade
    semantics mirrored."""

    def __init__(self, tenant_id, priority=0, allocation=None,
                 spent=0.0, ask=0.0, shrinkable=False):
        self.tenant_id = tenant_id
        self.priority = priority
        self.allocation = allocation
        self.paused = False
        self.votes_shrunk = False
        self.forced = False
        self._spent = float(spent)
        self._ask = float(ask)
        self._shrinkable = shrinkable

    @property
    def spent(self):
        return self._spent

    @property
    def done(self):
        return self.forced

    @property
    def running(self):
        return not self.forced

    def next_spend(self):
        if self.forced or self.paused:
            return 0.0
        return self._ask * (0.5 if self.votes_shrunk else 1.0)

    def apply_downgrade(self, action):
        if not self.running:
            return False
        if action == "pause":
            if self.paused:
                return False
            self.paused = True
            return True
        if action == "shrink_votes":
            if self.votes_shrunk or not self._shrinkable:
                return False
            self.votes_shrunk = True
            return True
        if action == "force_commit":
            self.forced = True
            return True
        raise ValueError(action)


def _breach(tenant, slo="cost_per_label", enforceable=True):
    return {"tenant": tenant, "slo": slo, "value": 1.0, "limit": 0.1,
            "enforceable": enforceable}


def test_enforce_slo_strike_escalation():
    """Per-tenant strikes escalate one cascade step per breached
    rebalance: pause, then shrink_votes, then force_commit."""
    from repro_torch.core.tenant import FleetController

    t = FakeTenant("a", ask=1.0, shrinkable=True)
    ctl = FleetController([t], slo_enforce=True)
    a1 = ctl._enforce_slo([_breach("a")])
    assert [d["action"] for d in a1] == ["pause"] and t.paused
    t.paused = False                     # rebalance lifts the pause
    a2 = ctl._enforce_slo([_breach("a")])
    assert [d["action"] for d in a2] == ["shrink_votes"] and t.votes_shrunk
    a3 = ctl._enforce_slo([_breach("a")])
    assert [d["action"] for d in a3] == ["force_commit"] and t.forced
    assert a3[0]["slo"] == "cost_per_label"
    # a dead tenant takes no further action
    assert ctl._enforce_slo([_breach("a")]) == []


def test_enforce_slo_skips_advisory_and_walks_cascade_order():
    from repro_torch.core.tenant import FleetController

    lo = FakeTenant("lo", priority=0, ask=1.0)
    hi = FakeTenant("hi", priority=1, ask=1.0)
    ctl = FleetController([hi, lo], slo_enforce=True)
    # advisory (wall-clock) breaches never downgrade anyone
    assert ctl._enforce_slo([_breach("lo", slo="iteration_p95",
                                     enforceable=False)]) == []
    # both breach: walk order is (priority asc, tenant_id asc)
    applied = ctl._enforce_slo([_breach("hi"), _breach("lo")])
    assert [d["tenant"] for d in applied] == ["lo", "hi"]
    assert lo.paused and hi.paused



# ------------------------------------------ the same streams, both packages

def _stream(seed, ticks=24, tenants=("a", "b", "c")):
    """Seeded samples that walk every detector across its thresholds:
    budget burn, annotator drift, fit quality, cache storms, queue
    saturation, fault pressure and the SLO clauses."""
    rng = np.random.default_rng(seed)
    spent = {t: 0.0 for t in tenants}
    counters = {"pack_cache_misses_total": 0.0,
                "pack_cache_hits_total": 0.0,
                "straggler_timeouts_total": 0.0,
                "tenants_quarantined_total": 0.0,
                "faults_injected_total": 0.0, "retries_total": 0.0}
    out = []
    for _ in range(ticks):
        tick = []
        for t in tenants:
            spent[t] += float(rng.uniform(0.0, 4.0))
            labels = int(rng.integers(0, 200))
            tick.append({
                "tenant": t, "spent": spent[t], "labels": labels,
                "cost_per_label": (spent[t] / labels if labels else None),
                "budget": float(rng.choice([20.0, 60.0, 1e9])),
                "done": bool(rng.random() < 0.05),
                "assumed_residual": 0.1,
                "observed_residual": float(rng.uniform(0.0, 0.3)),
                "fit_resid": float(rng.uniform(0.0, 0.5)),
                "projected_quality": float(rng.uniform(0.6, 1.0)),
                "iteration_p95": float(rng.uniform(0.0, 3.0))})
        for k in counters:
            counters[k] += float(rng.integers(0, 3) * rng.integers(0, 8))
        tick.append({"tenant": "", "counters": dict(counters),
                     "queues": {"annotation": {
                         "depth": float(rng.integers(0, 100))}}})
        out.append(tick)
    return out


class _JSink:
    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cfg", [dict(), dict(up_ticks=2, down_ticks=3),
                                 dict(drift_tol=0.02, burn_horizon=5.0)])
def test_alerts_equal_reference_on_the_same_streams(seed, cfg):
    slo = dict(cost_per_label_max=0.05, iteration_p95_max=2.0,
               projected_quality_min=0.8)
    mine, ref = _Sink(), _JSink()
    eng = HealthEngine(SLOSpec(**slo), config=HealthConfig(**cfg),
                       trace=mine)
    jeng = jobs.HealthEngine(jobs.SLOSpec(**slo),
                             config=jobs.HealthConfig(**cfg), trace=ref)
    for samples in _stream(seed):
        got = eng.tick_samples([dict(s) for s in samples])
        want = jeng.tick_samples([dict(s) for s in samples])
        assert got == want
    assert mine.events == ref.events
    assert mine.events, "the stream never crossed a threshold"
    assert eng.counts() == jeng.counts()
    assert eng.active() == jeng.active()


def test_slo_verdicts_equal_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        kw = {k: float(v) for k, v in zip(
            ("cost_per_label_max", "iteration_p95_max",
             "projected_quality_min"), rng.uniform(0.01, 1.0, 3))
            if rng.random() < 0.7}
        obs = {"tenant": "t", "cost_per_label": float(rng.uniform(0, 1)),
               "iteration_p95": (float(rng.uniform(0, 2))
                                 if rng.random() < 0.8 else None),
               "projected_quality": float(rng.uniform(0, 1))}
        assert evaluate_slo(SLOSpec(**kw), obs) == \
            jobs.evaluate_slo(jobs.SLOSpec(**kw), obs)


def _walk(ctl_cls, seed):
    rng = np.random.default_rng(seed)
    tenants = [FakeTenant(f"t{i}", priority=int(rng.integers(0, 3)),
                          ask=1.0, shrinkable=bool(rng.random() < 0.5))
               for i in range(6)]
    ctl = ctl_cls(tenants, slo_enforce=True)
    applied = []
    for _ in range(5):
        for t in tenants:
            t.paused = False
        verdicts = [_breach(t.tenant_id, enforceable=bool(rng.random()
                                                          < 0.8))
                    for t in tenants if rng.random() < 0.6]
        applied.append(ctl._enforce_slo(verdicts))
    return applied


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enforce_slo_walk_equals_reference(seed):
    assert _walk(__import__("repro_torch.core.tenant",
                            fromlist=["FleetController"]).FleetController,
                 seed) == _walk(jtenant.FleetController, seed)


# --------------------------------------------- a monitored replay campaign

POOL = 2000


def _solo_campaign(pkg, trace_path, health):
    if pkg == "jax":
        from repro.annotation import make_annotation_service as mk
        from repro.core import AMAZON, MCALConfig, make_emulated_task
        from repro.core.mcal import MCALCampaign
        from repro.trace import TraceStore
        kw = {}
    else:
        from repro_torch.annotation import make_annotation_service as mk
        from repro_torch.core import (AMAZON, MCALCampaign, MCALConfig,
                                      make_emulated_task)
        from repro_torch.trace import TraceStore
        kw = {"device": "cpu"}
    ann = mk(10, noise=0.2, repeats=3, max_repeats=5, adaptive=True,
             aggregator="ds", pricing=AMAZON, seed=0, **kw)
    task = make_emulated_task("cifar10", "resnet18", seed=0,
                              pool_size=POOL, **kw)
    task.annotation = ann
    cfg = MCALConfig(seed=0, delta0_frac=0.1,
                     label_quality=ann.expected_quality())
    camp = MCALCampaign(task, AMAZON, cfg)
    with TraceStore(trace_path, "health-solo") as tr:
        camp.attach_trace(tr)
        if health is not None:
            camp.attach_health(health)
        return camp.run()


def _breachable(H):
    return H.HealthEngine(H.SLOSpec(cost_per_label_max=0.02,
                                    projected_quality_min=0.99))


@pytest.fixture(scope="module")
def solo_runs(tmp_path_factory):
    """A noisy replay campaign: the port monitor-off and monitored with a
    breachable SLO, and the reference monitored."""
    import repro_torch.obs as pobs
    d = tmp_path_factory.mktemp("health_solo")
    off, on, ref = (str(d / "off.jsonl"), str(d / "on.jsonl"),
                    str(d / "jax.jsonl"))
    res_off = _solo_campaign("port", off, None)
    eng = _breachable(pobs)
    res_on = _solo_campaign("port", on, eng)
    jeng = _breachable(jobs)
    res_ref = _solo_campaign("jax", ref, jeng)
    return {"off": off, "on": on, "jax": ref, "res_off": res_off,
            "res_on": res_on, "res_ref": res_ref, "engine": eng,
            "jengine": jeng}


def test_solo_health_attached_diff_clean(solo_runs):
    from repro_torch.trace import diff
    assert diff(solo_runs["off"], solo_runs["on"]) is None
    assert (solo_runs["res_on"].total_cost
            == solo_runs["res_off"].total_cost)


def test_solo_health_alerts_equal_reference(solo_runs):
    seq = alert_sequence(solo_runs["on"])
    assert seq, "judgment stream missing from the trace"
    assert any(s["detector"] == "slo:cost_per_label" for s in seq)
    assert seq == jobs.alert_sequence(solo_runs["jax"])
    assert solo_runs["engine"].counts() == solo_runs["jengine"].counts()
    assert alert_sequence(solo_runs["off"]) == []
    assert solo_runs["res_on"].total_cost == solo_runs["res_ref"].total_cost


def test_report_health_panel_solo(solo_runs, capsys):
    from repro_torch.launch import report
    report.main([solo_runs["on"], "--health"])
    out = capsys.readouterr().out
    assert "== health ==" in out
    assert "slo:cost_per_label" in out
    report.main([solo_runs["off"], "--health"])
    assert "no health events" in capsys.readouterr().out


# --------------------------------------------------------- over-SLO fleets

N_TENANTS = 4
ENGINE_KW = dict(epochs=2, score_microbatch=128, sweep_page=128)


def _fleet(pkg, trace_dir, *, cost_cap, slo_enforce=True,
           global_budget=None, budget=None):
    from repro_torch.data.synth import make_classification
    x, y = make_classification(400, num_classes=4, difficulty=0.3, seed=0)
    if pkg == "jax":
        from repro.core import AMAZON, MCALConfig
        from repro.core.tenant import TenantSpec
        from repro.launch.orchestrator import build_fleet
        H, kw = jobs, {}
    else:
        import repro_torch.obs as H
        from repro_torch.core import AMAZON, MCALConfig
        from repro_torch.core.tenant import TenantSpec
        from repro_torch.launch.orchestrator import build_fleet
        kw = {"device": "cpu"}
    specs = [TenantSpec(f"t{i}", priority=i % 2, seed=i, budget=budget,
                        cfg=MCALConfig(seed=i, max_iters=2,
                                       delta0_frac=0.1, test_frac=0.2))
             for i in range(N_TENANTS)]
    health = (H.HealthEngine(H.SLOSpec(cost_per_label_max=cost_cap))
              if cost_cap is not None else None)
    orch = build_fleet(x, y, specs, service=AMAZON, trace_dir=trace_dir,
                       concurrent=False, health=health,
                       slo_enforce=slo_enforce and health is not None,
                       global_budget=global_budget, engine_kw=ENGINE_KW,
                       **kw)
    try:
        orch.run()
    finally:
        orch.close()


@pytest.fixture(scope="module")
def slo_fleets(tmp_path_factory):
    """Over-SLO fleets with enforcement on (every tenant breaches a tiny
    cost-per-label ceiling): the port twice, the reference once."""
    d = {}
    for tag, pkg in (("a", "port"), ("b", "port"), ("jax", "jax")):
        d[tag] = str(tmp_path_factory.mktemp(f"slo_fleet_{tag}"))
        _fleet(pkg, d[tag], cost_cap=0.001)
    return d


def test_slo_enforcement_deterministic_and_equal_reference(slo_fleets):
    from repro_torch.core.tenant import downgrade_sequence
    fl = {k: os.path.join(v, "fleet.jsonl") for k, v in slo_fleets.items()}
    sa = json.dumps(alert_sequence(fl["a"]))
    assert sa == json.dumps(alert_sequence(fl["b"])) != "[]"
    assert sa == json.dumps(jobs.alert_sequence(fl["jax"]))
    ga = downgrade_sequence(fl["a"])
    assert ga and ga == downgrade_sequence(fl["b"])
    assert ga == jtenant.downgrade_sequence(fl["jax"])


def test_slo_downgrades_carry_slo_and_terminate(slo_fleets):
    from repro_torch.trace.store import read_trace
    events = [e for e in read_trace(os.path.join(slo_fleets["a"],
                                                 "fleet.jsonl"))
              if e.kind == "downgrade"]
    slo_events = [e for e in events if "slo" in e.payload]
    assert {e.payload["slo"] for e in slo_events} == {"cost_per_label"}
    forced = {e.payload["tenant"] for e in events
              if e.payload["action"] == "force_commit"}
    assert forced == {f"t{i}" for i in range(N_TENANTS)}
    for i in range(N_TENANTS):
        tenant = read_trace(os.path.join(slo_fleets["a"], f"t{i}.jsonl"))
        assert not [e for e in tenant if e.kind in ALERT_KINDS]


@pytest.fixture(scope="module")
def budget_fleets(tmp_path_factory):
    """An over-budget fleet (the ceiling between spent and projected) with
    the health engine armed but its SLO not breached, monitored and
    monitor-off."""
    on = str(tmp_path_factory.mktemp("budget_fleet_on"))
    _fleet("port", on, cost_cap=100.0, global_budget=21.0, budget=20.0)
    off = str(tmp_path_factory.mktemp("budget_fleet_off"))
    _fleet("port", off, cost_cap=None, global_budget=21.0, budget=20.0)
    return on, off


def test_over_budget_fleet_alerts_and_diff_clean(budget_fleets, capsys):
    from repro_torch.core.tenant import downgrade_sequence
    from repro_torch.launch import report
    from repro_torch.trace import diff
    on, off = budget_fleets
    seq = alert_sequence(os.path.join(on, "fleet.jsonl"))
    assert any(s["detector"] == "budget_burn" for s in seq), seq
    assert downgrade_sequence(os.path.join(on, "fleet.jsonl"))
    assert (downgrade_sequence(os.path.join(on, "fleet.jsonl"))
            == downgrade_sequence(os.path.join(off, "fleet.jsonl")))
    for i in range(N_TENANTS):
        assert diff(os.path.join(on, f"t{i}.jsonl"),
                    os.path.join(off, f"t{i}.jsonl")) is None
    report.main([on, "--health"])
    assert "budget_burn" in capsys.readouterr().out
