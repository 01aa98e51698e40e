"""The port's multi-tenant fleet (``repro_torch.launch.orchestrator``,
``repro_torch.core.tenant``), held against the JAX package's
(``tests/test_orchestrator.py``), at that test's size (320 rows, 3
classes, 2 epochs).

* **concurrent == serial**: an N=8 fleet over ONE shared engine bundle
  gives per-tenant decision streams identical to the same fleet run
  serially (``diff`` clean per tenant, exact);
* **against the JAX fleet**: the same specs, the port's retrains fed the
  reference's init and epoch orders (``fit_sources``, the
  ``LiveTask.fit_source`` seam).  A tenant's trace diffs clean against its
  JAX twin, or the first divergence is an acquisition whose order differs
  from the JAX one only among candidates closer than the two packages'
  score difference (the fp32 training drift pinned since the first slice:
  the same init and orders leave margins up to about 4e-4 apart, and
  candidates that close can swap).  Where the JAX package's own ranking
  has a near tie, neither order is more right;
* **the capped fleet**: the downgrade cascade is deterministic and equal
  to the JAX package's (``downgrade_sequence`` and the fleet trace under
  ``FLEET_KINDS``);
* ``fleet_report`` of a trace directory equals the JAX package's
  ``fleet_report`` of the same directory, for either package's traces;
* the controller units and the session-isolation cases of the reference
  test, on the port's copies.
"""
import os
import types

import numpy as np
import pytest

from repro_torch.core import MCALConfig
from repro_torch.core.tenant import (DOWNGRADE_ACTIONS, FLEET_KINDS,
                                     FleetController, TenantSpec,
                                     downgrade_sequence)
from repro_torch.trace.replay import diff
from repro_torch.trace.store import read_trace

from test_torch_campaign import _jax_fit_source

POOL = 320
CLASSES = 3
ENGINE_KW = dict(epochs=2, score_microbatch=128, sweep_page=128)


def _data(n=POOL, seed=0):
    from repro_torch.data.synth import make_classification
    return make_classification(n, num_classes=CLASSES, difficulty=0.3,
                               seed=seed)


def _cfg(pkg="port", **kw):
    base = dict(max_iters=2, delta0_frac=0.1, test_frac=0.2)
    base.update(kw)
    if pkg == "jax":
        from repro.core import MCALConfig as JConfig
        return JConfig(**base)
    return MCALConfig(**base)


def _specs(pkg="port", **extra):
    if pkg == "jax":
        from repro.core.tenant import TenantSpec as Spec
    else:
        Spec = TenantSpec
    return [Spec(f"t{i}", priority=i % 3, seed=i,
                 cfg=_cfg(pkg, seed=i, eps_target=0.05 + 0.01 * (i % 4),
                          **extra))
            for i in range(8)]


def _run_fleet(tmpdir, specs, *, concurrent, global_budget=None,
               annotation=None, fit_sources=None):
    from repro_torch.core import AMAZON
    from repro_torch.launch.orchestrator import build_fleet
    x, y = _data()
    orch = build_fleet(x, y, specs, service=AMAZON,
                       global_budget=global_budget, trace_dir=tmpdir,
                       concurrent=concurrent,
                       annotation_service=annotation,
                       engine_kw=ENGINE_KW, device="cpu",
                       fit_sources=fit_sources)
    try:
        results = orch.run()
    finally:
        orch.close()
    return results, orch


def _run_jax_fleet(tmpdir, specs, *, global_budget=None, annotation=None):
    """The JAX package's fleet, and each tenant's ``fit_source`` for the
    port: the init and epoch orders the JAX fleet's retrains used."""
    from repro.core import AMAZON as JAMAZON
    from repro.launch.orchestrator import build_fleet as jbuild_fleet
    x, y = _data()
    orch = jbuild_fleet(x, y, specs, service=JAMAZON,
                        global_budget=global_budget, trace_dir=tmpdir,
                        concurrent=True, annotation_service=annotation,
                        engine_kw=ENGINE_KW)
    try:
        results = orch.run()
    finally:
        orch.close()
    eng = orch.engines
    sources = {s.tenant_id: _jax_fit_source(types.SimpleNamespace(
        model=eng.model, tc=eng.tc, seed=s.seed,
        batch_size=eng.fit.cfg.batch_size, epochs=eng.fit.cfg.epochs))
        for s in specs}
    return results, sources


# ---------------------------------------------------------------------------
# concurrent == serial, per tenant, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metrics", ["margin", "alternating"])
def test_concurrent_fleet_matches_serial_n8(tmp_path, metrics):
    """The reference's specs; ``alternating`` gives the odd tenants
    k-center, as the card's fleet does."""
    specs = _specs() if metrics == "margin" else [
        TenantSpec(s.tenant_id, priority=s.priority, seed=s.seed,
                   cfg=_cfg(seed=s.seed, eps_target=s.cfg.eps_target,
                            metric="kcenter" if i % 2 else "margin"))
        for i, s in enumerate(_specs())]
    d1, d2 = str(tmp_path / "conc"), str(tmp_path / "serial")
    res_c, orch_c = _run_fleet(d1, specs, concurrent=True)
    res_s, orch_s = _run_fleet(d2, specs, concurrent=False)
    assert set(res_c) == {s.tenant_id for s in specs} == set(res_s)
    for s in specs:
        d = diff(os.path.join(d1, f"{s.tenant_id}.jsonl"),
                 os.path.join(d2, f"{s.tenant_id}.jsonl"))
        assert d is None, f"{s.tenant_id} diverged: {d}"
        assert res_c[s.tenant_id].decision == res_s[s.tenant_id].decision
        assert res_c[s.tenant_id].total_cost == \
            res_s[s.tenant_id].total_cost
        np.testing.assert_array_equal(res_c[s.tenant_id].labels,
                                      res_s[s.tenant_id].labels)
    # one shared bucket set: 8 tenants never built per-tenant ones
    keys = orch_c.engines.cache_keys()
    assert keys["scoring"] and keys["fit"]
    assert keys == orch_s.engines.cache_keys()
    assert orch_c.engines.compiled_count() == \
        len(keys["scoring"]) + len(keys["fit"])


def test_shared_engines_refuse_mismatched_shapes():
    from repro_torch.core.task import LiveTask
    from repro_torch.launch.orchestrator import SharedEngines
    x, y = _data()
    with SharedEngines.build(x.shape[1], CLASSES, device="cpu",
                             **ENGINE_KW) as eng:
        with pytest.raises(AssertionError):
            LiveTask(features=x[:, :-1], groundtruth=y,
                     num_classes=CLASSES, engines=eng, device="cpu")
        with pytest.raises(AssertionError):
            LiveTask(features=x, groundtruth=y, num_classes=CLASSES,
                     engines=eng, fit_resident=True, device="cpu")
        with pytest.raises(AssertionError):
            LiveTask(features=x, groundtruth=y, num_classes=CLASSES + 1,
                     engines=eng, device="cpu")


def test_shared_engines_stay_with_the_fleet(tmp_path):
    """Tenant teardown leaves shared engines up and unwired from its
    trace; the fleet closes them once."""
    from repro_torch.core.task import LiveTask
    from repro_torch.launch.orchestrator import SharedEngines
    from repro_torch.trace import TraceStore
    x, y = _data()
    eng = SharedEngines.build(x.shape[1], CLASSES, device="cpu",
                              **ENGINE_KW)
    task = LiveTask(features=x, groundtruth=y, num_classes=CLASSES,
                    engines=eng, device="cpu")
    with TraceStore(str(tmp_path / "t.jsonl"), "t") as tr:
        task.attach_trace(tr)
    assert eng.sweep.trace is None and eng.fit.trace is None
    assert task._fit is eng.fit and task.model is eng.model
    fut = eng.fit.submit_call(lambda: 5)
    task.close()
    assert fut.result(timeout=5) == 5
    assert eng.fit.submit_call(lambda: 6).result(timeout=5) == 6
    eng.close()
    eng.close()                          # idempotent


# ---------------------------------------------------------------------------
# against the JAX package's fleet
# ---------------------------------------------------------------------------


def _lockstep_first_split(seed, eps_target):
    """Run tenant ``seed``'s campaign solo in both packages in lockstep
    (a fleet tenant's stream is its solo stream) and return, at the first
    acquisition whose picks differ: the candidates, k, both packages'
    margins of them, and both picks."""
    from repro.core import AMAZON as JAMAZON
    from repro.core import MCALCampaign as JCampaign
    from repro.core.task import LiveTask as JLiveTask
    from repro_torch.core import AMAZON, LiveTask, MCALCampaign
    x, y = _data()
    kw = dict(features=x, groundtruth=y, num_classes=CLASSES, seed=seed,
              epochs=ENGINE_KW["epochs"],
              score_microbatch=ENGINE_KW["score_microbatch"],
              sweep_page=ENGINE_KW["sweep_page"])
    jtask = JLiveTask(**kw)
    task = LiveTask(device="cpu", fit_source=_jax_fit_source(jtask), **kw)
    picks = {}

    def recording(t, tag):
        inner = t.topk_candidates

        def topk(metric, k, cand):
            stats, _ = t.score(cand)
            picks[tag] = (np.asarray(cand), k,
                          np.asarray(stats.margin, np.float64),
                          np.asarray(inner(metric, k, cand)))
            return picks[tag][3]
        t.topk_candidates = topk

    recording(jtask, "jax")
    recording(task, "port")
    cfg = dict(seed=seed, eps_target=eps_target)
    jc = JCampaign(jtask, JAMAZON, _cfg("jax", **cfg))
    pc = MCALCampaign(task, AMAZON, _cfg(**cfg))
    try:
        jc.bootstrap()
        pc.bootstrap()
        while not (jc.done or pc.done):
            picks.clear()
            jc.iteration()
            pc.iteration()
            if picks and not np.array_equal(picks["jax"][3],
                                            picks["port"][3]):
                return picks
        return None
    finally:
        jc.close()
        pc.close()


def _split_within_score_error(picks):
    """The two orders differ only among candidates whose JAX margins are
    closer than the largest margin difference between the packages."""
    cand, k, jm, _ = picks["jax"]
    _, _, pm, _ = picks["port"]
    err = float(np.abs(jm - pm).max())
    assert err < 1e-3, err                 # the two classifiers agree
    pos = {int(c): i for i, c in enumerate(cand)}
    jpick = [pos[int(c)] for c in picks["jax"][3]]
    ppick = [pos[int(c)] for c in picks["port"][3]]
    kth = np.sort(jm)[k - 1]
    for r, (a, b) in enumerate(zip(jpick, ppick)):
        if a != b:                         # swapped or exchanged at r
            assert abs(jm[a] - jm[b]) <= 2 * err, (r, jm[a], jm[b], err)
    for c in set(jpick) ^ set(ppick):      # exchanged across the k-th
        assert abs(jm[c] - kth) <= 2 * err, (jm[c], kth, err)
    return err


@pytest.fixture(scope="module")
def jax_twin(tmp_path_factory):
    d = tmp_path_factory.mktemp("twin")
    jdir, pdir = str(d / "jax"), str(d / "port")
    jres, sources = _run_jax_fleet(jdir, _specs("jax"))
    res, _ = _run_fleet(pdir, _specs(), concurrent=True,
                        fit_sources=sources)
    return dict(jdir=jdir, pdir=pdir, jres=jres, res=res)


def test_fleet_diffs_clean_against_the_jax_fleet(jax_twin):
    split = []
    for s in _specs():
        tid = s.tenant_id
        d = diff(os.path.join(jax_twin["pdir"], f"{tid}.jsonl"),
                 os.path.join(jax_twin["jdir"], f"{tid}.jsonl"))
        if d is None:
            res, jres = jax_twin["res"][tid], jax_twin["jres"][tid]
            assert res.decision == jres.decision
            assert res.ledger == jres.ledger
            np.testing.assert_array_equal(res.labels,
                                          np.asarray(jres.labels))
            continue
        assert d.kind_a == d.kind_b == "acquisition" and \
            d.fields == ["digest"], d.describe()
        picks = _lockstep_first_split(s.seed, s.cfg.eps_target)
        assert picks is not None, f"{tid} split in the fleet, not solo"
        _split_within_score_error(picks)
        split.append(tid)
    assert len(split) <= 2, split           # most tenants match exactly


def test_fleet_report_equals_the_jax_fleet_report(jax_twin):
    from repro.launch.orchestrator import fleet_report as jfleet_report
    from repro_torch.launch.orchestrator import fleet_report, render_fleet
    for d in (jax_twin["pdir"], jax_twin["jdir"]):
        rep = fleet_report(d)
        assert rep == jfleet_report(d)
        assert set(rep["tenants"]) == {f"t{i}" for i in range(8)}
        assert rep["fleet"]["rounds"] >= 1
        assert "t7" in render_fleet(rep)


# ---------------------------------------------------------------------------
# the capped fleet: the downgrade cascade, deterministic, = the reference's
# ---------------------------------------------------------------------------


def _cascade_specs(pkg, quality):
    if pkg == "jax":
        from repro.core.tenant import TenantSpec as Spec
    else:
        Spec = TenantSpec
    return [Spec(f"t{i}", priority=i, budget=6.0, seed=i,
                 cfg=_cfg(pkg, max_iters=3, seed=i, label_quality=quality))
            for i in range(3)]


@pytest.fixture(scope="module")
def cascade_runs(tmp_path_factory):
    """The reference's over-ceiling fleet: per-tenant budgets too small, a
    global ceiling the asks breach, a shared annotation service so
    shrink_votes has repeats to halve — twice in the port, once in the
    JAX package."""
    from repro.annotation import make_annotation_service as jmake
    from repro_torch.annotation import make_annotation_service
    jann = jmake(CLASSES, n_workers=5, noise=0.2, repeats=3, seed=0)
    jdir = str(tmp_path_factory.mktemp("cascade_jax"))
    _jres, sources = _run_jax_fleet(
        jdir, _cascade_specs("jax", jann.expected_quality()),
        global_budget=14.0, annotation=jann)

    def run(d):
        ann = make_annotation_service(CLASSES, n_workers=5, noise=0.2,
                                      repeats=3, seed=0, device="cpu")
        res, _ = _run_fleet(d, _cascade_specs("port",
                                              ann.expected_quality()),
                            concurrent=True, global_budget=14.0,
                            annotation=ann, fit_sources=sources)
        return res

    d1 = str(tmp_path_factory.mktemp("cascade1"))
    d2 = str(tmp_path_factory.mktemp("cascade2"))
    return d1, run(d1), d2, run(d2), jdir


def test_cascade_is_deterministic_and_equals_the_reference(cascade_runs):
    from repro.core.tenant import downgrade_sequence as jseq
    from repro.trace.replay import diff as jdiff
    d1, res1, d2, res2, jdir = cascade_runs
    seq1 = downgrade_sequence(os.path.join(d1, "fleet.jsonl"))
    assert seq1, "the ceiling never bound — no cascade to compare"
    assert seq1 == downgrade_sequence(os.path.join(d2, "fleet.jsonl"))
    assert seq1 == jseq(os.path.join(jdir, "fleet.jsonl"))
    assert {e["action"] for e in seq1} == set(DOWNGRADE_ACTIONS)
    assert diff(os.path.join(d1, "fleet.jsonl"),
                os.path.join(d2, "fleet.jsonl"), kinds=FLEET_KINDS) is None
    assert jdiff(os.path.join(d1, "fleet.jsonl"),
                 os.path.join(jdir, "fleet.jsonl"),
                 kinds=FLEET_KINDS) is None
    rank = {a: i for i, a in enumerate(DOWNGRADE_ACTIONS)}
    per_round = {}
    for ev in seq1:
        per_round.setdefault(ev["round"], []).append(ev)
    for evs in per_round.values():
        assert [rank[e["action"]] for e in evs] == \
            sorted(rank[e["action"]] for e in evs)


def test_forced_tenants_finish_with_fleet_ceiling_reason(cascade_runs):
    d1, res1, _d2, _res2, _jdir = cascade_runs
    forced = {e["tenant"] for e in downgrade_sequence(
        os.path.join(d1, "fleet.jsonl")) if e["action"] == "force_commit"}
    assert forced
    for tid in forced:
        events = read_trace(os.path.join(d1, f"{tid}.jsonl"))
        done = [e for e in events if e.kind == "done"]
        assert done and done[-1].payload["reason"] == "fleet_ceiling"
        assert res1[tid].decision in ("hybrid", "human_all")


def test_capped_votes_equal_buy_labels_charges(cascade_runs):
    """Every tenant's session votes are exactly what its campaign ledger
    charged through ``buy_labels``."""
    d1, _res1, _d2, _res2, _jdir = cascade_runs
    final = [e for e in read_trace(os.path.join(d1, "fleet.jsonl"))
             if e.kind == "fleet_done"][-1].payload
    votes = {}
    for tid in final["tenants"]:
        charges = [e.payload for e in read_trace(
            os.path.join(d1, f"{tid}.jsonl"))
            if e.kind == "charge" and e.payload.get("ledger") == "campaign"]
        votes[tid] = charges[-1]["human_votes"]
        assert votes[tid] == final["tenants"][tid]["human_votes"]
    assert all(v > 0 for v in votes.values())


def test_fleet_report_structure(cascade_runs):
    from repro.launch.orchestrator import fleet_report as jfleet_report
    from repro_torch.launch.orchestrator import fleet_report, render_fleet
    d1, _res1, _d2, _res2, jdir = cascade_runs
    rep = fleet_report(d1)
    assert rep == jfleet_report(d1)
    assert fleet_report(jdir) == jfleet_report(jdir)
    assert set(rep["tenants"]) == {"t0", "t1", "t2"}
    fl = rep["fleet"]
    assert fl["ceiling"] == 14.0 and fl["rounds"] >= 1
    assert fl["downgrades"] and fl["final"] is not None
    assert fl["final"]["total"] == pytest.approx(
        sum(t["total"] for t in fl["final"]["tenants"].values()))
    text = render_fleet(rep)
    assert "ceiling" in text and "t0" in text and "force_commit" in text


def test_orchestrator_cli_runs_a_fleet_and_reports(tmp_path, capsys):
    import json

    from repro_torch.launch import orchestrator
    tenants = tmp_path / "fleet.json"
    tenants.write_text(json.dumps([
        {"tenant_id": f"t{i}", "priority": i, "seed": i,
         "cfg": {"max_iters": 2, "delta0_frac": 0.1, "test_frac": 0.2,
                 "seed": i}} for i in range(2)]))
    d = str(tmp_path / "traces")
    argv = ["orchestrator", "--tenants", str(tenants), "--device", "cpu",
            "--pool", "300", "--classes", "3", "--trace-dir", d,
            "--metrics"]
    import sys
    old = sys.argv
    try:
        sys.argv = argv
        orchestrator.main()
        out = json.loads(capsys.readouterr().out)
        sys.argv = ["orchestrator", "--report", d]
        orchestrator.main()
        text = capsys.readouterr().out
    finally:
        sys.argv = old
    assert set(out["tenants"]) == {"t0", "t1"}
    assert out["compiled_programs"] > 0
    assert os.path.exists(os.path.join(d, "metrics.prom"))
    assert "== fleet ==" in text and "t1" in text


# ---------------------------------------------------------------------------
# controller units: hand-set ledgers, no campaigns
# ---------------------------------------------------------------------------


class FakeTenant:
    """The controller-facing duck-type of :class:`repro_torch.core.tenant.
    Tenant` with the ledger hand-set — mirrors the real downgrade
    semantics (pause zeroes the ask for one round, shrink halves it
    once, force ends the tenant)."""

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


def test_redistribute_surplus_to_highest_priority_first():
    lo = FakeTenant("lo", priority=0, allocation=10.0, spent=2.0, ask=0.0)
    mid = FakeTenant("mid", priority=1, allocation=5.0, spent=5.0, ask=10.0)
    hi = FakeTenant("hi", priority=2, allocation=5.0, spent=5.0, ask=3.0)
    ctl = FleetController([lo, mid, hi], global_budget=None)
    ctl.rebalance()
    # lo's 8.0 surplus: hi (most critical over-asker) topped up to its
    # full 3.0 need first, mid gets the remaining 5.0 of its 10.0 need
    assert lo.allocation == pytest.approx(2.0)
    assert hi.allocation == pytest.approx(8.0)
    assert mid.allocation == pytest.approx(10.0)
    # nobody was downgraded — there is no ceiling
    assert not any(t.paused or t.votes_shrunk or t.forced
                   for t in (lo, mid, hi))


def test_redistribute_takes_done_tenants_leftover():
    done = FakeTenant("done", priority=9, allocation=10.0, spent=4.0)
    done.forced = True          # finished: its leftover 6.0 is surplus
    ask = FakeTenant("ask", priority=0, allocation=1.0, spent=1.0, ask=4.0)
    ctl = FleetController([done, ask], global_budget=None)
    ctl.rebalance()
    assert done.allocation == pytest.approx(4.0)
    assert ask.allocation == pytest.approx(5.0)


def test_uncapped_tenants_sit_out_redistribution():
    free = FakeTenant("free", allocation=None, spent=0.0, ask=100.0)
    rich = FakeTenant("rich", allocation=10.0, spent=0.0, ask=0.0)
    ctl = FleetController([free, rich], global_budget=None)
    ctl.rebalance()
    assert free.allocation is None and rich.allocation == pytest.approx(0.0)


def test_cascade_pauses_least_critical_first_and_stops():
    a = FakeTenant("a", priority=2, spent=4.0, ask=2.0)
    b = FakeTenant("b", priority=0, spent=4.0, ask=2.0)
    c = FakeTenant("c", priority=1, spent=4.0, ask=2.0)
    # projected 18 vs ceiling 16: pausing ONE lowest-priority tenant fits
    ctl = FleetController([a, b, c], global_budget=16.0)
    summary = ctl.rebalance()
    assert b.paused and not a.paused and not c.paused
    assert [d["tenant"] for d in summary["downgrades"]] == ["b"]
    assert ctl.projected() <= 16.0


def test_cascade_tie_breaks_on_tenant_id():
    a = FakeTenant("a", priority=0, spent=4.0, ask=2.0)
    b = FakeTenant("b", priority=0, spent=4.0, ask=2.0)
    ctl = FleetController([b, a], global_budget=10.0)
    summary = ctl.rebalance()
    assert a.paused and not b.paused
    assert [d["tenant"] for d in summary["downgrades"]] == ["a"]


def test_cascade_escalates_through_all_three_actions(tmp_path):
    from repro_torch.trace import TraceStore
    trace = TraceStore(str(tmp_path / "fleet.jsonl"), "fleet")
    a = FakeTenant("a", priority=1, spent=6.0, ask=2.0, shrinkable=True)
    b = FakeTenant("b", priority=0, spent=6.0, ask=2.0, shrinkable=True)
    # ceiling below the SPENT total: no amount of pausing or shrinking
    # can fit — the cascade must escalate to force_commit for everyone
    ctl = FleetController([a, b], global_budget=10.0, trace=trace)
    summary = ctl.rebalance()
    actions = [(d["action"], d["tenant"]) for d in summary["downgrades"]]
    assert actions == [("pause", "b"), ("pause", "a"),
                       ("shrink_votes", "b"), ("shrink_votes", "a"),
                       ("force_commit", "b"), ("force_commit", "a")]
    assert not a.running and not b.running
    trace.close()
    # the trace round-trips the exact sequence
    assert [(d["action"], d["tenant"]) for d in
            downgrade_sequence(str(tmp_path / "fleet.jsonl"))] == actions


def test_pause_lifts_at_next_rebalance():
    a = FakeTenant("a", priority=1, spent=4.0, ask=2.0)
    b = FakeTenant("b", priority=0, spent=4.0, ask=2.0)
    ctl = FleetController([a, b], global_budget=10.0)
    ctl.rebalance()
    assert b.paused
    ctl.global_budget = 100.0   # ceiling no longer binds
    ctl.rebalance()
    assert not b.paused and not a.paused


def test_resolve_stall_forces_everyone_least_critical_first(tmp_path):
    from repro_torch.trace import TraceStore
    trace = TraceStore(str(tmp_path / "fleet.jsonl"), "fleet")
    a = FakeTenant("a", priority=1, spent=1.0)
    b = FakeTenant("b", priority=0, spent=1.0)
    ctl = FleetController([a, b], global_budget=1.0, trace=trace)
    ctl.resolve_stall()
    assert not a.running and not b.running
    trace.close()
    assert [d["tenant"] for d in
            downgrade_sequence(str(tmp_path / "fleet.jsonl"))] == ["b", "a"]


def test_tenant_spec_from_dict():
    s = TenantSpec.from_dict({"tenant_id": "t7", "priority": 3,
                              "budget": 12.5, "seed": 4,
                              "cfg": {"eps_target": 0.1, "max_iters": 5}})
    assert s.tenant_id == "t7" and s.priority == 3
    assert s.budget == pytest.approx(12.5) and s.seed == 4
    assert s.cfg.eps_target == pytest.approx(0.1) and s.cfg.max_iters == 5
    d = TenantSpec.from_dict({"tenant_id": "bare"})
    assert d.priority == 0 and d.budget is None and d.cfg == MCALConfig()
    with pytest.raises(TypeError):    # unknown cfg keys are rejected
        TenantSpec.from_dict({"tenant_id": "x", "cfg": {"nope": 1}})
    with pytest.raises(AssertionError):   # duplicate ids are rejected
        FleetController([FakeTenant(i) for i in ("a", "a")])


# ---------------------------------------------------------------------------
# satellite: session ledger isolation through ONE shared service
# ---------------------------------------------------------------------------

ISO_CLASSES = 4
ISO_POOL = 64


def _iso_service():
    from repro_torch.annotation import make_annotation_service
    return make_annotation_service(ISO_CLASSES, n_workers=7, noise=0.35,
                                   repeats=3, seed=0, device="cpu")


def _iso_requests(seed, n_batches=6):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(ISO_POOL, size=int(rng.integers(3, 9)),
                               replace=False)).astype(np.int64)
            for _ in range(n_batches)]


_ISO_GT = np.random.default_rng(99).integers(
    0, ISO_CLASSES, ISO_POOL).astype(np.int64)


def _solo_labels(reqs):
    """The same request history against a PRIVATE service (same pool
    seed): the bit-exact baseline any shared-service session must
    match."""
    svc = _iso_service()
    sess = svc.session("solo")
    labels = [sess.annotate(i, _ISO_GT[i]) for i in reqs]
    svc.close()
    return labels, sess.votes_bought, sess.labels_bought


def test_interleaved_sessions_do_not_cross_talk():
    reqs_a, reqs_b = _iso_requests(1), _iso_requests(2)
    svc = _iso_service()
    a, b = svc.session("a"), svc.session("b")
    got_a, got_b = [], []
    # interleave through the BROKER (one worker thread serializes every
    # batch) — a's and b's requests alternate in service-arrival order
    for ra, rb in zip(reqs_a, reqs_b):
        fa = a.submit(ra, _ISO_GT[ra])
        fb = b.submit(rb, _ISO_GT[rb])
        got_a.append(fa.result())
        got_b.append(fb.result())
    svc.close()

    solo_a, votes_a, labels_a = _solo_labels(reqs_a)
    solo_b, votes_b, labels_b = _solo_labels(reqs_b)
    for got, want in zip(got_a, solo_a):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(got_b, solo_b):
        np.testing.assert_array_equal(got, want)
    # per-session charges are each session's own requests, and they
    # partition the shared service ledger exactly
    assert a.votes_bought == votes_a and b.votes_bought == votes_b
    assert a.labels_bought == labels_a and b.labels_bought == labels_b
    assert a.votes_bought + b.votes_bought == svc.votes_bought


def test_session_preempt_resume_does_not_perturb_sibling():
    reqs_a, reqs_b = _iso_requests(3), _iso_requests(4)
    svc = _iso_service()
    a, b = svc.session("a"), svc.session("b")
    got_a, got_b = [], []
    for i, (ra, rb) in enumerate(zip(reqs_a, reqs_b)):
        if i == len(reqs_a) // 2:
            # preempt tenant A mid-fleet: persist its session, drop it,
            # resume into a FRESH session on the same live service
            state = a.state_dict()
            a = svc.session("a-resumed")
            a.load_state_dict(state)
        got_a.append(a.annotate(ra, _ISO_GT[ra]))
        got_b.append(b.annotate(rb, _ISO_GT[rb]))
    svc.close()

    solo_a, votes_a, _ = _solo_labels(reqs_a)
    solo_b, votes_b, _ = _solo_labels(reqs_b)
    for got, want in zip(got_a, solo_a):   # A resumed bit-identically
        np.testing.assert_array_equal(got, want)
    for got, want in zip(got_b, solo_b):   # ...and B never noticed
        np.testing.assert_array_equal(got, want)
    assert a.votes_bought == votes_a and b.votes_bought == votes_b


def test_shrunk_session_policy_is_tenant_local():
    from repro_torch.annotation.service import RepeatPolicy
    svc = _iso_service()
    a, b = svc.session("a"), svc.session("b")
    a.set_policy(RepeatPolicy(repeats=1, aggregator="majority"))
    idx = np.arange(8)
    a.annotate(idx, _ISO_GT[idx])
    b.annotate(idx, _ISO_GT[idx])
    svc.close()
    assert a.votes_bought == 8          # shrunk: 1 vote/label
    assert b.votes_bought == 24         # sibling untouched: 3 votes/label
    assert b.policy.repeats == 3
