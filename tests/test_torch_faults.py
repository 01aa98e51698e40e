"""The port's fault-injection harness and resilient runtime, held against
the JAX package's (``tests/test_faults.py``).

* ``hash01``, every plan decision and every retry backoff are bit-equal to
  the reference's on a grid of (seed, site, counter): the same plan fires
  the same faults;
* the reference's plan, injector, retry, annotation-retry and worker unit
  cases, run on the port's copies (exact: the layer is host code);
* the same chaos plan on the same live campaign fires the same
  ``(site, counter, kind)`` list in both packages, and the port's chaos
  campaign diffs clean against its fault-free run and against the JAX
  package's chaos trace (the port's retrains fed the reference's init and
  epoch orders, ``LiveTask.fit_source``);
* an injected kill, the autosave sidecar and the resume are bit-identical
  to the uninterrupted campaign;
* ``_run_round`` quarantines a ``FaultError`` tenant and orders sibling
  errors by fleet order, and a fleet quarantines a dead tenant while its
  siblings commit as if it had never been there.
"""
import os
import threading
import types

import numpy as np
import pytest

import repro.faults as jfaults
import repro_torch.faults as pfaults
from repro_torch.annotation import make_annotation_service
from repro_torch.annotation.service import BudgetExceeded
from repro_torch.core import AMAZON, MCALCampaign, MCALConfig, make_emulated_task
from repro_torch.core.worker import SerialWorker
from repro_torch.faults import (AnnotationTimeout, FaultInjector, FaultPlan,
                                FaultRule, InjectedKill, InjectedWorkerCrash,
                                RetryExhausted, RetryPolicy, StragglerTimeout,
                                TransientAnnotationError, hash01)
from repro_torch.faults.errors import FaultError, TransientError
from repro_torch.trace import TraceStore, diff, read_trace

from test_torch_campaign import _jax_fit_source

SITES = ("annotation.request", "worker.pool-sweep", "worker.fit-engine",
         "trace.flush", "campaign.iteration", "s", "")


# ---------------------------------------------------------------------------
# bit-equal to the reference: hash01, plan decisions, backoff
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2**40 + 3])
def test_hash01_equals_reference_on_grid(seed):
    for site in SITES:
        for c in list(range(256)) + [10**6, 2**31 - 1, 2**40]:
            assert hash01(seed, site, c) == jfaults.hash01(seed, site, c)


def _plans(F, seed):
    return [
        F.FaultPlan.standard_transient(seed),
        F.FaultPlan(seed=seed, rules=(
            F.FaultRule("s", "transient", rate=0.3, after=10),
            F.FaultRule("s", "timeout", rate=0.25, after=4),
            F.FaultRule("s", "crash", at=(3, 17)),
            F.FaultRule("campaign.iteration", "kill", at=(2,)),
            F.FaultRule("annotation.request", "latency", rate=0.5,
                        duration=0.1))),
    ]


def _rule(r):
    return None if r is None else (r.site, r.kind, r.rate, r.at, r.after,
                                   r.duration)


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_plan_decisions_equal_reference(seed):
    for mine, ref in zip(_plans(pfaults, seed), _plans(jfaults, seed)):
        for site in SITES:
            for c in range(300):
                assert _rule(mine.decide(site, c)) == \
                    _rule(ref.decide(site, c)), (site, c)


@pytest.mark.parametrize("seed", [0, 5])
def test_retry_backoff_equals_reference(seed):
    mine, ref = RetryPolicy(seed=seed), jfaults.RetryPolicy(seed=seed)
    for site in ("annotation.request", "worker.fit-engine"):
        for inv in range(6):
            for a in range(4):
                assert mine.backoff(site, inv, a) == ref.backoff(site, inv, a)


# ---------------------------------------------------------------------------
# the reference's unit cases on the port's copies
# ---------------------------------------------------------------------------


def test_hash01_is_pure_and_uniformish():
    a = hash01(7, "annotation.request", 3)
    assert a == hash01(7, "annotation.request", 3)
    assert 0.0 <= a < 1.0
    draws = {hash01(7, "annotation.request", c) for c in range(64)}
    assert len(draws) == 64                     # counters decorrelate
    assert hash01(7, "worker.fit-engine", 3) != a     # sites decorrelate
    assert hash01(8, "annotation.request", 3) != a    # seeds decorrelate


def test_fault_rule_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultRule("annotation.request", "meteor")


def test_plan_decide_is_pure_and_at_wins_over_rate():
    rules = (FaultRule("s", "transient", rate=0.5),
             FaultRule("s", "crash", at=(3,)))
    p1, p2 = FaultPlan(seed=11, rules=rules), FaultPlan(seed=11,
                                                        rules=list(rules))
    decisions = [p1.decide("s", c) for c in range(128)]
    assert decisions == [p2.decide("s", c) for c in range(128)]
    assert decisions[3].kind == "crash"         # explicit schedule wins
    fired = sum(1 for d in decisions if d is not None and d.kind
                == "transient")
    assert 32 <= fired <= 96                    # ~rate, deterministic
    assert p1.decide("other-site", 3) is None


def test_plan_after_and_cumulative_rate_partition():
    p = FaultPlan(seed=2, rules=(
        FaultRule("s", "transient", rate=0.3, after=10),
        FaultRule("s", "timeout", rate=0.3, after=10)))
    assert all(p.decide("s", c) is None for c in range(10))
    kinds = {d.kind for c in range(10, 200)
             if (d := p.decide("s", c)) is not None}
    # ONE shared uniform draw partitioned by cumulative rate: both rules
    # fire, and a given counter fires at most one of them
    assert kinds == {"transient", "timeout"}


def test_injector_counters_advance_and_fault_maps_to_exception():
    inj = FaultInjector(FaultPlan(seed=0, rules=(
        FaultRule("s", "transient", at=(1,)),
        FaultRule("k", "kill", at=(0,)),
        FaultRule("c", "crash", at=(0,)),
        FaultRule("o", "oserror", at=(0,)))))
    assert inj.check("s") is None               # counter 0: clean
    with pytest.raises(TransientAnnotationError):
        inj.check("s")                          # counter 1: fires
    assert inj.check("s") is None
    assert inj.counters()["s"] == 3 and inj.fired == 1
    with pytest.raises(InjectedWorkerCrash):
        inj.check("c")
    assert issubclass(InjectedWorkerCrash, TransientError)   # retryable
    with pytest.raises(OSError):
        inj.check("o")
    # kills unwind PAST `except Exception` recovery (emulated preemption)
    with pytest.raises(InjectedKill):
        inj.check("k")
    assert not issubclass(InjectedKill, Exception)


def test_injector_latency_respects_deadline_and_emits(tmp_path):
    inj = FaultInjector(FaultPlan(seed=0, time_scale=0.0, rules=(
        FaultRule("s", "latency", at=(0, 1), duration=5.0),)))
    p = str(tmp_path / "t.jsonl")
    with TraceStore(p, "camp") as tr:
        inj.attach_trace(tr)
        f = inj.check("s")                      # no deadline: just waits
        assert f is not None and f.rule.kind == "latency"
        with pytest.raises(AnnotationTimeout):
            inj.check("s", timeout=0.1)         # 5s spike > 0.1s deadline
    ev = [e for e in read_trace(p) if e.kind == "fault_injected"]
    assert [e.payload["counter"] for e in ev] == [0, 1]
    assert all(e.payload["site"] == "s" and e.payload["fault"] == "latency"
               for e in ev)


# ---------------------------------------------------------------------------
# retry policy: bounded, deterministic, transient-only
# ---------------------------------------------------------------------------


def test_retry_succeeds_after_transients_and_notifies():
    pol = RetryPolicy(max_attempts=4, seed=5, sleep_scale=0.0)
    calls, seen = [], []
    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise TransientAnnotationError("flaky")
        return "ok"
    assert pol.call(fn, site="s", notify=lambda a, e, d:
                    seen.append((a, d))) == "ok"
    assert len(calls) == 3 and [a for a, _ in seen] == [0, 1]
    # deterministic jitter: an identical policy reports identical delays
    assert [d for _, d in seen] == [RetryPolicy(max_attempts=4, seed=5)
                                    .backoff("s", 0, a) for a in (0, 1)]
    assert seen[1][1] > 0.0


def test_retry_exhaustion_chains_last_transient():
    pol = RetryPolicy(max_attempts=3, sleep_scale=0.0)
    n = []
    def fn():
        n.append(1)
        raise TransientAnnotationError("still down")
    with pytest.raises(RetryExhausted) as ei:
        pol.call(fn, site="s")
    assert len(n) == 3
    assert isinstance(ei.value.__cause__, TransientAnnotationError)
    assert isinstance(ei.value, FaultError)     # terminal -> quarantine


def test_retry_passes_non_transient_through_untouched():
    pol = RetryPolicy(max_attempts=4, sleep_scale=0.0)
    n = []
    def fn():
        n.append(1)
        raise ValueError("a bug, not weather")
    with pytest.raises(ValueError):
        pol.call(fn, site="s")
    assert len(n) == 1


def test_backoff_is_bounded_and_jitter_free_when_disabled():
    pol = RetryPolicy(base_delay=0.1, multiplier=2.0, max_delay=0.3,
                      jitter=0.0)
    assert [pol.backoff("s", 0, a) for a in range(4)] == \
        pytest.approx([0.1, 0.2, 0.3, 0.3])


# ---------------------------------------------------------------------------
# annotation resilience: retries charge exactly once
# ---------------------------------------------------------------------------

_GT = np.random.default_rng(17).integers(0, 3, 64).astype(np.int64)


def _svc(**kw):
    base = dict(n_workers=5, noise=0.2, repeats=3, seed=0, device="cpu")
    base.update(kw)
    return make_annotation_service(3, **base)


def test_annotation_retry_is_transparent_and_charges_once(tmp_path):
    reqs = [np.arange(8), np.arange(8, 20), np.arange(20, 25)]
    clean = _svc()
    want = [clean.annotate(i, _GT[i]) for i in reqs]

    chaotic = _svc()
    with TraceStore(str(tmp_path / "t.jsonl"), "camp") as tr:
        chaotic.attach_trace(tr)
        # attempt-counters 0 and 2 fail: every batch recovers on its
        # next attempt (no two consecutive counters fire)
        chaotic.attach_faults(
            FaultInjector(FaultPlan(rules=(
                FaultRule("annotation.request", "transient", at=(0, 2)),))),
            RetryPolicy(sleep_scale=0.0))
        got = [chaotic.annotate(i, _GT[i]) for i in reqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the retried batches replayed the identical worker schedule and
    # were charged exactly once: both ledgers match bit-for-bit
    assert chaotic.ledger.snapshot() == clean.ledger.snapshot()
    assert chaotic.request_cursor == clean.request_cursor
    retries = [e for e in read_trace(str(tmp_path / "t.jsonl"))
               if e.kind == "retry"]
    assert len(retries) == 2
    assert all(e.payload["site"] == "annotation.request"
               and e.payload["error"] == "TransientAnnotationError"
               and e.payload["delay"] > 0.0 for e in retries)


def test_annotation_retry_at_budget_edge_charges_nothing_extra():
    # budget fits the first batch exactly (8 labels x 3 votes x $0.04)
    svc = _svc(budget=8 * 3 * 0.04)
    svc.attach_faults(
        FaultInjector(FaultPlan(rules=(
            FaultRule("annotation.request", "transient", at=(0,)),))),
        RetryPolicy(sleep_scale=0.0))
    labels = svc.annotate(np.arange(8), _GT[:8])     # retried, then fits
    assert labels.shape == (8,)
    spent = svc.ledger.human
    assert spent == pytest.approx(8 * 3 * 0.04)
    # the next batch is refused BEFORE any charge — BudgetExceeded is
    # not a transient, so the retry layer does not spin on it
    with pytest.raises(BudgetExceeded):
        svc.annotate(np.arange(8, 16), _GT[8:16])
    assert svc.ledger.human == pytest.approx(spent)
    assert svc.request_cursor == 1              # refused batch: no cursor


def test_session_fault_override_leaves_siblings_clean():
    svc = _svc()
    a, b = svc.session("a"), svc.session("b")
    solo = _svc()
    want_b = solo.session("b-solo").annotate(np.arange(6), _GT[:6])
    a.attach_faults(
        FaultInjector(FaultPlan(rules=(
            FaultRule("annotation.request", "transient", rate=1.0),))),
        RetryPolicy(max_attempts=2, sleep_scale=0.0))
    with pytest.raises(RetryExhausted):
        a.annotate(np.arange(6), _GT[:6])
    got_b = b.annotate(np.arange(6), _GT[:6])   # sibling: untouched
    np.testing.assert_array_equal(got_b, want_b)
    assert a.votes_bought == 0 and a.request_cursor == 0
    assert b.votes_bought == 18
    svc.close()


# ---------------------------------------------------------------------------
# worker resilience: crashed jobs re-dispatch, hung jobs time out
# ---------------------------------------------------------------------------


def test_worker_crash_redispatches_in_place():
    w = SerialWorker("pool-sweep")
    w.attach_faults(
        FaultInjector(FaultPlan(rules=(
            FaultRule("worker.pool-sweep", "crash", at=(0,)),))),
        RetryPolicy(sleep_scale=0.0))
    assert w.submit(lambda: 7).result(timeout=5) == 7
    assert w.redispatches == 1
    assert w.submit(lambda: 8).result(timeout=5) == 8   # keeps draining
    assert w.close(timeout=5) is True


def test_worker_crash_without_retry_surfaces_at_result():
    w = SerialWorker("fit-engine")
    w.attach_faults(FaultInjector(FaultPlan(rules=(
        FaultRule("worker.fit-engine", "crash", at=(0,)),))))
    with pytest.raises(InjectedWorkerCrash):
        w.submit(lambda: 7).result(timeout=5)
    assert w.submit(lambda: 9).result(timeout=5) == 9
    assert w.redispatches == 0
    assert w.close(timeout=5) is True


def test_sweep_future_deadline_raises_straggler_timeout():
    from repro_torch.serving.sweep import SweepFuture
    gate = threading.Event()
    w = SerialWorker("t")
    fut = SweepFuture(w.submit(gate.wait), label="sweep[margin]")
    with pytest.raises(StragglerTimeout) as ei:
        fut.result(timeout=0.05)
    assert "sweep[margin]" in str(ei.value)
    assert isinstance(ei.value, FaultError)     # terminal -> quarantine
    gate.set()
    assert w.close(timeout=5) is True
    assert fut.result(timeout=5) is True        # the job itself finished



# ---------------------------------------------------------------------------
# crash-safe autosave: an injected kill resumes bit-identically
# ---------------------------------------------------------------------------


def _emulated_run(trace_path, *, autosave_path="", faults=None):
    from repro_torch.launch.label import run_campaign
    task = make_emulated_task("cifar10", "resnet18", seed=0,
                              pool_size=4000, sweep_page=512, device="cpu")
    return run_campaign(task, AMAZON, MCALConfig(seed=0),
                        trace_path=str(trace_path), campaign_id="camp",
                        autosave_path=str(autosave_path), faults=faults)


def test_injected_kill_autosaves_and_resumes_bit_identically(tmp_path):
    save = tmp_path / "autosave.json"
    t_chaos = tmp_path / "chaos.jsonl"
    killer = FaultInjector(FaultPlan(rules=(
        FaultRule("campaign.iteration", "kill", at=(1,)),)))
    with pytest.raises(InjectedKill):
        _emulated_run(t_chaos, autosave_path=save, faults=killer)
    assert os.path.exists(save)                 # the sidecar landed
    # the next invocation (fresh task, no plan: counters restart, so the
    # resumed leg must not re-fire the kill) resumes from the sidecar
    res, camp = _emulated_run(t_chaos, autosave_path=save)
    assert res is not None and not os.path.exists(save)   # spent
    t_clean = tmp_path / "clean.jsonl"
    want, _ = _emulated_run(t_clean)
    assert res.decision == want.decision
    assert res.ledger == want.ledger            # bit-identical money
    assert res.total_cost == want.total_cost
    assert diff(str(t_chaos), str(t_clean)) is None
    kinds = {e.kind for e in read_trace(str(t_chaos))}
    assert "autosave" in kinds and "resume" in kinds


# ---------------------------------------------------------------------------
# concurrent-round error ordering and quarantine (no campaigns)
# ---------------------------------------------------------------------------


def _fake_tenant(tid):
    return types.SimpleNamespace(tenant_id=tid, quarantined=False)


@pytest.mark.parametrize("concurrent", [True, False])
def test_run_round_aggregates_concurrent_tenant_errors(concurrent):
    from repro_torch.launch.orchestrator import CampaignOrchestrator
    orch = CampaignOrchestrator([], controller=None, concurrent=concurrent)

    def boom(exc):
        def run():
            raise exc
        return run
    e1, e2 = ValueError("t0 died"), KeyError("t2 died")
    jobs = [(_fake_tenant("t0"), boom(e1)),
            (_fake_tenant("t1"), lambda: None),
            (_fake_tenant("t2"), boom(e2))]
    with pytest.raises(ValueError) as ei:
        orch._run_round(jobs)
    # the primary is the first failure in FLEET order (not completion
    # order) and carries every sibling failure
    assert ei.value is e1
    assert ei.value.sibling_errors == (e2,)
    assert any("t2" in n and "KeyError" in n for n in e1.__notes__)


@pytest.mark.parametrize("concurrent", [True, False])
def test_run_round_quarantines_fault_errors_instead_of_raising(concurrent):
    from repro_torch.launch.orchestrator import CampaignOrchestrator
    seen = []
    ctl = types.SimpleNamespace(
        quarantine=lambda t, e, phase="iteration":
            (seen.append((t.tenant_id, type(e).__name__, phase)) or True))
    orch = CampaignOrchestrator([], controller=ctl, concurrent=concurrent)

    def die():
        raise RetryExhausted("annotation backend gone")

    def late():
        raise StragglerTimeout("sweep[topk] still running")
    orch._run_round([(_fake_tenant("t0"), lambda: None),
                     (_fake_tenant("t1"), die),
                     (_fake_tenant("t2"), late)])
    assert sorted(seen) == [("t1", "RetryExhausted", "iteration"),
                            ("t2", "StragglerTimeout", "iteration")]


# ---------------------------------------------------------------------------
# chaos acceptance: the same plan on the same campaign in both packages
# ---------------------------------------------------------------------------


def _chaos_plan(F):
    # attempt-counters 0/3/7 fail; no two consecutive, so every batch
    # recovers within one retry
    return F.FaultInjector(F.FaultPlan(seed=7, time_scale=0.0, rules=(
        F.FaultRule("annotation.request", "transient", at=(0, 3, 7)),
        F.FaultRule("worker.pool-sweep", "crash", at=(0,)),
        F.FaultRule("worker.fit-engine", "crash", at=(0,)),
        F.FaultRule("trace.flush", "oserror", at=(0,)))))


def _chaos_campaign(pkg, trace_path, faults=None, retry=None,
                    fit_source=None):
    """The reference's chaos campaign (``tests/test_faults.py``): an async,
    noisy, adaptive-repeats Dawid-Skene live campaign at 96 rows."""
    if pkg == "jax":
        from repro.annotation import make_annotation_service as mk
        from repro.core import AMAZON as svc_price
        from repro.core import MCALCampaign as Camp
        from repro.core import MCALConfig as Cfg
        from repro.core.task import LiveTask as Task
        from repro.trace import TraceStore as Store
        kw, task_kw = {}, {}
    else:
        from repro_torch.core import LiveTask as Task
        mk, svc_price, Camp, Cfg, Store = (make_annotation_service, AMAZON,
                                           MCALCampaign, MCALConfig,
                                           TraceStore)
        kw = {"device": "cpu"}
        task_kw = dict(kw, fit_source=fit_source)
    from repro_torch.data.synth import make_classification
    x, y = make_classification(96, num_classes=3, difficulty=0.3, seed=0)
    svc = mk(3, n_workers=5, noise=0.25, repeats=3, max_repeats=5,
             adaptive=True, aggregator="ds", seed=0, **kw)
    task = Task(features=x, groundtruth=y, num_classes=3, epochs=2,
                score_microbatch=32, sweep_page=32, seed=0, annotation=svc,
                **task_kw)
    cfg = Cfg(max_iters=2, delta0_frac=0.1, test_frac=0.2,
              sweep_async=True, fit_async=True,
              label_quality=svc.expected_quality())
    camp = Camp(task, svc_price, cfg)
    trace = Store(str(trace_path), "camp")
    camp.attach_trace(trace)
    if faults is not None:
        camp.attach_faults(faults, retry)
    try:
        res = camp.run()
    finally:
        camp.close()
        trace.close()
    return task, res


def _fired(path):
    """The ``(site, counter, kind)`` list a trace's ``fault_injected``
    events name, in site then counter order (workers emit from their own
    threads, so the file order of two sites is a race)."""
    return sorted((e.payload["site"], e.payload["counter"],
                   e.payload["fault"]) for e in read_trace(path)
                  if e.kind == "fault_injected")


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos")
    jinj = _chaos_plan(jfaults)
    jtask, jres = _chaos_campaign("jax", d / "jax.jsonl", jinj,
                                  jfaults.RetryPolicy(seed=7, sleep_scale=0.0))
    src = _jax_fit_source(jtask)
    inj = _chaos_plan(pfaults)
    _, res = _chaos_campaign("port", d / "chaos.jsonl", inj,
                             RetryPolicy(seed=7, sleep_scale=0.0), src)
    _, want = _chaos_campaign("port", d / "clean.jsonl", fit_source=src)
    return dict(d=d, jinj=jinj, jres=jres, inj=inj, res=res, want=want)


def test_chaos_fires_the_reference_faults(chaos_runs):
    inj, jinj, d = chaos_runs["inj"], chaos_runs["jinj"], chaos_runs["d"]
    assert inj.fired == jinj.fired >= 4         # every family actually hit
    # (the per-site tick counts are not compared: a queued M(.) sweep that
    # the campaign cancels ticks ``worker.pool-sweep`` only if the worker
    # picked it up first, a race in either package)
    assert {"annotation.request", "worker.pool-sweep", "worker.fit-engine",
            "trace.flush"} <= set(inj.counters())
    assert _fired(str(d / "chaos.jsonl")) == _fired(str(d / "jax.jsonl"))
    assert _fired(str(d / "chaos.jsonl"))


def test_port_chaos_campaign_diffs_clean_against_fault_free(chaos_runs):
    """Transient annotation failures, one worker-job crash per engine and
    one torn trace write: nothing about the decisions, labels or money
    differs from the run where none of it happened."""
    res, want, d = chaos_runs["res"], chaos_runs["want"], chaos_runs["d"]
    assert res.decision == want.decision
    assert res.ledger == want.ledger
    assert res.total_cost == want.total_cost
    assert res.measured_error == want.measured_error
    np.testing.assert_array_equal(res.labels, want.labels)
    assert diff(str(d / "chaos.jsonl"), str(d / "clean.jsonl")) is None
    ev = read_trace(str(d / "chaos.jsonl"))
    assert any(e.kind == "fault_injected" for e in ev)
    assert any(e.kind == "retry" for e in ev)


@pytest.mark.parametrize("differ", ["port", "jax"])
def test_port_chaos_trace_diffs_clean_against_jax_chaos(chaos_runs, differ):
    from repro.trace import diff as jdiff
    d = chaos_runs["d"]
    fn = diff if differ == "port" else jdiff
    assert fn(str(d / "chaos.jsonl"), str(d / "jax.jsonl")) is None
    res, jres = chaos_runs["res"], chaos_runs["jres"]
    assert res.decision == jres.decision
    assert res.ledger == jres.ledger
    np.testing.assert_array_equal(res.labels, np.asarray(jres.labels))


# ---------------------------------------------------------------------------
# fleet quarantine: one tenant's backend dies, its siblings never notice
# ---------------------------------------------------------------------------


def test_fleet_quarantines_dead_tenant_and_commits_survivors(tmp_path):
    from repro_torch.core.tenant import TenantSpec
    from repro_torch.data.synth import make_classification
    from repro_torch.launch.orchestrator import build_fleet
    x, y = make_classification(320, num_classes=3, difficulty=0.3, seed=0)
    engine_kw = dict(epochs=2, score_microbatch=128, sweep_page=128)

    def specs(ids):
        ann = make_annotation_service(3, n_workers=5, noise=0.2,
                                      repeats=3, seed=0, device="cpu")
        q = ann.expected_quality()
        return ann, [TenantSpec(t, priority=i, seed=int(t[1:]),
                                cfg=MCALConfig(max_iters=2,
                                               delta0_frac=0.1,
                                               test_frac=0.2,
                                               seed=int(t[1:]),
                                               label_quality=q))
                     for i, t in enumerate(ids)]

    d1 = str(tmp_path / "fleet")
    ann, sp = specs(["t0", "t1", "t2", "t3"])
    orch = build_fleet(x, y, sp, service=AMAZON, trace_dir=d1,
                       concurrent=True, annotation_service=ann,
                       engine_kw=engine_kw, device="cpu")
    victim = orch.tenants[1]
    # kill ONLY t1's annotation backend after its first batch: the
    # session-level override leaves its siblings' request paths clean
    victim.campaign.task.annotation.attach_faults(
        FaultInjector(FaultPlan(rules=(
            FaultRule("annotation.request", "transient", rate=1.0,
                      after=1),))),
        RetryPolicy(max_attempts=2, sleep_scale=0.0))
    try:
        results = orch.run()
    finally:
        orch.close()
    assert set(results) == {"t0", "t2", "t3"}   # the victim never commits
    assert victim.quarantined and victim.done
    assert "RetryExhausted" in victim.quarantine_error
    done = [e for e in read_trace(os.path.join(d1, "t1.jsonl"))
            if e.kind == "done"]
    assert done and done[-1].payload["reason"] == "quarantined"
    qev = [e for e in read_trace(os.path.join(d1, "fleet.jsonl"))
           if e.kind == "quarantine"]
    assert qev and qev[-1].payload["tenant"] == "t1"

    d2 = str(tmp_path / "solo")
    ann2, sp2 = specs(["t0", "t2", "t3"])
    orch2 = build_fleet(x, y, sp2, service=AMAZON, trace_dir=d2,
                        concurrent=False, annotation_service=ann2,
                        engine_kw=engine_kw, device="cpu")
    try:
        want = orch2.run()
    finally:
        orch2.close()
    for tid in ("t0", "t2", "t3"):
        d = diff(os.path.join(d1, f"{tid}.jsonl"),
                 os.path.join(d2, f"{tid}.jsonl"))
        assert d is None, f"{tid} perturbed by the quarantine: {d}"
        assert results[tid].decision == want[tid].decision
        assert results[tid].total_cost == want[tid].total_cost


def test_label_cli_exposes_resilience_flags():
    from repro_torch.launch.label import build_parser
    args = build_parser().parse_args(
        ["--sweep-timeout", "1.5", "--fit-timeout", "30",
         "--autosave", "side.json", "--chaos", "--chaos-seed", "9"])
    assert args.sweep_timeout == pytest.approx(1.5)
    assert args.fit_timeout == pytest.approx(30.0)
    assert args.autosave == "side.json" and args.chaos
    assert args.chaos_seed == 9
    bare = build_parser().parse_args([])
    assert bare.sweep_timeout is None and bare.fit_timeout is None
    assert not bare.chaos and bare.chaos_seed is None
