"""The annotation service (``repro_torch.annotation``) against the JAX
package's, on the grids of ``tests/test_annotation.py``.

Votes are counter-keyed hashes of (pool seed, worker, item) in numpy in
both packages, so they are bit-identical.  Majority vote is exact against
the float64 host oracle and the JAX aggregator.  Dawid-Skene EM runs in
fp32 on each side: posteriors, confusion and prior are held at the
reference's atol 1e-4 against the float64 host EM (and against the JAX
aggregator), with identical argmax labels.  The service (charging,
budget, adaptive top-ups, the broker, state files) and noisy campaigns
(emulated and live) are held against the JAX package's on the same
seeds.
"""
import json

import numpy as np
import pytest

from repro.annotation import VoteAggregator as JVoteAggregator
from repro.annotation import make_annotation_service as jmake_service
from repro.annotation import make_annotator_pool as jmake_pool
from repro.annotation.oracle import AnnotatorPool as JAnnotatorPool
from repro.core import AMAZON as JAMAZON
from repro.core import MCALConfig as JConfig
from repro.core import make_emulated_task as jmake_task
from repro.core import run_mcal as jrun_mcal
from repro.core.mcal import MCALCampaign as JCampaign
from repro.core.task import LiveTask as JLiveTask
from repro.launch.label import run_campaign as jrun_campaign
from repro.trace import TraceStore as JTraceStore
from repro.trace import diff as jdiff
from repro_torch.annotation import (AGGREGATORS, AnnotationService,
                                    AnnotatorConfig, AnnotatorPool,
                                    BudgetExceeded, RepeatPolicy,
                                    VoteAggregator, dawid_skene_host,
                                    majority_vote_host,
                                    make_annotation_service,
                                    make_annotator_pool, vote_counts_host)
from repro_torch.annotation.aggregate import AggregateConfig
from repro_torch.core import (AMAZON, LabelingService, LiveTask,
                              MCALCampaign, MCALConfig, make_emulated_task,
                              run_mcal)
from repro_torch.data.synth import make_classification
from repro_torch.launch.label import run_campaign
from repro_torch.trace import TraceStore, diff

from test_torch_campaign import _jax_fit_source


def _pools(workers, classes, **kw):
    return (make_annotator_pool(workers, classes, **kw),
            jmake_pool(workers, classes, **kw))


def _vote_matrix(n, workers, classes, repeats, *, noise=0.25,
                 spammer_frac=0.0, seed=0):
    pool, jpool = _pools(workers, classes, noise=noise,
                         spammer_frac=spammer_frac, seed=seed)
    gt = np.random.default_rng(seed + 1).integers(0, classes, n)
    votes = pool.vote_matrix(np.arange(n), gt, repeats)
    np.testing.assert_array_equal(
        votes, jpool.vote_matrix(np.arange(n), gt, repeats))
    return votes, gt, pool


def _gt(n, classes=10, seed=0):
    return np.arange(n), np.random.default_rng(seed).integers(0, classes, n)


def _service(*a, **kw):
    return make_annotation_service(*a, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the noisy oracle: the reference's votes bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers,classes,kw", [
    (5, 10, dict(noise=0.2, seed=0)),
    (7, 5, dict(noise=0.3, spammer_frac=0.3, biased_frac=0.2, seed=3)),
    (4, 6, dict(noise=0.4, seed=11, noise_jitter=0.2)),
    (9, 25, dict(noise=0.1, spammer_frac=0.2, seed=5))])
def test_votes_bit_identical_to_jax(workers, classes, kw):
    pool, jpool = _pools(workers, classes, **kw)
    assert pool.profiles == jpool.profiles
    np.testing.assert_array_equal(pool.confusion, jpool.confusion)
    rng = np.random.default_rng(0)
    idx = rng.choice(10**6, 2000, replace=False)
    gt = rng.integers(0, classes, 2000)
    for w in range(workers):
        np.testing.assert_array_equal(pool.annotate(idx, gt, w),
                                      jpool.annotate(idx, gt, w))
    for repeats, base in ((1, 0), (3, 7), (workers, 2)):
        np.testing.assert_array_equal(
            pool.vote_matrix(idx, gt, repeats, base),
            jpool.vote_matrix(idx, gt, repeats, base))
    assert pool.per_vote_error() == jpool.per_vote_error()
    for r in (1, 2, 3, 5):
        assert pool.expected_majority_error(r) == \
            jpool.expected_majority_error(r)
    salted = AnnotatorPool(pool.cfg, draw_salt=0x5CA1AB1E)
    jsalted = JAnnotatorPool(jpool.cfg, draw_salt=0x5CA1AB1E)
    np.testing.assert_array_equal(salted.annotate(idx, gt, 0),
                                  jsalted.annotate(idx, gt, 0))


def test_annotate_deterministic_per_seed_worker_item():
    cfg = AnnotatorConfig(n_workers=4, num_classes=6, noise=0.4, seed=11)
    a, b = AnnotatorPool(cfg), AnnotatorPool(cfg)
    rng = np.random.default_rng(0)
    idx = rng.choice(5000, 300, replace=False)
    gt = rng.integers(0, 6, 300)
    for w in range(4):
        v1 = a.annotate(idx, gt, w)
        np.testing.assert_array_equal(b.annotate(idx, gt, w), v1)
        p = rng.permutation(300)
        np.testing.assert_array_equal(a.annotate(idx[p], gt[p], w), v1[p])


# ---------------------------------------------------------------------------
# aggregation: the reference's grid
# ---------------------------------------------------------------------------

GRID = [
    # (items, workers, classes, repeats)
    (1, 3, 2, 3),
    (7, 5, 10, 1),
    (60, 5, 10, 3),
    (100, 7, 4, 5),
    (513, 5, 10, 3),       # pow2-boundary ragged batch
    (1024, 3, 3, 2),
    (1500, 9, 25, 7),
]


@pytest.mark.parametrize("n,workers,classes,repeats", GRID)
def test_majority_matches_host_and_jax_exactly(n, workers, classes,
                                               repeats):
    votes, _, _ = _vote_matrix(n, workers, classes, repeats,
                               seed=n + repeats)
    lh, ch = majority_vote_host(votes, classes)
    agg = VoteAggregator(classes, AggregateConfig(microbatch=256),
                         device="cpu")
    ld, cd = agg.majority(votes)
    np.testing.assert_array_equal(ld, lh)
    np.testing.assert_allclose(cd, ch, atol=1e-7)
    jl, jc = JVoteAggregator(classes).majority(votes)
    np.testing.assert_array_equal(ld, jl)
    np.testing.assert_array_equal(cd, jc)


def test_majority_tie_breaks_by_first_class_index():
    votes = np.asarray([[3, 1, -1, -1],
                        [2, 0, 2, 0],
                        [-1, -1, -1, -1]], np.int32)
    lh, ch = majority_vote_host(votes, 4)
    ld, cd = VoteAggregator(4, device="cpu").majority(votes)
    np.testing.assert_array_equal(lh, [1, 0, 0])
    np.testing.assert_array_equal(ld, lh)
    assert ch[2] == 0.0 and cd[2] == 0.0


@pytest.mark.parametrize("n,workers,classes,repeats", GRID)
def test_dawid_skene_matches_host_and_jax(n, workers, classes, repeats):
    votes, _, _ = _vote_matrix(n, workers, classes, repeats,
                               seed=2 * n + repeats, spammer_frac=0.2)
    ref = dawid_skene_host(votes, classes)
    dev = VoteAggregator(classes, AggregateConfig(microbatch=256),
                         device="cpu").dawid_skene(votes)
    jdev = JVoteAggregator(classes).dawid_skene(votes)
    for other in (ref, jdev):
        np.testing.assert_array_equal(dev.labels, other.labels)
        np.testing.assert_allclose(dev.posterior, other.posterior,
                                   atol=1e-4)
        np.testing.assert_allclose(dev.confusion, other.confusion,
                                   atol=1e-4)
        np.testing.assert_allclose(dev.prior, other.prior, atol=1e-4)


def test_host_oracles_are_the_references():
    from repro.annotation import dawid_skene_host as jds
    from repro.annotation import majority_vote_host as jmaj
    from repro.annotation import vote_counts_host as jcounts
    votes, _, _ = _vote_matrix(300, 5, 10, 3, seed=3, spammer_frac=0.2)
    np.testing.assert_array_equal(vote_counts_host(votes, 10),
                                  jcounts(votes, 10))
    for a, b in zip(majority_vote_host(votes, 10), jmaj(votes, 10)):
        np.testing.assert_array_equal(a, b)
    a, b = dawid_skene_host(votes, 10), jds(votes, 10)
    for f in ("posterior", "labels", "confidence", "confusion", "prior"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_dawid_skene_runs_in_fp32_whatever_the_tf32_setting():
    """The EM gemms run in IEEE fp32 even when the caller allows TF32,
    and the caller's setting is restored."""
    import torch
    votes, _, _ = _vote_matrix(200, 5, 10, 3, seed=1)
    agg = VoteAggregator(10, device="cpu")
    want = agg.dawid_skene(votes)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = agg.dawid_skene(votes)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(got.posterior, want.posterior)


def test_aggregator_pack_buckets_stay_logarithmic():
    agg = VoteAggregator(4, AggregateConfig(microbatch=64), device="cpu")
    jagg = JVoteAggregator(4, __import__(
        "repro.annotation.aggregate", fromlist=["AggregateConfig"])
        .AggregateConfig(microbatch=64))
    for n in range(1, 600, 23):
        votes = np.zeros((n, 3), np.int32)
        agg.majority(votes)
        jagg.majority(votes)
    assert agg.cache_keys() == jagg.cache_keys()
    assert len(agg.cache_keys()) <= 8


def test_aggregate_entry_point_and_unknown_method():
    votes, _, _ = _vote_matrix(50, 5, 4, 3)
    agg = VoteAggregator(4, device="cpu")
    l1, c1, ds = agg.aggregate(votes, "majority")
    assert ds is None and len(l1) == 50
    l2, c2, ds2 = agg.aggregate(votes, "ds")
    np.testing.assert_array_equal(l2, ds2.labels)
    with pytest.raises(ValueError):
        agg.aggregate(votes, "mode")
    assert AGGREGATORS == ("majority", "ds")


# ---------------------------------------------------------------------------
# resident vote matrices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,workers,classes,repeats", [
    (1, 3, 2, 3), (60, 5, 10, 3), (513, 5, 10, 3), (100, 7, 4, 5)])
@pytest.mark.parametrize("method", ["majority", "ds"])
def test_resident_aggregate_bit_identical_to_reupload(n, workers, classes,
                                                      repeats, method):
    votes, _, _ = _vote_matrix(n, workers, classes, repeats, seed=n)
    agg = VoteAggregator(classes, AggregateConfig(microbatch=256),
                         device="cpu")
    lr, cr, dsr = agg.aggregate_resident(agg.upload(votes), method)
    lh, ch, dsh = agg.aggregate(votes, method)
    np.testing.assert_array_equal(lr, lh)
    np.testing.assert_array_equal(cr, ch)
    if method == "ds":
        np.testing.assert_array_equal(dsr.posterior, dsh.posterior)
        np.testing.assert_array_equal(dsr.confusion, dsh.confusion)


@pytest.mark.parametrize("k", [1, 5, 8, 23])
def test_resident_scatter_equals_a_fresh_upload(k):
    """k rows gain two more votes each: the scattered resident matrix is
    the fresh upload of the updated matrix, and aggregates like it and
    like the host oracles."""
    n, workers, classes = 120, 7, 5
    votes, gt, pool = _vote_matrix(n, workers, classes, 3, seed=k)
    agg = VoteAggregator(classes, AggregateConfig(microbatch=256),
                         device="cpu")
    res = agg.upload(votes)
    rows = np.random.default_rng(k).choice(n, size=k, replace=False)
    updated = votes.copy()
    updated[rows] = pool.vote_matrix(rows, gt[rows], 5)
    res = agg.scatter(res, rows, updated[rows])
    fresh = agg.upload(updated)
    assert bool((res.dev == fresh.dev).all()) and res.n == fresh.n
    lr, cr, _ = agg.aggregate_resident(res, "majority")
    lh, ch = majority_vote_host(updated, classes)
    np.testing.assert_array_equal(lr, lh)
    np.testing.assert_allclose(cr, ch, atol=1e-7)
    _, _, dsr = agg.aggregate_resident(res, "ds")
    dsh = dawid_skene_host(updated, classes)
    np.testing.assert_array_equal(dsr.labels, dsh.labels)
    np.testing.assert_allclose(dsr.posterior, dsh.posterior, atol=1e-4)
    np.testing.assert_array_equal(
        dsr.posterior, agg.aggregate_resident(fresh, "ds")[2].posterior)


def test_resident_scatter_empty_and_repeated_rows():
    votes, _, _ = _vote_matrix(40, 5, 4, 3, seed=9)
    agg = VoteAggregator(4, device="cpu")
    res = agg.upload(votes)
    before = res.dev.clone()
    assert agg.scatter(res, np.zeros(0, np.int32),
                       np.zeros((0, 5), np.int32)) is res
    rows = np.asarray([4, 17, 4], np.int32)
    vals = np.stack([votes[4], votes[17], votes[4]])
    assert bool((agg.scatter(res, rows, vals).dev == before).all())


# ---------------------------------------------------------------------------
# the service, against the JAX package's on the same requests
# ---------------------------------------------------------------------------

POLICIES = [dict(repeats=3),
            dict(repeats=3, aggregator="ds"),
            dict(repeats=2, max_repeats=5, adaptive=True),
            dict(repeats=1, max_repeats=4, adaptive=True, aggregator="ds"),
            dict(repeats=2, max_repeats=4, adaptive=True, aggregator="ds",
                 spammer_frac=0.2)]


def _state_close(a, b):
    """Service state dicts equal but for the fp32 EM's last bits."""
    a, b = dict(a), dict(b)
    np.testing.assert_allclose(a.pop("conf_sum"), b.pop("conf_sum"),
                               rtol=1e-6)
    ca, cb = a.pop("confusion_est"), b.pop("confusion_est")
    assert (ca is None) == (cb is None)
    if ca is not None:
        np.testing.assert_allclose(ca, cb, atol=1e-4)
    assert a == b


@pytest.mark.parametrize("kw", POLICIES)
def test_service_matches_jax(kw):
    """Three request batches through both services: the same labels, votes
    and ledgers, the same worker statistics and state, and the same
    calibration (what a campaign folds into its target)."""
    svc = _service(10, n_workers=5, noise=0.25, seed=1, **kw)
    jsvc = jmake_service(10, n_workers=5, noise=0.25, seed=1, **kw)
    rng = np.random.default_rng(2)
    for _ in range(3):
        idx = rng.choice(100_000, 400, replace=False)
        gt = rng.integers(0, 10, 400)
        labels, votes = svc.annotate_counted(idx, gt)
        jlabels, jvotes = jsvc.annotate_counted(idx, gt)
        np.testing.assert_array_equal(labels, jlabels)
        assert votes == jvotes
    assert svc.votes_bought == jsvc.votes_bought
    assert svc.ledger.as_dict() == jsvc.ledger.as_dict()
    np.testing.assert_array_equal(svc.worker_accuracy(),
                                  jsvc.worker_accuracy())
    assert svc.avg_repeats() == jsvc.avg_repeats()
    assert svc.estimated_residual_error() == pytest.approx(
        jsvc.estimated_residual_error(), abs=1e-6)
    assert vars(svc.expected_quality()) == vars(jsvc.expected_quality())
    assert vars(svc.calibrate(n=1024)) == vars(jsvc.calibrate(n=1024))
    _state_close(svc.state_dict(), jsvc.state_dict())


def test_service_charges_repeats_times_tier_pricing():
    tiered = LabelingService("tiered", 0.04, tiers=((0, 0.04), (1000, 0.01)))
    svc = _service(10, n_workers=5, noise=0.1, repeats=3, pricing=tiered,
                   seed=0)
    idx, gt = _gt(500)
    svc.annotate(idx, gt)
    assert svc.votes_bought == 1500
    assert svc.ledger.human == pytest.approx(1000 * 0.04 + 500 * 0.01)
    assert svc.ledger.human_labels == 500
    svc.annotate(idx + 500, gt)
    assert svc.ledger.human == pytest.approx(1000 * 0.04 + 2000 * 0.01)


def test_adaptive_repeats_saves_votes_and_stays_accurate():
    idx, gt = _gt(2000)
    flat = _service(10, n_workers=7, noise=0.2, repeats=5, seed=0)
    lab_flat = flat.annotate(idx, gt)
    adap = _service(10, n_workers=7, noise=0.2, repeats=2, max_repeats=5,
                    adaptive=True, confidence=0.9, seed=0)
    lab_adap = adap.annotate(idx, gt)
    assert 2 * len(idx) <= adap.votes_bought < flat.votes_bought
    assert np.mean(lab_adap == gt) >= np.mean(lab_flat == gt) - 0.02


def test_adaptive_confidence_extremes():
    idx, gt = _gt(300)
    never = _service(10, n_workers=5, noise=0.2, repeats=2, max_repeats=5,
                     adaptive=True, confidence=0.0, seed=0)
    never.annotate(idx, gt)
    assert never.votes_bought == 2 * len(idx)
    always = _service(10, n_workers=5, noise=0.2, repeats=2, max_repeats=5,
                      adaptive=True, confidence=1.1, seed=0)
    always.annotate(idx, gt)
    assert always.votes_bought == 5 * len(idx)


def test_service_budget_refuses_overdraft_without_phantom_state():
    svc = _service(10, n_workers=5, noise=0.1, repeats=2, seed=0,
                   pricing=LabelingService("svc", 0.04), budget=10.0)
    idx, gt = _gt(100)
    svc.annotate(idx, gt)
    before = (svc.request_cursor, svc.votes_bought, svc.ledger.human,
              svc.ledger.human_labels)
    with pytest.raises(BudgetExceeded):
        svc.annotate(idx + 100, gt)
    assert (svc.request_cursor, svc.votes_bought, svc.ledger.human,
            svc.ledger.human_labels) == before


def test_adaptive_topups_stop_at_budget_instead_of_raising():
    idx, gt = _gt(100)
    svc = _service(10, n_workers=5, noise=0.3, repeats=2, max_repeats=5,
                   adaptive=True, confidence=1.1,
                   pricing=LabelingService("svc", 0.04), budget=10.0, seed=0)
    assert len(svc.annotate(idx, gt)) == 100
    assert svc.votes_bought == 200
    assert svc.ledger.human == pytest.approx(8.0)


def test_repeat_policy_validation():
    with pytest.raises(AssertionError):
        RepeatPolicy(repeats=0)
    with pytest.raises(AssertionError):
        RepeatPolicy(repeats=3, max_repeats=2)
    with pytest.raises(AssertionError):
        RepeatPolicy(aggregator="mode")
    with pytest.raises(AssertionError):
        AnnotationService(make_annotator_pool(3, 10),
                          RepeatPolicy(repeats=4), device="cpu")
    with pytest.raises(AssertionError):
        RepeatPolicy(repeats=2, adaptive=True)
    with pytest.raises(AssertionError):
        RepeatPolicy(repeats=1, max_repeats=5, adaptive=True,
                     aggregator="majority")
    assert RepeatPolicy(repeats=1, max_repeats=5, adaptive=True,
                        aggregator="ds").cap == 5


def test_submit_equals_synchronous_annotate():
    idx, gt = _gt(400)
    sync = _service(10, n_workers=5, noise=0.2, repeats=3, aggregator="ds",
                    seed=4)
    want = [sync.annotate(idx[:150], gt[:150]),
            sync.annotate(idx[150:], gt[150:])]
    broker = _service(10, n_workers=5, noise=0.2, repeats=3, aggregator="ds",
                      seed=4)
    futs = [broker.submit(idx[:150], gt[:150]),
            broker.submit(idx[150:], gt[150:])]
    np.testing.assert_array_equal(np.concatenate([f.result() for f in futs]),
                                  np.concatenate(want))
    assert broker.votes_bought == sync.votes_bought
    assert broker.request_cursor == sync.request_cursor == 2
    broker.close()
    broker.close()
    with pytest.raises(Exception):
        broker.submit(idx[:5], gt[:5]).result()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_service_state_resumes_across_packages(writer):
    """A service state written by either package (strict JSON) resumes in
    the other: the resumed service buys the votes the original does."""
    kw = dict(n_workers=5, noise=0.25, repeats=2, max_repeats=4,
              adaptive=True, aggregator="ds", seed=7)
    idx, gt = _gt(600)
    first = _service(10, **kw) if writer == "port" else \
        jmake_service(10, **kw)
    first.annotate(idx[:300], gt[:300])
    blob = json.loads(json.dumps(first.state_dict()))
    second = jmake_service(10, **kw) if writer == "port" else \
        _service(10, **kw)
    second.load_state_dict(blob)
    assert second.request_cursor == first.request_cursor
    assert second.votes_bought == first.votes_bought
    np.testing.assert_array_equal(second.annotate(idx[300:], gt[300:]),
                                  first.annotate(idx[300:], gt[300:]))
    assert second.ledger.human == pytest.approx(first.ledger.human)
    np.testing.assert_array_equal(second.worker_accuracy(),
                                  first.worker_accuracy())


def test_calibrate_has_no_side_effects():
    svc = _service(10, n_workers=5, noise=0.15, spammer_frac=0.2, repeats=2,
                   max_repeats=4, adaptive=True, aggregator="ds", seed=0)
    q1 = svc.calibrate()
    assert svc.votes_bought == 0 and svc.request_cursor == 0
    assert svc.ledger.human == 0.0 and svc._conf_n == 0
    assert svc.calibrate() == q1
    assert q1.residual_error < svc.expected_quality().residual_error


def test_single_vote_batches_keep_analytic_estimates():
    svc = _service(10, n_workers=5, noise=0.3, repeats=1, seed=0)
    idx, gt = _gt(2000)
    svc.annotate(idx, gt)
    assert svc.estimated_residual_error() == pytest.approx(
        svc.expected_quality().residual_error)
    np.testing.assert_array_equal(svc.worker_accuracy(), np.ones(5))
    assert svc.confusion_estimate() is None


def test_session_is_a_per_tenant_view():
    """Two sessions of one service: each schedules off its own cursor, so
    its labels do not depend on the other's requests, and each counts only
    its own votes."""
    idx, gt = _gt(300)
    svc = _service(10, n_workers=5, noise=0.2, repeats=3, seed=2)
    a, b = svc.session("a"), svc.session("b")
    la = a.annotate(idx[:100], gt[:100])
    b.annotate(idx[100:], gt[100:])
    la2 = a.annotate(idx[:100], gt[:100])
    alone = _service(10, n_workers=5, noise=0.2, repeats=3, seed=2).session()
    np.testing.assert_array_equal(la, alone.annotate(idx[:100], gt[:100]))
    np.testing.assert_array_equal(la2, alone.annotate(idx[:100], gt[:100]))
    assert a.votes_bought == 600 and b.votes_bought == 600
    assert svc.votes_bought == 1200
    assert a.state_dict() == {"session": True, "cursor": 2, "votes": 600,
                              "labels": 200}
    # the seams are ported: a session's fault plan is its own, and its
    # metrics are the service's
    from repro_torch.faults import (FaultInjector, FaultPlan, FaultRule,
                                    RetryPolicy)
    from repro_torch.obs import MetricsRegistry
    m = MetricsRegistry()
    a.attach_metrics(m)
    assert svc.metrics is m and svc.aggregator.metrics is m
    a.attach_faults(FaultInjector(FaultPlan(rules=(
        FaultRule("annotation.request", "transient", at=(0,)),))),
        RetryPolicy(sleep_scale=0.0))
    la3 = a.annotate(idx[:100], gt[:100])       # retried, charged once
    b.annotate(idx[100:], gt[100:])            # the sibling: no plan
    np.testing.assert_array_equal(la3, alone.annotate(idx[:100], gt[:100]))
    assert a.votes_bought == 900 and b.votes_bought == 1200
    retries = {c["labels"]["site"]: c["value"]
               for c in m.snapshot()["counters"] if c["name"] ==
               "retries_total"}
    assert retries == {"annotation.request": 1.0}


# ---------------------------------------------------------------------------
# noisy campaigns
# ---------------------------------------------------------------------------


def _noisy(make, service_fn, pool_size, **kw):
    t = make("cifar10", "resnet18", seed=0, pool_size=pool_size,
             sweep_page=512)
    t.annotation = service_fn(t.num_classes, n_workers=5, seed=0, **kw)
    return t


@pytest.mark.parametrize("kw,eps", [
    (dict(noise=0.2, repeats=3), 0.05),
    (dict(noise=0.1, repeats=3, aggregator="ds"), 0.1),
    (dict(noise=0.2, repeats=2, max_repeats=4, adaptive=True,
          aggregator="ds"), 0.1)])
def test_noisy_emulated_campaign_matches_jax(kw, eps, tmp_path):
    """The noisy replay campaign (4,000 rows) under both packages, each
    with its service's calibrated quality: the same decision, labels and
    repeats-inclusive ledger; the traces diff clean under both diffs."""
    def make(*a, **k):
        return make_emulated_task(*a, device="cpu", **k)
    out = {}
    for name, (mk, svc_fn, Cfg, run, service, Store) in {
            "jax": (jmake_task, jmake_service, JConfig, jrun_mcal, JAMAZON,
                    JTraceStore),
            "port": (make, _service, MCALConfig, run_mcal, AMAZON,
                     TraceStore)}.items():
        task = _noisy(mk, svc_fn, 4000, pricing=service, **kw)
        lq = task.annotation.calibrate()
        path = str(tmp_path / f"{name}.jsonl")
        store = Store(path, "cifar10-resnet18-s0")
        res = run(task, service, Cfg(seed=0, eps_target=eps,
                                     label_quality=lq), trace=store)
        store.close()
        out[name] = (res, path, task, lq)
    (res, path, task, lq), (jres, jpath, jtask, jlq) = out["port"], \
        out["jax"]
    assert vars(lq) == vars(jlq)
    assert (res.decision, res.B_size, res.S_size, res.total_cost) == \
        (jres.decision, jres.B_size, jres.S_size, jres.total_cost)
    np.testing.assert_array_equal(res.labels, jres.labels)
    assert res.ledger == jres.ledger
    assert res.ledger["human_votes"] == task.annotation.votes_bought
    assert res.measured_error <= eps + lq.residual_error
    assert diff(path, jpath) is None and jdiff(jpath, path) is None


def test_noisy_emulated_campaign_resumes_from_a_jax_state_file(tmp_path):
    """``repro.launch.label.run_campaign`` preempts a noisy replay campaign
    after two iterations; the port resumes its state file (annotation
    state included) and ends where the uninterrupted JAX campaign ends."""
    kw = dict(noise=0.2, repeats=2, max_repeats=4, adaptive=True,
              aggregator="ds")
    state = str(tmp_path / "state.json")
    jtask = _noisy(jmake_task, jmake_service, 4000, pricing=JAMAZON, **kw)
    cfg = dict(seed=0, eps_target=0.1)
    jres, _ = jrun_campaign(jtask, JAMAZON, JConfig(
        label_quality=jtask.annotation.calibrate(), **cfg),
        state_path=state, iters_per_run=2)
    assert jres is None
    assert json.load(open(state))["campaign"]["annotation"]["cursor"] > 0
    task = _noisy(lambda *a, **k: make_emulated_task(*a, device="cpu", **k),
                  _service, 4000, pricing=AMAZON, **kw)
    res, _ = run_campaign(task, AMAZON, MCALConfig(
        label_quality=task.annotation.calibrate(), **cfg), state_path=state)
    jtask = _noisy(jmake_task, jmake_service, 4000, pricing=JAMAZON, **kw)
    want = jrun_mcal(jtask, JAMAZON, JConfig(
        label_quality=jtask.annotation.calibrate(), **cfg))
    assert (res.decision, res.B_size, res.S_size) == \
        (want.decision, want.B_size, want.S_size)
    assert res.total_cost == pytest.approx(want.total_cost, rel=1e-12)
    np.testing.assert_array_equal(res.labels, want.labels)
    assert task.annotation.votes_bought == jtask.annotation.votes_bought


SEED = 4
LIVE = dict(num_classes=10, epochs=10, seed=SEED, score_microbatch=256,
            sweep_page=256)


def test_noisy_live_campaign_matches_jax():
    """A live MLP campaign (1,600 rows, as tests/test_torch_campaign.py)
    buying its labels from a DS service (noise 0.2, 3 votes each): the
    port's retrains start from the JAX package's init and epoch orders;
    the two classifiers differ in their last bits, so the campaigns are
    held to that test's tolerances, and the votes they buy per label
    exactly."""
    x, y = make_classification(1600, num_classes=10, dim=16, difficulty=0.3,
                               seed=SEED)
    kw = dict(n_workers=5, noise=0.2, repeats=3, aggregator="ds", seed=SEED)
    cfg = dict(seed=SEED, max_iters=3, delta0_frac=0.02, eps_target=0.1)
    jsvc = jmake_service(10, **kw)
    jtask = JLiveTask(features=x, groundtruth=y, annotation=jsvc, **LIVE)
    jcamp = JCampaign(jtask, JAMAZON, JConfig(label_quality=jsvc.calibrate(),
                                              **cfg))
    want = jcamp.run()
    jcamp.close()
    svc = _service(10, **kw)
    task = LiveTask(features=x, groundtruth=y, device="cpu", annotation=svc,
                    fit_source=_jax_fit_source(jtask), **LIVE)
    camp = MCALCampaign(task, AMAZON, MCALConfig(
        label_quality=svc.calibrate(), **cfg))
    res = camp.run()
    camp.close()
    assert res.decision == want.decision
    assert abs(res.B_size - want.B_size) <= 0.05 * want.B_size
    assert res.total_cost == pytest.approx(want.total_cost, rel=0.02)
    assert res.ledger["human_votes"] == 3 * res.ledger["human_labels"]
    assert res.ledger["human_votes"] == svc.votes_bought
    assert (res.labels >= 0).all()


def test_noisy_live_campaign_preempted_diffs_clean(tmp_path):
    """The port's noisy live campaign preempted every two iterations and
    resumed from its state file (service state included) reaches the
    uninterrupted result, and its trace diffs clean against it."""
    x, y = make_classification(1500, num_classes=6, dim=8, difficulty=0.2,
                               seed=3)
    kw = dict(n_workers=5, noise=0.2, repeats=3, aggregator="ds", seed=3)
    cfg = MCALConfig(seed=3, max_iters=4, delta0_frac=0.02, eps_target=0.1)

    def task():
        return LiveTask(features=x, groundtruth=y, num_classes=6, epochs=4,
                        seed=3, score_microbatch=128, sweep_page=512,
                        device="cpu", annotation=_service(6, **kw))
    whole, cut = str(tmp_path / "whole.jsonl"), str(tmp_path / "cut.jsonl")
    want, _ = run_campaign(task(), AMAZON, cfg, trace_path=whole)
    state, res, runs = str(tmp_path / "s.json"), None, 0
    while res is None:
        res, _ = run_campaign(task(), AMAZON, cfg, state_path=state,
                              iters_per_run=2, trace_path=cut)
        runs += 1
    assert runs >= 2
    assert (res.decision, res.B_size, res.S_size, res.total_cost) == \
        (want.decision, want.B_size, want.S_size, want.total_cost)
    np.testing.assert_array_equal(res.labels, want.labels)
    assert diff(whole, cut) is None and jdiff(cut, whole) is None
