"""The replay mode: ``EmulatedTask``, its campaigns, the baselines, the
label pool and the launcher's replay mode, run by the JAX package and by
the port on the same seeds.

Every emulator draw is numpy in both packages, so scores, features,
predictions and the labels bought are bit-equal, and so are the campaigns
of the uncertainty metrics and ``random``: their decisions, labels and
traces (diffed by both packages' ``diff``).  k-center ranks the float
features (conf, u) by fp32 squared distances, where the two packages'
expansions split near ties (``src/repro/core/selection_device.py``
documents the hazard): its campaigns are held to equal decisions, and the
first split of each is pinned as a near tie against float64 distances.
"""
import json
import sys

import numpy as np
import pytest

from repro.core import AMAZON as JAMAZON
from repro.core import MCALConfig as JConfig
from repro.core import run_mcal as jrun_mcal
from repro.core import selection_device as jsd
from repro.core.baselines import oracle_al as joracle_al
from repro.core.baselines import run_naive_al as jrun_naive_al
from repro.core.emulator import CALIBRATIONS as JCALIBRATIONS
from repro.core.emulator import DATASETS as JDATASETS
from repro.core.emulator import make_emulated_task as jmake
from repro.data.pool import LabelPool as JLabelPool
from repro.launch import label as jlabel
from repro.trace import TraceStore as JTraceStore
from repro.trace import diff as jdiff
from repro_torch.core import (AMAZON, DATASETS, MCALConfig, make_emulated_task,
                              oracle_al, run_mcal, run_naive_al)
from repro_torch.core import selection_device as tsd
from repro_torch.core.emulator import CALIBRATIONS
from repro_torch.data import pool as tpool
from repro_torch.launch import label
from repro_torch.trace import TraceStore, diff


def _task(dataset, arch, **kw):
    return make_emulated_task(dataset, arch, device="cpu", **kw)


def _arch(dataset):
    return next(a for d, a in CALIBRATIONS if d == dataset)


def test_calibrations_and_datasets_are_the_references():
    assert DATASETS == JDATASETS
    assert CALIBRATIONS == JCALIBRATIONS


@pytest.mark.parametrize("dataset", sorted(JDATASETS))
def test_emulated_task_draws_match_jax(dataset):
    """u, the labels, and at three training sizes the stats, features,
    predictions and correctness of a scattered index set: bit-equal."""
    arch = _arch(dataset)
    pool = 30_000 if dataset == "imagenet" else None
    jt = jmake(dataset, arch, seed=3, pool_size=pool)
    t = _task(dataset, arch, seed=3, pool_size=pool)
    np.testing.assert_array_equal(t.u, jt.u)
    np.testing.assert_array_equal(t.labels_gt, jt.labels_gt)
    idx = np.random.default_rng(0).choice(t.pool_size, 3000, replace=False)
    for B in (0, 400, 5000):
        jt.train(np.arange(B), None)
        t.train(np.arange(B), None)
        (js, jf), (s, f) = jt.score(idx), t.score(idx)
        for a, b in zip(s, js):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(t.predict(idx), jt.predict(idx))
        np.testing.assert_array_equal(
            t.eval_correct(idx, t.labels_gt[idx]),
            jt.eval_correct(idx, jt.labels_gt[idx]))
        np.testing.assert_array_equal(t.oracle_labels(idx),
                                      jt.oracle_labels(idx))


def test_machine_label_sweep_pages_like_the_full_pool():
    """The paged commit sweep (pages of 512 over 3,000 rows) equals the
    reference's sweep and a stable argsort of the whole pass."""
    jt = jmake("cifar10", "resnet18", pool_size=6000, sweep_page=512)
    t = _task("cifar10", "resnet18", pool_size=6000, sweep_page=512)
    for task in (jt, t):
        task.train(np.arange(700), None)
    idx = np.arange(1000, 4000)
    order, top1 = t.machine_label_sweep(idx)
    jorder, jtop1 = jt.machine_label_sweep(idx)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(top1, jtop1)
    stats, _ = t.score(idx)
    np.testing.assert_array_equal(order, np.argsort(-stats.margin,
                                                    kind="stable"))


def _campaigns(metric, pool, tmp_path, **cfg):
    out = {}
    for name, (make, Cfg, run, service, Store) in {
            "jax": (jmake, JConfig, jrun_mcal, JAMAZON, JTraceStore),
            "port": (lambda *a, **k: _task(*a, **k), MCALConfig, run_mcal,
                     AMAZON, TraceStore)}.items():
        path = str(tmp_path / f"{name}.jsonl")
        store = Store(path, "cifar10-resnet18-s0")
        res = run(make("cifar10", "resnet18", pool_size=pool), service,
                  Cfg(eps_target=0.05, seed=0, metric=metric, **cfg),
                  trace=store)
        store.close()
        out[name] = (res, path)
    return out


def _same_result(res, jres):
    assert (res.decision, res.B_size, res.S_size, len(res.history)) == \
        (jres.decision, jres.B_size, jres.S_size, len(jres.history))
    assert res.total_cost == jres.total_cost
    assert res.measured_error == jres.measured_error
    assert res.theta_final == jres.theta_final
    np.testing.assert_array_equal(res.labels, jres.labels)
    np.testing.assert_array_equal(res.machine_mask, jres.machine_mask)
    assert res.ledger == jres.ledger
    assert [r.to_dict() for r in res.history] == \
        [r.to_dict() for r in jres.history]


@pytest.mark.parametrize("metric", ["margin", "entropy",
                                    "least_confidence", "random"])
def test_replay_campaign_matches_jax(metric, tmp_path):
    """cifar10/resnet18 at the paper's 50,000 rows: equal results, records
    and labels; the traces diff clean under both packages' ``diff``."""
    runs = _campaigns(metric, None, tmp_path)
    (res, path), (jres, jpath) = runs["port"], runs["jax"]
    _same_result(res, jres)
    assert diff(path, jpath) is None and jdiff(jpath, path) is None


def test_replay_budget_campaign_matches_jax(tmp_path):
    runs = _campaigns("margin", None, tmp_path, budget=500.0)
    (res, path), (jres, jpath) = runs["port"], runs["jax"]
    assert res.decision == "budget"
    _same_result(res, jres)
    assert diff(path, jpath) is None and jdiff(jpath, path) is None


def test_imagenet_bails_out_like_jax():
    """The paper's ImageNet bail-out (§5.1) at 1.2 M rows: human_all after
    the exploration tax, as in the reference."""
    res = run_mcal(_task("imagenet", "efficientnet-b0"), AMAZON,
                   MCALConfig(eps_target=0.05, seed=0))
    jres = jrun_mcal(jmake("imagenet", "efficientnet-b0"), JAMAZON,
                     JConfig(eps_target=0.05, seed=0))
    assert res.decision == "human_all"
    _same_result(res, jres)


def _min_dists_f64(X, A, chosen):
    """float64 min squared distance of every row of X to the anchors and
    the rows ``chosen``."""
    X = np.asarray(X, np.float32).astype(np.float64)
    min_d = np.full(len(X), np.inf)
    for c in list(np.asarray(A, np.float32).astype(np.float64)) + \
            [X[i] for i in chosen]:
        min_d = np.minimum(min_d, ((X - c) ** 2).sum(1))
    return min_d


# (pool, split call, its candidates, k, anchors, first differing pick)
KCENTER_SPLITS = [(5000, 3, 4550, 450, 200, 75),
                  (10_000, 3, 9100, 1200, 400, 120)]


@pytest.mark.parametrize("pool,call,n,k,m,pick", KCENTER_SPLITS)
def test_replay_kcenter_campaign_decides_like_jax(pool, call, n, k, m, pick,
                                                  monkeypatch):
    """k-center over the emulated features (conf, u), cifar10/resnet18,
    seed 0.  Both packages give the k-center call the same inputs, and the
    calls before ``call`` pick alike; at ``call`` the picks part at
    ``pick``: a near tie, the two candidates' float64 min-distances within
    the fp32 expansion's rounding (4 ulp of the largest ||x||^2 + ||c||^2)
    of the float64 greedy's maximum.  The emulator's error depends only on
    |B|, so the records, decision, |B|, |S| and cost are equal, and the
    measured error moves by at most the rows one campaign machine-labels
    and the other does not."""
    calls = {"jax": [], "port": []}

    def record(mod, key):
        fn = mod.k_center_greedy_device

        def wrapped(feats, k, anchors=None, **kw):
            out = fn(feats, k, anchors=anchors, **kw)
            calls[key].append((np.asarray(feats), k, np.asarray(anchors),
                               np.asarray(out)))
            return out
        monkeypatch.setattr(mod, "k_center_greedy_device", wrapped)

    record(jsd, "jax")
    record(tsd, "port")
    cfg = dict(eps_target=0.05, seed=0, metric="kcenter")
    jres = jrun_mcal(jmake("cifar10", "resnet18", pool_size=pool),
                     JAMAZON, JConfig(**cfg))
    res = run_mcal(_task("cifar10", "resnet18", pool_size=pool), AMAZON,
                   MCALConfig(**cfg))
    for i in range(call):
        np.testing.assert_array_equal(calls["port"][i][3],
                                      calls["jax"][i][3])
    jf, jk, ja, jp = calls["jax"][call]
    f, kk, a, p = calls["port"][call]
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(a, ja)
    assert (len(f), kk, len(a)) == (n, k, m)
    assert int(np.nonzero(p != jp)[0][0]) == pick
    np.testing.assert_array_equal(p[:pick], jp[:pick])
    min_d = _min_dists_f64(f, a, p[:pick])
    norms = (np.asarray(f, np.float64) ** 2).sum(1)
    tol = 4 * 2.0 ** -24 * 2 * norms.max()
    for q in (p[pick], jp[pick]):
        assert min_d.max() - min_d[q] <= tol
    assert [r.to_dict() for r in res.history] == \
        [r.to_dict() for r in jres.history]
    assert (res.decision, res.B_size, res.S_size, res.total_cost) == \
        (jres.decision, jres.B_size, jres.S_size, jres.total_cost)
    assert (res.labels >= 0).all() and (jres.labels >= 0).all()
    # only rows machine-labeled by one campaign and not the other can
    # carry a different label
    n_diff = int(np.sum(res.machine_mask != jres.machine_mask))
    assert abs(res.measured_error - jres.measured_error) <= \
        n_diff / res.labels.size + 1e-12


@pytest.mark.parametrize("delta_frac", [0.02, 0.1])
def test_naive_al_matches_jax(delta_frac):
    got = run_naive_al(_task("cifar10", "resnet18"), AMAZON, delta_frac)
    want = jrun_naive_al(jmake("cifar10", "resnet18"), JAMAZON, delta_frac)
    assert vars(got) == vars(want)


def test_oracle_al_matches_jax():
    deltas = (0.033, 0.067, 0.133)
    best, res, allr = oracle_al(lambda: _task("fashion", "resnet18"), AMAZON,
                                deltas=deltas)
    jbest, jres, jall = joracle_al(lambda: jmake("fashion", "resnet18"),
                                   JAMAZON, deltas=deltas)
    assert best == jbest and vars(res) == vars(jres)
    assert {d: vars(r) for d, r in allr.items()} == \
        {d: vars(r) for d, r in jall.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_label_pool_files_cross_packages(writer, tmp_path):
    path = str(tmp_path / "pool.npz")
    rng = np.random.default_rng(1)
    src = (tpool.LabelPool if writer == "port" else JLabelPool)(500)
    src.mark(rng.choice(500, 40, replace=False), tpool.TEST,
             rng.integers(0, 10, 40))
    src.mark(rng.choice(500, 70, replace=False), tpool.MACHINE,
             rng.integers(0, 10, 70))
    src.save(path)
    dst = (JLabelPool if writer == "port" else tpool.LabelPool).load(path)
    np.testing.assert_array_equal(dst.state, src.state)
    np.testing.assert_array_equal(dst.labels, src.labels)
    assert dst.counts() == src.counts()
    np.testing.assert_array_equal(dst.unlabeled, src.unlabeled)


REPORT_KEYS = ("decision", "B_frac", "S_frac", "theta_final",
               "measured_error", "cost", "human_all_cost", "savings",
               "ledger", "iterations")


def _reports(argv, tmp_path, monkeypatch):
    """Both launchers' reports for ``argv`` (the port's on the CPU)."""
    jout, out = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    monkeypatch.setattr(sys, "argv", ["label", *argv, "--out", jout])
    jlabel.main()
    label.main([*argv, "--device", "cpu", "--out", out])
    return json.load(open(out)), json.load(open(jout))


@pytest.mark.parametrize("argv", [
    ["--dataset", "cifar10"],
    ["--dataset", "fashion", "--arch", "cnn18", "--metric", "entropy"],
    ["--dataset", "cifar100", "--service", "satyam", "--budget", "900"]])
def test_launcher_replay_mode_matches_jax(argv, tmp_path, monkeypatch,
                                          capsys):
    got, want = _reports(argv, tmp_path, monkeypatch)
    for key in REPORT_KEYS:
        assert got[key] == want[key], key
    assert "annotation" not in got


def test_launcher_replay_preempt_and_resume(tmp_path, capsys):
    """A replay campaign preempted every two iterations and resumed from
    its state file reports what the uninterrupted one does, and its trace
    diffs clean against it."""
    base = ["--dataset", "cifar10", "--device", "cpu"]
    whole, cut = str(tmp_path / "whole.jsonl"), str(tmp_path / "cut.jsonl")
    label.main([*base, "--trace", whole, "--out", str(tmp_path / "a.json")])
    state = str(tmp_path / "state.json")
    runs = 0
    while True:
        label.main([*base, "--state", state, "--iters-per-run", "2",
                    "--trace", cut, "--out", str(tmp_path / "b.json")])
        runs += 1
        if not (tmp_path / "state.json").exists():
            break
    assert runs >= 3
    a = json.load(open(tmp_path / "a.json"))
    b = json.load(open(tmp_path / "b.json"))
    assert {k: a[k] for k in REPORT_KEYS} == {k: b[k] for k in REPORT_KEYS}
    assert diff(whole, cut) is None and jdiff(cut, whole) is None
