"""The port's paged pool-sweep runtime against its oracles and against the
JAX package's runtime.

Every sink agrees exactly with the port engine's unpaged pass — the top-k
reservoir with ``PoolScoringEngine.top_k``, the streaming rank with the
stable argsort over the engine's stats, the feature emitter with
``pool_features`` — ragged final pages, duplicate-row ties (the first
global index wins) and a cursor cut at every page boundary included
(the grids of ``tests/test_sweep.py``).  Against the JAX package's
``PoolSweepRunner`` on the same params (carried across as numpy): top-k
indices and top1 exactly, the statistics and features at the scoring
tests' tolerances (fp32 5e-5, entropy 10x), and the rank as an order that
sorts the JAX package's scores up to that tolerance.  A cursor cut by
either runtime resumes in the other."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.scoring import PoolScoringEngine as JEngine
from repro.core.scoring import ScoringConfig as JScoringConfig
from repro.models.registry import get_model as jget_model
from repro.serving import sweep as jsweep
from repro_torch.configs.base import ModelConfig
from repro_torch.core import selection as sel
from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving import sweep as psweep
from repro_torch.serving.sweep import (EngineSweepAdapter, FeatureSink,
                                       HostTaskAdapter, PoolSweepRunner,
                                       RankTop1Sink, StatsSink,
                                       SweepCheckpoint, SweepConfig,
                                       TopKSink)

METRICS = ("margin", "entropy", "least_confidence")
TOL = 5e-5


@pytest.fixture(scope="module")
def sweep_setup():
    kw = dict(name="sweep-probe", family="mlp", num_layers=2, d_model=64,
              num_classes=10, input_dim=32, dtype="float32")
    jm = jget_model(JModelConfig(remat="none", **kw))
    jparams = jm.init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(0).normal(size=(2000, 32)).astype(np.float32)
    engine = PoolScoringEngine(get_model(ModelConfig(**kw)),
                               ScoringConfig(microbatch=256), device="cpu")
    runner = PoolSweepRunner(EngineSweepAdapter(engine),
                             SweepConfig(page_rows=512))
    jrunner = jsweep.PoolSweepRunner(
        jsweep.EngineSweepAdapter(JEngine(jm, JScoringConfig(
            microbatch=256))), jsweep.SweepConfig(page_rows=512))
    return engine, runner, params, x, jrunner, jparams


# ---------------------------------------------------------------------------
# sink oracle grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [100, 512, 1000, 1537, 2000])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_topk_sink_matches_engine_topk(sweep_setup, metric, n, k):
    engine, runner, params, x = sweep_setup[:4]
    got = runner.run(params, x[:n], TopKSink(k, metric))
    want = engine.top_k(params, x[:n], k, metric)
    np.testing.assert_array_equal(got, want)


def test_topk_sink_duplicate_row_ties(sweep_setup):
    """Duplicate rows across pages tie exactly; both sides keep the first
    global index."""
    engine, runner, params, x = sweep_setup[:4]
    xd = np.tile(x[:50], (20, 1))   # 1000 rows, 50 distinct
    got = runner.run(params, xd, TopKSink(64, "margin"))
    want = engine.top_k(params, xd, 64, "margin")
    np.testing.assert_array_equal(got, want)
    # each of the 50 distinct rows appears once per copy: the picks are
    # the first copies before any later one of the same row
    assert len(set(got.tolist())) == 64


def test_topk_sink_k_larger_than_pool(sweep_setup):
    engine, runner, params, x = sweep_setup[:4]
    got = runner.run(params, x[:100], TopKSink(500, "margin"))
    want = engine.top_k(params, x[:100], 500, "margin")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (100,)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [100, 1000, 1537, 2000])
def test_rank_sink_matches_host_ranking(sweep_setup, metric, n):
    engine, runner, params, x = sweep_setup[:4]
    order, top1 = runner.run(params, x[:n], RankTop1Sink(metric))
    stats, _ = engine.score_host(params, x[:n])
    np.testing.assert_array_equal(
        order, sel.rank_for_machine_labeling(stats, metric))
    np.testing.assert_array_equal(top1, np.asarray(stats.top1, np.int64))


@pytest.mark.parametrize("n", [512, 1300, 2000])
def test_feature_sink_matches_pool_features(sweep_setup, n):
    engine, runner, params, x = sweep_setup[:4]
    feats = runner.run(params, x[:n], FeatureSink())
    assert isinstance(feats, torch.Tensor)
    torch.testing.assert_close(feats, engine.pool_features(params, x[:n]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n", [100, 1537, 2000])
def test_stats_sink_matches_engine_score(sweep_setup, n):
    engine, runner, params, x = sweep_setup[:4]
    packed = runner.run(params, x[:n], StatsSink())
    stats, _ = engine.score_host(params, x[:n])
    for f in ("margin", "entropy", "max_logprob", "top1"):
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      getattr(stats, f))


# ---------------------------------------------------------------------------
# resumable cursor
# ---------------------------------------------------------------------------


def _sinks(mod):
    return [mod.TopKSink(32, "entropy"), mod.RankTop1Sink("margin"),
            mod.FeatureSink(), mod.StatsSink()]


def _fresh(sink, mod=psweep):
    """A new sink like ``sink`` from the sweep module ``mod``."""
    return {"topk": lambda: mod.TopKSink(sink.k, sink.metric),
            "rank": lambda: mod.RankTop1Sink(sink.metric),
            "features": mod.FeatureSink, "stats": mod.StatsSink}[sink.kind]()


def _as_arrays(result):
    if isinstance(result, tuple):
        return [np.asarray(r) for r in result]
    return [np.asarray(result)]


@pytest.mark.parametrize("sink", _sinks(psweep), ids=lambda s: s.kind)
@pytest.mark.parametrize("stop_page", [0, 1, 2, 3, 4])
def test_cursor_save_restore_bit_identical(sweep_setup, sink, stop_page):
    """A cursor cut at every page boundary, round-tripped through JSON and
    resumed with a fresh sink, folds bit-identically to one sweep."""
    _, runner, params, x = sweep_setup[:4]   # 2000 rows / 512 = 4 pages
    ckpt = runner.run_until(params, x, _fresh(sink), stop_page)
    assert ckpt.next_page == min(stop_page, runner.n_pages(x.shape[0]))
    restored = SweepCheckpoint.from_json(ckpt.to_json())
    resumed = runner.run(params, x, _fresh(sink), checkpoint=restored)
    uninterrupted = runner.run(params, x, _fresh(sink))
    for a, b in zip(_as_arrays(resumed), _as_arrays(uninterrupted)):
        np.testing.assert_array_equal(a, b)


def test_cursor_checkpoint_is_json(sweep_setup):
    _, runner, params, x = sweep_setup[:4]
    ckpt = runner.run_until(params, x, RankTop1Sink(), 2)
    blob = json.loads(ckpt.to_json())
    assert blob["next_page"] == 2 and blob["n"] == 2000
    assert blob["sink_kind"] == "rank"


def test_cursor_validation_rejects_mismatches(sweep_setup):
    _, runner, params, x = sweep_setup[:4]
    ckpt = runner.run_until(params, x, RankTop1Sink(), 1)
    with pytest.raises(ValueError):   # wrong sink kind
        runner.run(params, x, TopKSink(8, "margin"), checkpoint=ckpt)
    with pytest.raises(ValueError):   # wrong pool size
        runner.run(params, x[:1000], RankTop1Sink(), checkpoint=ckpt)
    other = PoolSweepRunner(runner.adapter, SweepConfig(page_rows=256))
    with pytest.raises(ValueError):   # wrong page size
        other.run(params, x, RankTop1Sink(), checkpoint=ckpt)
    with pytest.raises(ValueError):   # wrong rank metric
        runner.run(params, x, RankTop1Sink("entropy"), checkpoint=ckpt)
    tk = runner.run_until(params, x, TopKSink(16, "margin"), 1)
    with pytest.raises(ValueError):   # wrong top-k metric
        runner.run(params, x, TopKSink(16, "entropy"), checkpoint=tk)
    with pytest.raises(ValueError):   # wrong k
        runner.run(params, x, TopKSink(8, "margin"), checkpoint=tk)


def test_cursor_unfilled_reservoir_is_strict_json(sweep_setup):
    _, runner, params, x = sweep_setup[:4]
    ckpt = runner.run_until(params, x, TopKSink(1000, "margin"), 1)
    blob = ckpt.to_json()
    json.loads(blob)
    assert "Infinity" not in blob
    resumed = runner.run(params, x, TopKSink(1000, "margin"),
                         checkpoint=SweepCheckpoint.from_json(blob))
    full = runner.run(params, x, TopKSink(1000, "margin"))
    np.testing.assert_array_equal(resumed, full)


def test_checkpoint_cuts_every_n_pages(sweep_setup):
    """``run`` with ``checkpoint_every`` hands a cursor to the callback at
    every cut but the last; resuming the first one ends where the sweep
    ends."""
    _, runner, params, x = sweep_setup[:4]
    cuts = []
    full = runner.run(params, x, RankTop1Sink(), checkpoint_every=1,
                      on_checkpoint=cuts.append)
    assert [c.next_page for c in cuts] == [1, 2, 3]
    resumed = runner.run(params, x, RankTop1Sink(), checkpoint=cuts[0])
    for a, b in zip(resumed, full):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# async handle
# ---------------------------------------------------------------------------


def test_submit_future_matches_sync_run(sweep_setup):
    _, runner, params, x = sweep_setup[:4]
    fut = runner.submit(params, x, TopKSink(16, "margin"))
    sync = runner.run(params, x, TopKSink(16, "margin"))
    np.testing.assert_array_equal(fut.result(), sync)
    assert fut.done()


def test_submit_map_result(sweep_setup):
    _, runner, params, x = sweep_setup[:4]
    cand = np.arange(5000, 7000)
    fut = runner.submit(params, x, TopKSink(8, "margin"),
                        map_result=lambda rows: cand[rows])
    sync = cand[runner.run(params, x, TopKSink(8, "margin"))]
    np.testing.assert_array_equal(fut.result(), sync)


# ---------------------------------------------------------------------------
# against the JAX package's runtime
# ---------------------------------------------------------------------------


def _held(got, want):
    """One sink deliverable of the port against the JAX package's."""
    if hasattr(want, "margin"):             # stats
        for f, t in (("margin", TOL), ("entropy", 10 * TOL),
                     ("max_logprob", TOL)):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       atol=t, rtol=t)
        np.testing.assert_array_equal(got.top1.numpy(),
                                      np.asarray(want.top1))
        return
    if isinstance(want, tuple):             # rank: (order, top1)
        np.testing.assert_array_equal(got[1], want[1])
        assert sorted(got[0].tolist()) == list(range(len(got[0])))
        return
    if isinstance(got, torch.Tensor):       # features
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        return
    np.testing.assert_array_equal(got, np.asarray(want))   # top-k indices


@pytest.mark.parametrize("kind", ["topk", "rank", "features", "stats"])
@pytest.mark.parametrize("n", [1000, 1537])
def test_sinks_match_jax_runner(sweep_setup, kind, n):
    engine, runner, params, x, jrunner, jparams = sweep_setup
    jsink = {s.kind: s for s in _sinks(jsweep)}[kind]
    sink = _fresh(jsink)
    got = runner.run(params, x[:n], sink)
    want = jrunner.run(jparams, x[:n], _fresh(jsink, jsweep))
    _held(got, want)
    if kind == "rank":
        # the port's order sorts the JAX package's scores, up to TOL
        jstats, _ = jrunner.adapter.engine.score_host(jparams, x[:n])
        s = sel.uncertainty_scores("margin", jstats)[got[0]]
        assert np.all(np.diff(s) >= -TOL)


@pytest.mark.parametrize("kind", ["topk", "rank", "features", "stats"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cursor_resumes_across_packages(sweep_setup, kind, direction):
    """A cursor cut after two of four pages by one package's runtime,
    resumed by the other's, gives that package's uninterrupted
    deliverable (exactly for indices and top1, else at TOL)."""
    engine, runner, params, x, jrunner, jparams = sweep_setup
    jsink = {s.kind: s for s in _sinks(jsweep)}[kind]
    if direction == "jax_to_port":
        blob = jrunner.run_until(jparams, x, _fresh(jsink, jsweep),
                                 2).to_json()
        got = runner.run(params, x, _fresh(jsink),
                         checkpoint=SweepCheckpoint.from_json(blob))
        want = runner.run(params, x, _fresh(jsink))
        if kind == "rank":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            _held(got, want if kind != "features" else want.numpy())
    else:
        blob = runner.run_until(params, x, _fresh(jsink), 2).to_json()
        got = jrunner.run(jparams, x, _fresh(jsink, jsweep),
                          checkpoint=jsweep.SweepCheckpoint.from_json(blob))
        want = jrunner.run(jparams, x, _fresh(jsink, jsweep))
        if kind == "rank":
            np.testing.assert_array_equal(got[1], want[1])
        elif kind == "topk":
            np.testing.assert_array_equal(got, want)
        elif kind == "features":
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(np.asarray(got.margin),
                                       np.asarray(want.margin), atol=TOL)
            np.testing.assert_array_equal(np.asarray(got.top1),
                                          np.asarray(want.top1))


# ---------------------------------------------------------------------------
# host adapter + task routing + serving
# ---------------------------------------------------------------------------


def _trained_task(**kw):
    from repro_torch.core import LiveTask
    from repro_torch.data.synth import make_classification

    x, y = make_classification(900, num_classes=10, dim=16,
                               difficulty=0.3, seed=2)
    task = LiveTask(features=x, groundtruth=y, num_classes=10, epochs=3,
                    seed=2, sweep_page=256, score_microbatch=256,
                    device="cpu", **kw)
    task.train(np.arange(200), y[:200])
    return task


def test_host_adapter_cursor_resume():
    task = _trained_task()
    runner = PoolSweepRunner(HostTaskAdapter(task.score),
                             SweepConfig(page_rows=300))
    idx = np.arange(900)
    ckpt = runner.run_until(None, idx, RankTop1Sink(), 2)
    resumed = runner.run(None, idx, RankTop1Sink(),
                         checkpoint=SweepCheckpoint.from_json(ckpt.to_json()))
    full = runner.run(None, idx, RankTop1Sink())
    np.testing.assert_array_equal(resumed[0], full[0])
    np.testing.assert_array_equal(resumed[1], full[1])
    stats, _ = task.score(idx)
    np.testing.assert_array_equal(full[1], np.asarray(stats.top1, np.int64))


def test_live_task_sweep_routing_matches_engine_paths():
    """LiveTask's paged pool passes (top-k, L(.) rank, anchors, k-center)
    agree with the engine's unpaged passes."""
    from repro_torch.core.selection_device import k_center_greedy_device
    task = _trained_task()
    cand = np.arange(300, 900)
    picks = task.topk_candidates("margin", 32, cand)
    want = cand[task._engine.top_k(task._params, task._pool(cand), 32,
                                   "margin")]
    np.testing.assert_array_equal(picks, want)

    order, top1 = task.machine_label_sweep(cand, "margin")
    stats, _ = task.score(cand)
    np.testing.assert_array_equal(
        order, sel.rank_for_machine_labeling(stats, "margin"))
    np.testing.assert_array_equal(top1, np.asarray(stats.top1, np.int64))

    anchors = task.anchor_features(np.arange(200))
    want_feats = task._engine.pool_features(
        task._params, task._pool(np.arange(200))).numpy()
    np.testing.assert_array_equal(anchors, want_feats)

    picked, pf = task.kcenter_candidates(8, cand, anchors=anchors)
    feats = task._engine.pool_features(task._params, task._pool(cand))
    rows = k_center_greedy_device(feats, 8, anchors=anchors, device="cpu")
    np.testing.assert_array_equal(picked, cand[rows])
    np.testing.assert_array_equal(pf, feats[torch.as_tensor(rows)].numpy())

    fut = task.submit_candidates("margin", 32, cand)
    np.testing.assert_array_equal(fut.result(), picks)
    fut = task.submit_candidates("kcenter", 8, cand, anchors=anchors)
    np.testing.assert_array_equal(fut.result()[0], picked)
    task.close()


def test_engine_pack_keys_and_warm():
    """Pages note the reference's (n_mb, mb) pack keys; warm scores one
    page of each bucket not swept yet."""
    task = _trained_task()
    task.topk_candidates("margin", 8, np.arange(300, 900))
    # 600 rows in pages of 256: two full pages (1, 256) and a tail of 88
    assert (1, 256) in task._engine.cache_keys()
    assert (1, 128) in task._engine.cache_keys()
    assert task._engine.warm(task._params, [(2, 256), (1, 256)]) == 1
    assert task._engine.warm(task._params, [(2, 256)]) == 0
    assert (2, 256) in task._engine.cache_keys()


def test_serve_engine_score_pool_pages_match_batch_loop():
    """zamba2's smoke config: ``ServeEngine.score_pool`` pages equal the
    per-batch ``score`` loop (serving tolerance, ragged tail included), a
    cursor resumes mid-pool, and the async handle gives the same stats."""
    from repro_torch.configs import get_smoke
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke("zamba2-2.7b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    N, T, page = 10, 8, 4
    pool = {"tokens": rng.integers(0, cfg.vocab_size, (N, T)).astype(
        np.int32)}
    eng = ServeEngine(model, params, max_seq=T + 4, batch_size=page,
                      device="cpu")
    packed = eng.score_pool(pool, page_rows=page)
    assert int(packed.margin.shape[0]) == N

    margins, top1 = [], []
    for lo in range(0, N, page):
        stats = eng.score({"tokens": pool["tokens"][lo:lo + page]})
        margins.append(stats.margin.numpy())
        top1.append(stats.top1.numpy())
    np.testing.assert_allclose(packed.margin.numpy(),
                               np.concatenate(margins), atol=1e-5)
    np.testing.assert_array_equal(packed.top1.numpy(), np.concatenate(top1))

    # pages of 8 rows are the score step's own batch shape: exact
    eng8 = ServeEngine(model, params, max_seq=T + 4, batch_size=8,
                       device="cpu")
    pool8 = {"tokens": rng.integers(0, cfg.vocab_size, (16, T))}
    p8 = eng8.score_pool(pool8)
    for lo in (0, 8):
        s = eng8.score({"tokens": pool8["tokens"][lo:lo + 8]})
        for f in ("margin", "entropy", "max_logprob", "top1"):
            torch.testing.assert_close(getattr(p8, f)[lo:lo + 8],
                                       getattr(s, f), rtol=0, atol=0)

    runner = eng._sweep_runner(page)
    ckpt = runner.run_until(params, pool, StatsSink(), 1)
    resumed = runner.run(params, pool, StatsSink(),
                         checkpoint=SweepCheckpoint.from_json(ckpt.to_json()))
    np.testing.assert_array_equal(resumed.margin.numpy(),
                                  packed.margin.numpy())
    fut = eng.score_pool_async(pool, page_rows=page)
    np.testing.assert_array_equal(fut.result().margin.numpy(),
                                  packed.margin.numpy())
    eng.close()
    eng8.close()
