"""The campaign runtime on a card (skipped without one; ``chip_smoke.py``
runs the same checks at the campaigns' sizes).  Imports no JAX, so it runs
on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_runtime_cuda.py

The retrain's CUDA graph replays the kernels the eager loop launches, so
its params and losses are bit-identical to it; paged sinks compute every
row in a microbatch of the unpaged pass's shape, so they equal it exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
from repro_torch.models.registry import get_model
from repro_torch.serving.sweep import (EngineSweepAdapter, FeatureSink,
                                       PoolSweepRunner, RankTop1Sink,
                                       SweepConfig, TopKSink)
from repro_torch.training.fit_device import FitConfig, FitEngine

KW = dict(name="mlp-live", family="mlp", num_layers=2, d_model=64,
          num_classes=10, input_dim=32, dtype="float32")
TC = dict(learning_rate=1e-2, schedule="constant", weight_decay=1e-4,
          grad_clip=1.0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks "
                    "on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 500, 1000])
def test_graph_retrain_equals_eager_loop(n):
    _need_card()
    eng = FitEngine(get_model(ModelConfig(**KW)), TrainConfig(**TC),
                    FitConfig(epochs=5, batch_size=256), device="cuda")
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    y = rng.integers(0, 10, n)
    for seed in (0, 1):      # a second retrain replays the same graph
        pg, lg = eng.fit(seed, x, y)
        pe, le = eng.fit_eager(seed, x, y)
        torch.testing.assert_close(lg, le, rtol=0, atol=0)
        for k in pe:
            torch.testing.assert_close(pg[k], pe[k], rtol=0, atol=0)
    assert len(eng._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6000, 9500, 20000])
def test_paged_sinks_equal_unpaged_pass(n):
    _need_card()
    model = get_model(ModelConfig(**KW))
    params = model.init(0, "cuda")
    engine = PoolScoringEngine(model, ScoringConfig(microbatch=2048),
                               device="cuda")
    runner = PoolSweepRunner(EngineSweepAdapter(engine),
                             SweepConfig(page_rows=8192))
    x = np.random.default_rng(n).normal(size=(n, 32)).astype(np.float32)
    stats, feats = engine.score(params, x)
    order, top1 = runner.run(params, x, RankTop1Sink("margin"))
    want = np.argsort(-stats.margin.double().cpu().numpy(), kind="stable")
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(top1, stats.top1.cpu().numpy())
    torch.testing.assert_close(runner.run(params, x, FeatureSink()), feats,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(runner.run(params, x, TopKSink(500)),
                                  engine.top_k(params, x, 500))


def _together(fn, n):
    import threading
    gate = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        try:
            gate.wait()
            out[i] = fn(i)
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("first_use", [True, False])
def test_shared_fit_engine_two_threads_equal_serial(first_use):
    """Two threads retraining in one bucket of one engine (the fleet's
    shared FitEngine) get the serial params bit for bit; a first use
    from both captures the bucket's graph once."""
    _need_card()
    eng = FitEngine(get_model(ModelConfig(**KW)), TrainConfig(**TC),
                    FitConfig(epochs=5, batch_size=256), device="cuda")
    rng = np.random.default_rng(7)
    jobs = [(seed, rng.normal(size=(n, 32)).astype(np.float32),
             rng.integers(0, 10, n)) for seed, n in ((0, 700), (1, 900))]
    serial = FitEngine(eng.model, eng.tc, eng.cfg, device="cuda")
    want = [serial.fit(*job) for job in jobs]
    if not first_use:
        eng.fit(*jobs[0])
    for _ in range(3):
        got = _together(lambda i: eng.fit(*jobs[i]), 2)
        for (p, loss), (wp, wl) in zip(got, want):
            torch.testing.assert_close(loss, wl, rtol=0, atol=0)
            for k in wp:
                torch.testing.assert_close(p[k], wp[k], rtol=0, atol=0)
    assert eng.captures == len(eng._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("round_", range(3))
def test_engines_of_two_widths_first_used_at_once_equal_serial(round_):
    """Two fit engines of different widths (architecture selection's
    candidates, each on its own fit worker) used for the first time on
    two threads at once: their captures take ``CAPTURE_LOCK`` in turn,
    each engine captures its bucket once, and each thread gets the params
    its engine gives it alone."""
    _need_card()
    widths = (32, 128)
    models = [get_model(ModelConfig(**dict(KW, d_model=d))) for d in widths]
    rng = np.random.default_rng(round_)
    jobs = [(seed, rng.normal(size=(n, 32)).astype(np.float32),
             rng.integers(0, 10, n)) for seed, n in ((0, 700), (1, 1500))]
    cfg = FitConfig(epochs=5, batch_size=256)
    want = [FitEngine(m, TrainConfig(**TC), cfg, device="cuda").fit(*job)
            for m, job in zip(models, jobs)]
    engines = [FitEngine(m, TrainConfig(**TC), cfg, device="cuda")
               for m in models]
    got = _together(lambda i: engines[i].fit(*jobs[i]), 2)
    for (p, loss), (wp, wl) in zip(got, want):
        torch.testing.assert_close(loss, wl, rtol=0, atol=0)
        for k in wp:
            torch.testing.assert_close(p[k], wp[k], rtol=0, atol=0)
    assert [e.captures for e in engines] == [1, 1]


def _live_selection(fit_async):
    from repro_torch.core import (AMAZON, LiveTask, MCALConfig,
                                  select_architecture)
    from repro_torch.data.synth import make_classification
    x, y = make_classification(700, num_classes=10, dim=16, difficulty=0.3,
                               seed=4)
    tasks = {f"h{h}": LiveTask(features=x, groundtruth=y, num_classes=10,
                               epochs=3, seed=4, sweep_page=256,
                               score_microbatch=256, hidden=h)
             for h in (32, 64)}
    cfg = MCALConfig(seed=4, max_iters=4, delta0_frac=0.02,
                     fit_async=fit_async, sweep_async=fit_async)
    try:
        return select_architecture(tasks, AMAZON, cfg, max_explore_iters=3)
    finally:
        for t in tasks.values():
            t.close()


@pytest.mark.cuda
def test_live_arch_selection_async_equals_sync_on_card():
    """The reference's contract (``tests/test_fit_device.py``) on the
    card: with ``fit_async`` every candidate's retrain runs at once on its
    own engine, and the winner, every history and the labels equal the
    synchronous selection's."""
    _need_card()
    (w_s, res_s, hist_s) = _live_selection(False)
    (w_a, res_a, hist_a) = _live_selection(True)
    assert w_s == w_a
    for name in hist_s:
        for field in ("cstar", "training_spent", "human_spent"):
            assert [getattr(r, field) for r in hist_s[name]] == \
                [getattr(r, field) for r in hist_a[name]]
    assert res_s.total_cost == res_a.total_cost
    np.testing.assert_array_equal(res_s.labels, res_a.labels)


@pytest.mark.cuda
def test_shared_sweep_runner_two_threads_equal_serial():
    """Two threads sweeping through one runner (one adapter, one staging
    ring per thread) get the serial sinks."""
    _need_card()
    model = get_model(ModelConfig(**KW))
    params = model.init(0, "cuda")
    engine = PoolScoringEngine(model, ScoringConfig(microbatch=2048),
                               device="cuda")
    runner = PoolSweepRunner(EngineSweepAdapter(engine),
                             SweepConfig(page_rows=4096))
    pools = [np.random.default_rng(n).normal(size=(n, 32)).astype(
        np.float32) for n in (30000, 23000)]
    want = [(runner.run(params, x, RankTop1Sink("margin")),
             runner.run(params, x, FeatureSink()),
             runner.run(params, x, TopKSink(700))) for x in pools]
    for _ in range(3):
        got = _together(lambda i: (
            runner.run(params, pools[i], RankTop1Sink("margin")),
            runner.run(params, pools[i], FeatureSink()),
            runner.run(params, pools[i], TopKSink(700))), 2)
        for (rank, feats, topk), (wrank, wfeats, wtopk) in zip(got, want):
            np.testing.assert_array_equal(rank[0], wrank[0])
            np.testing.assert_array_equal(rank[1], wrank[1])
            torch.testing.assert_close(feats, wfeats, rtol=0, atol=0)
            np.testing.assert_array_equal(topk, wtopk)


@pytest.mark.cuda
def test_fenced_span_waits_on_its_own_event_only():
    """A span fenced on a value waits for the stream work queued before
    that value, not for another stream's (a whole-device synchronize
    would charge one tenant with every tenant's kernels)."""
    _need_card()
    from repro_torch.obs import MetricsRegistry
    other = torch.cuda.Stream()
    mine = torch.cuda.Stream()
    busy = torch.cuda.Event()
    with torch.cuda.stream(other):
        torch.cuda._sleep(2_000_000_000)        # about a second
        busy.record(other)
    events = []

    class Trace:
        def emit(self, kind, **payload):
            events.append(payload)
    m = MetricsRegistry(trace=Trace())
    with torch.cuda.stream(mine):
        with m.span("fit") as sp:
            value = torch.ones(1 << 20, device="cuda") * 2.0
            sp.fence(value)
    assert not busy.query(), "the span waited for the other stream"
    assert value.sum().item() == 2.0 * (1 << 20)
    assert events[-1]["fenced"] is True
    busy.synchronize()
