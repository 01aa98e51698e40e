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
