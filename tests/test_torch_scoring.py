"""The port's pool-scoring engine against the JAX engine on carried params:
ScoreStats at the kernel tests' tolerances (fp32 5e-5, entropy 10x, top1
exact), and top-k / rank orders exactly — on pools with duplicated rows,
whose equal scores must resolve to the lower index, as ``lax.top_k`` and
the stable host argsort do."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.scoring import PoolScoringEngine as JEngine
from repro.core.scoring import ScoringConfig as JScoringConfig
from repro.models.registry import get_model as jget_model
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scoring import (PoolScoringEngine, ScoringConfig,
                                      head_stats, pack_shape,
                                      score_pool_reference)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model

TOL = 5e-5


def _setup(n, dim=12, classes=7, dups=0, seed=0):
    kw = dict(name="mlp-s", family="mlp", num_layers=2, d_model=24,
              num_classes=classes, input_dim=dim, dtype="float32")
    jm = jget_model(JModelConfig(remat="none", **kw))
    jparams = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    if dups:
        x[rng.integers(0, n, dups)] = x[rng.integers(0, n, dups)]
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, get_model(ModelConfig(**kw)), params, x


def _close(got, want):
    for g, w, t in zip(got[:3], want[:3], (TOL, TOL * 10, TOL)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=t,
                                   rtol=t)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


@pytest.mark.parametrize("n,mb", [(300, 64), (37, 64), (1000, 128)])
def test_score_matches_jax_engine(n, mb):
    jm, jparams, model, params, x = _setup(n)
    jstats, jfeats = JEngine(jm, JScoringConfig(microbatch=mb)).score_host(
        jparams, x)
    eng = PoolScoringEngine(model, ScoringConfig(microbatch=mb),
                            device="cpu")
    stats, feats = eng.score_host(params, x)
    assert stats.margin.shape == (n,) and feats.shape == (n, 24)
    _close(stats, jstats)
    np.testing.assert_allclose(feats, jfeats, atol=1e-5)
    # the seed host loop agrees with the engine
    rstats, rfeats = score_pool_reference(model, params, x, chunk=100,
                                          device="cpu")
    _close(rstats, stats)
    np.testing.assert_allclose(rfeats, feats, atol=1e-6)


@pytest.mark.parametrize("metric", ["margin", "entropy", "least_confidence"])
def test_top_k_and_rank_orders_match_jax_with_ties(metric):
    jm, jparams, model, params, x = _setup(400, dups=120, seed=1)
    jeng = JEngine(jm, JScoringConfig(microbatch=128))
    eng = PoolScoringEngine(model, ScoringConfig(microbatch=128),
                            device="cpu")
    for k in (1, 17, 400):
        np.testing.assert_array_equal(eng.top_k(params, x, k, metric),
                                      jeng.top_k(jparams, x, k, metric))
    np.testing.assert_array_equal(eng.rank_confident(params, x, metric),
                                  jeng.rank_confident(jparams, x, metric))


def test_duplicate_rows_tie_to_the_lower_index():
    _, _, model, params, x = _setup(64, seed=2)
    x[40] = x[3]
    x[41] = x[3]
    eng = PoolScoringEngine(model, ScoringConfig(microbatch=16), device="cpu")
    order = list(eng.top_k(params, x, 64))
    assert order.index(3) < order.index(40) < order.index(41)


def test_pack_shape_and_head_modes():
    assert pack_shape(5, 2048) == (1, 8)
    assert pack_shape(3000, 2048) == (2, 2048)
    assert pack_shape(50_000, 2048) == (32, 2048)
    rng = np.random.default_rng(3)
    h = torch.as_tensor(rng.normal(size=(30, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 50)).astype(np.float32))
    dense = head_stats(h, w, mode="dense")
    for mode in ("auto", "chunked", "kernel"):
        _close(head_stats(h, w, mode=mode, vocab_chunk=16), dense)
    with pytest.raises(ValueError):
        head_stats(h, w, mode="pallas")
