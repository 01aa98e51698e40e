"""The token-pool path of ``PoolScoringEngine`` (MCAL's LLM-labeler pass:
an (N, T) int32 pool scored at the last position through the LM head)
against the JAX package's host oracle ``score_pool_reference``, for the
four dense smoke configs and zamba2's hybrid one, and the paged sweep over
the same pool against the unpaged pass.

One param tree (numpy, cast to fp32, carried by ``models.convert``) and
one numpy pool go to both packages.  Statistics and features agree to
atol 1e-5, as the reference holds its engine to its oracle
(``tests/test_scoring.py``), and to rtol 1e-6 where they are large (a few
fp32 steps); top1, the M(.) top-k order and the L(.) ranking are equal,
index order included.  The paged sweep equals the
unpaged pass exactly, its ragged last page included, and stages the ids
as int32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import scoring as jscoring
from repro.models.registry import get_model as jget_model
from repro_torch.configs import get_smoke
from repro_torch.core import selection as sel
from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
from repro_torch.models import param as P
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.sweep import (EngineSweepAdapter, PoolSweepRunner,
                                       RankTop1Sink, StatsSink, SweepConfig,
                                       TopKSink)

ARCHS = ("qwen2-1.5b", "gemma3-4b", "qwen1.5-4b", "phi3-medium-14b",
         "zamba2-2.7b")
N, SEQ, MB, PAGE, K = 40, 12, 16, 16, 10   # pages of 16, 16 and 8 rows


def _jax_params(arch: str, seed: int = 0):
    """The smoke config's params as numpy fp32 (normal weights at their
    init stddev; non-zero norm scales, biases and SSM scalars)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, spec in P.iter_specs(get_model(get_smoke(arch)).specs):
        std = P._stddev(spec) if spec.init == "normal" else 0.2
        a = rng.normal(size=spec.shape) * std + (spec.init == "ones")
        flat[path] = a.astype(np.float32)
    return P.nest(flat)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_smoke(arch)
    tree = _jax_params(arch)
    pool = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (N, SEQ)).astype(np.int32)
    want = jscoring.score_pool_reference(
        jget_model(jget_smoke(arch)), jax.tree.map(jnp.asarray, tree), pool)
    model = get_model(cfg)
    engine = PoolScoringEngine(model, ScoringConfig(microbatch=MB),
                               device="cpu")
    return arch, model, params_from_jax(tree, device="cpu"), engine, pool, \
        want


def test_token_engine_matches_jax_oracle(setup):
    _, _, params, engine, pool, (want, want_feats) = setup
    stats, feats = engine.score_host(params, pool)
    assert stats.margin.shape == (N,) and feats.shape == want_feats.shape
    # gemma3's margins and features reach ~50 (its tied embedding is
    # scaled by sqrt(d_model)), where one fp32 step is 4e-6 and two
    # summation orders part by a few steps: atol 1e-5 and rtol 1e-6
    for name in ("margin", "entropy", "max_logprob"):
        np.testing.assert_allclose(getattr(stats, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(stats.top1, want.top1)
    np.testing.assert_allclose(feats, want_feats, atol=1e-5, rtol=1e-6)
    assert engine.cache_keys() == [(4, MB)]
    np.testing.assert_array_equal(
        engine.pool_features(params, pool).numpy(), feats)


@pytest.mark.parametrize("metric", ["margin", "entropy",
                                    "least_confidence"])
def test_token_topk_and_rank_match_jax_oracle(setup, metric):
    """The oracle's orders: lax.top_k over the uncertainty (ties to the
    lower index) and the stable argsort of the L(.) ranking."""
    _, _, params, engine, pool, (want, _) = setup
    scores = sel.uncertainty_scores(metric, want)
    np.testing.assert_array_equal(
        engine.top_k(params, pool, K, metric),
        np.argsort(-scores, kind="stable")[:K])
    np.testing.assert_array_equal(engine.rank_confident(params, pool, metric),
                                  np.argsort(scores, kind="stable"))


def test_paged_token_sweep_equals_unpaged_pass(setup):
    _, _, params, engine, pool, _ = setup
    staged = []
    score_pages = engine.score_pages

    def spy(p, xs):
        staged.append((xs.dtype, tuple(xs.shape)))
        return score_pages(p, xs)
    engine.score_pages = spy
    try:
        runner = PoolSweepRunner(EngineSweepAdapter(engine),
                                 SweepConfig(page_rows=PAGE))
        top = runner.run(params, pool, TopKSink(K, "margin"))
        order, top1 = runner.run(params, pool, RankTop1Sink("margin"))
        packed = runner.run(params, pool, StatsSink())
    finally:
        engine.score_pages = score_pages
    assert set(staged) == {(torch.int32, (1, MB, SEQ)),
                           (torch.int32, (1, 8, SEQ))}
    stats, _ = engine.score(params, pool)
    np.testing.assert_array_equal(top, engine.top_k(params, pool, K))
    np.testing.assert_array_equal(order, engine.rank_confident(params, pool))
    np.testing.assert_array_equal(top1, stats.top1.numpy())
    for got, want in zip(packed, stats):
        assert torch.equal(got, want)


def test_token_engine_refuses_warm(setup):
    _, _, params, engine, _, _ = setup
    with pytest.raises(NotImplementedError, match="feature-classifier"):
        engine.warm(params, [(1, MB)])
