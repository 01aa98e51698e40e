"""The token-pool path of ``PoolScoringEngine`` for the ``ssm``, ``moe`` and
``vlm`` families (mamba2-1.3b, dbrx-132b and internvl2-26b smoke; a VLM's
pool is its text, as in the reference) against the JAX package's host
oracle ``score_pool_reference``, and the paged sweep over the same pool
against the unpaged pass.

One param tree (numpy, cast to fp32, carried by ``models.convert``) and
one numpy int32 pool go to both packages.  The MoE's capacity routing
couples the rows of one forward (a row's copies compete for expert slots
with the others'), so the pool (48 rows) is scored in the same forwards
everywhere: the engine's microbatches of 16 (three, and a fourth of
padding alone), the oracle's chunks of 16, and pages of 32 and 16 rows,
each a whole number of microbatches.  Statistics and features agree to
atol 1e-5 and rtol 1e-6, as in ``test_torch_scoring_tokens.py``; top1,
the M(.) top-k order and the L(.) ranking are equal, index order
included; the paged sweep equals the unpaged pass exactly and stages the
ids as int32."""
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
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serving.sweep import (EngineSweepAdapter, PoolSweepRunner,
                                       RankTop1Sink, StatsSink, SweepConfig,
                                       TopKSink)
from test_torch_scoring_tokens import _jax_params

ARCHS = ("mamba2-1.3b", "dbrx-132b", "internvl2-26b")
N, SEQ, MB, PAGE, K = 48, 12, 16, 32, 10


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_smoke(arch)
    tree = _jax_params(arch)
    pool = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (N, SEQ)).astype(np.int32)
    want = jscoring.score_pool_reference(
        jget_model(jget_smoke(arch)), jax.tree.map(jnp.asarray, tree), pool,
        chunk=MB)
    model = get_model(cfg)
    engine = PoolScoringEngine(model, ScoringConfig(microbatch=MB),
                               device="cpu")
    return model, params_from_jax(tree, device="cpu"), engine, pool, want


def test_token_engine_matches_jax_oracle(setup):
    _, params, engine, pool, (want, want_feats) = setup
    assert engine.pool_dtype == torch.int32
    stats, feats = engine.score_host(params, pool)
    assert stats.margin.shape == (N,) and feats.shape == want_feats.shape
    for name in ("margin", "entropy", "max_logprob"):
        np.testing.assert_allclose(getattr(stats, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(stats.top1, want.top1)
    np.testing.assert_allclose(feats, want_feats, atol=1e-5, rtol=1e-6)
    assert engine.cache_keys() == [(4, MB)]


@pytest.mark.parametrize("metric", ["margin", "entropy",
                                    "least_confidence"])
def test_token_topk_and_rank_match_jax_oracle(setup, metric):
    """The oracle's orders: lax.top_k over the uncertainty (ties to the
    lower index) and the stable argsort of the L(.) ranking."""
    _, params, engine, pool, (want, _) = setup
    scores = sel.uncertainty_scores(metric, want)
    np.testing.assert_array_equal(
        engine.top_k(params, pool, K, metric),
        np.argsort(-scores, kind="stable")[:K])
    np.testing.assert_array_equal(engine.rank_confident(params, pool, metric),
                                  np.argsort(scores, kind="stable"))


def test_paged_token_sweep_equals_unpaged_pass(setup):
    _, params, engine, pool, _ = setup
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
        runner.close()
    finally:
        engine.score_pages = score_pages
    assert set(staged) == {(torch.int32, (2, MB, SEQ)),
                           (torch.int32, (1, MB, SEQ))}
    stats, _ = engine.score(params, pool)
    np.testing.assert_array_equal(top, engine.top_k(params, pool, K))
    np.testing.assert_array_equal(order, engine.rank_confident(params, pool))
    np.testing.assert_array_equal(top1, stats.top1.numpy())
    for got, want in zip(packed, stats):
        assert torch.equal(got, want)
