"""The port's layers, MLP and schedules against the JAX package, on the same
numpy inputs (fp32 summation order differs between XLA:CPU and torch, so
float results agree to 1e-5; ``top1`` exactly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import layers as JL
from repro.models.registry import get_model as jget_model
from repro.training.schedules import make_schedule as jmake_schedule
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.mlp import MLP
from repro_torch.models.registry import get_model
from repro_torch.training.schedules import make_schedule

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 32)])
def test_norms_match_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    b = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    np.testing.assert_allclose(L.rmsnorm(_t(x), _t(w)).numpy(),
                               np.asarray(JL.rmsnorm(x, w)), atol=ATOL)
    np.testing.assert_allclose(L.layernorm(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(JL.layernorm(x, w, b)), atol=ATOL)


def _logits(T, V, seed, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, V)).astype(np.float32) * 3
    if ties:   # duplicated maxima: first index must win
        x = np.round(x)
    return x


@pytest.mark.parametrize("T,V,ties", [(64, 10, False), (50, 257, False),
                                      (40, 7, True)])
def test_score_stats_from_logits_match_jax(T, V, ties):
    x = _logits(T, V, T + V, ties)
    got = L.score_stats_from_logits(_t(x))
    want = JL.score_stats_from_logits(jnp.asarray(x))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_array_equal(got.top1.numpy(), np.asarray(want.top1))


@pytest.mark.parametrize("T,D,V,chunk", [(33, 16, 100, 32), (20, 8, 64, 64),
                                         (17, 12, 10, 4)])
def test_chunked_score_stats_match_jax(T, D, V, chunk):
    rng = np.random.default_rng(T)
    h = rng.normal(size=(T, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.3).astype(np.float32)
    got = L.chunked_score_stats(_t(h), _t(w), chunk=chunk)
    want = JL.chunked_score_stats(jnp.asarray(h), jnp.asarray(w), chunk=chunk)
    for g, wv in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=ATOL)
    np.testing.assert_array_equal(got.top1.numpy(), np.asarray(want.top1))


@pytest.mark.parametrize("T,V", [(32, 10), (7, 300)])
def test_cross_entropy_matches_jax(T, V):
    x = _logits(T, V, 1)
    y = np.random.default_rng(2).integers(0, V, size=T)
    np.testing.assert_allclose(
        float(L.cross_entropy(_t(x), _t(y))),
        float(JL.cross_entropy(jnp.asarray(x), jnp.asarray(y))), atol=ATOL)


def _cfgs(norm="rmsnorm", depth=3):
    kw = dict(name="mlp-t", family="mlp", num_layers=depth, d_model=32,
              num_classes=6, input_dim=12, dtype="float32", norm=norm)
    return JModelConfig(remat="none", **kw), ModelConfig(**kw)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_mlp_forward_with_carried_params(norm):
    jcfg, cfg = _cfgs(norm)
    jm = jget_model(jcfg)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    if norm == "rmsnorm":   # non-zero scale exercises the (1 + scale) rule
        jparams["final_norm"]["scale"] = np.full_like(
            jparams["final_norm"]["scale"], 0.25)
    x = np.random.default_rng(4).normal(size=(9, 12)).astype(np.float32)
    want = np.asarray(jm.forward(jparams, {"features": jnp.asarray(x)}))
    params = params_from_jax(jparams, device="cpu")
    got = get_model(cfg).forward(params, {"features": _t(x)})
    assert got.shape == (9, 1, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    module = MLP(cfg, params=params)
    np.testing.assert_allclose(module(_t(x)).detach().numpy(), want,
                               atol=ATOL)


def test_param_names_layouts_and_roundtrip():
    jcfg, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray, jget_model(jcfg).init(
        jax.random.key(0)))
    params = params_from_jax(jparams, device="cpu")
    assert sorted(params) == ["b_in", "blocks.b", "blocks.w", "cls_head",
                              "final_norm.scale", "w_in"]
    back = params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    own = get_model(cfg).init(7, device="cpu")
    module = MLP(cfg, seed=7, device="cpu")
    assert sorted(n for n, _ in module.named_parameters()) == sorted(own)
    assert isinstance(get_model(cfg).net, MLP)
    assert sorted(n for n, _ in get_model(cfg).net.named_parameters()) \
        == sorted(own)
    for name, p in module.named_parameters():
        assert p.shape == params[name].shape
        torch.testing.assert_close(p.detach(), own[name], rtol=0, atol=0)
    # rmsnorm scale starts at zero; weights are 1/sqrt(fan_in) normals,
    # fan_in = the product of all but the last dim, as in the reference
    assert float(own["final_norm.scale"].abs().max()) == 0.0
    assert abs(float(own["blocks.w"].std()) - 96 ** -0.5) < 0.01
    assert abs(float(jparams["blocks"]["w"].std()) - 96 ** -0.5) < 0.01
    again = get_model(cfg).init(7, device="cpu")
    assert all(torch.equal(own[k], again[k]) for k in own)
    other = get_model(cfg).init(8, device="cpu")
    assert not torch.equal(own["w_in"], other["w_in"])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "dbrx-132b",
                                  "internvl2-26b"])
def test_init_scales_each_draw_in_place_bit_for_bit(arch):
    """``init_params`` scales each fp32 draw in place (one full-width copy
    fewer on the host); every leaf keeps the bits of ``randn(...) * std``
    cast to its dtype, the draw before the change."""
    import zlib

    from repro_torch.configs import get_smoke
    from repro_torch.models import param as P
    model = get_model(get_smoke(arch))
    got = model.init(3, device="cpu")
    for path, spec in P.iter_specs(model.specs):
        if spec.init != "normal":
            continue
        leaf = zlib.crc32(P._keystr(path).encode()) % (2**31)
        g = torch.Generator().manual_seed(P.derive_seed(3, leaf))
        want = (torch.randn(spec.shape, generator=g, dtype=torch.float32)
                * P._stddev(spec)).to(spec.dtype)
        assert got[path].dtype == want.dtype
        assert torch.equal(got[path].view(torch.int16 if want.dtype ==
                                          torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if want.dtype ==
                                     torch.bfloat16 else torch.int32)), path


@pytest.mark.parametrize("warmup", [0, 5])
def test_constant_schedule_matches_jax(warmup):
    kw = dict(learning_rate=1e-2, schedule="constant", warmup_steps=warmup)
    want, got = jmake_schedule(JTrainConfig(**kw)), make_schedule(
        TrainConfig(**kw))
    for step in range(0, 45, 3):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6)
    # cosine and paper_steps are ported now (test_torch_train.py); an
    # unknown schedule is refused, as in the reference
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule(TrainConfig(schedule="linear"))
