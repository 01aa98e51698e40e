"""The port's optimizer, train step and retrain engine against the JAX
package, starting from the JAX package's init params and epoch orders
(carried across as numpy: ``jax.random`` bits cannot be drawn in torch).
fp32 summation order differs between XLA:CPU and torch: one step agrees
to 1e-6; a 3-epoch retrain to 1e-4 in params and 1e-5 in losses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.registry import get_model as jget_model
from repro.training import optimizer as jopt
from repro.training.fit_device import FitConfig as JFitConfig
from repro.training.fit_device import FitEngine as JFitEngine
from repro.training.fit_device import _epoch_orders_jit
from repro.training.fit_device import fit_plan as jfit_plan
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.training import optimizer as opt
from repro_torch.training.fit_device import (FitConfig, FitEngine,
                                             epoch_orders, fit_plan)
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step)

TC = dict(learning_rate=1e-2, schedule="constant", weight_decay=1e-4,
          grad_clip=1.0)


def _models(dim=16, classes=10):
    kw = dict(name="mlp-f", family="mlp", num_layers=2, d_model=64,
              num_classes=classes, input_dim=dim, dtype="float32")
    return (jget_model(JModelConfig(remat="none", **kw)), JTrainConfig(**TC),
            get_model(ModelConfig(**kw)), TrainConfig(**TC))


def _data(n, dim=16, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.integers(0, classes, size=n).astype(np.int32))


def _assert_params(got, want, atol):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=atol),
                 params_to_numpy(got), jax.tree.map(np.asarray, want))


def test_one_train_step_matches_jax():
    """Adam's first step moves each element by lr * g / (|g| + 1e-8): an
    element whose gradient is within rounding of 1e-8 turns the
    frameworks' last-bit differences into up to lr, so these inputs are
    ones where no gradient element is that small."""
    jm, jtc, model, tc = _models()
    jstate = jinit_train_state(jm, jtc, jax.random.key(0))
    x, y = _data(256)
    jnew, jmet = jax.jit(jmake_train_step(jm, jtc, jit=False))(
        jstate, {"features": jnp.asarray(x), "labels": jnp.asarray(y)})
    state = init_train_state(model, tc, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), device="cpu"))
    new, met = make_train_step(model, tc)(
        state, {"features": torch.as_tensor(x), "labels": torch.as_tensor(y)})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               atol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    _assert_params(new["params"], jnew["params"], 1e-6)
    assert new["step"] == int(jnew["step"]) == 1


@pytest.mark.parametrize("step,max_norm", [(0, 1.0), (6, 0.05), (3, 0.0)])
def test_adamw_and_clip_match_jax(step, max_norm):
    rng = np.random.default_rng(step)
    shapes = {"a": (5, 7), "b": (7,), "c": (2, 3, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    m = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in shapes.items()}
    v = {k: np.abs(rng.normal(size=s)).astype(np.float32) * 0.1
         for k, s in shapes.items()}
    tc, jtc = TrainConfig(**TC), JTrainConfig(**TC)
    jg, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(a) for k, a in g.items()}, max_norm)
    tg, tnorm = opt.clip_by_global_norm(
        {k: torch.as_tensor(a) for k, a in g.items()}, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    jslots = [{"m": jnp.asarray(m[k]), "v": jnp.asarray(v[k])}
              for k in sorted(p)]
    jp, js = jopt.adamw_update({k: jnp.asarray(a) for k, a in p.items()}, jg,
                               jslots, jnp.int32(step), jnp.float32(1e-2),
                               jtc)
    tslots = [{"m": torch.as_tensor(m[k]), "v": torch.as_tensor(v[k])}
              for k in sorted(p)]
    tp, ts = opt.adamw_update({k: torch.as_tensor(a) for k, a in p.items()},
                              tg, tslots, step, 1e-2, tc)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6)
    for t, j in zip(ts, js):
        for name in ("m", "v"):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       atol=1e-6)


def _jax_start(jm, jtc, seed, n, epochs, batch):
    """What the JAX FitEngine trains from: its init params and orders."""
    init_key, shuffle_key = jax.random.split(jax.random.key(seed))
    params = jax.tree.map(np.asarray,
                          jinit_train_state(jm, jtc, init_key)["params"])
    key_data = jax.random.key_data(jax.random.fold_in(shuffle_key, n))
    orders = np.asarray(_epoch_orders_jit(
        key_data, epochs, fit_plan(n, batch)[2], jnp.int32(n)))
    return params, orders


def test_fit_matches_jax_fit_reference():
    """n = 700 with batch 256: a ragged tail that wraps, 3 epochs."""
    jm, jtc, model, tc = _models()
    n, epochs, batch, seed = 700, 3, 256, 5
    x, y = _data(n, seed=1)
    init, orders = _jax_start(jm, jtc, seed, n, epochs, batch)
    jparams, jlosses = JFitEngine(
        jm, jtc, JFitConfig(epochs=epochs, batch_size=batch)).fit_reference(
        jax.random.key(seed), x, y)
    eng = FitEngine(model, tc, FitConfig(epochs=epochs, batch_size=batch),
                    device="cpu")
    params, losses = eng.fit(seed, x, y, init_params=params_from_jax(
        init, device="cpu"), orders=orders)
    assert losses.shape == (epochs * fit_plan(n, batch)[0],)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               atol=1e-5)
    _assert_params(params, jparams, 1e-4)


def test_fit_and_fit_reference_are_bit_identical():
    _, _, model, tc = _models()
    x, y = _data(300, seed=2)
    eng = FitEngine(model, tc, FitConfig(epochs=2, batch_size=64),
                    device="cpu")
    p1, l1 = eng.fit(3, x, y)
    p2, l2 = eng.fit_reference(3, x, y)
    assert torch.equal(l1, l2)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    p3, _ = eng.fit(3, x, y)   # same seed -> same retrain
    assert all(torch.equal(p1[k], p3[k]) for k in p1)


@pytest.mark.parametrize("n,batch", [(700, 256), (5, 256), (512, 64)])
def test_epoch_orders_put_a_permutation_of_the_valid_rows_first(n, batch):
    spe, bs, n_pad = fit_plan(n, batch)
    assert (spe, bs, n_pad) == jfit_plan(n, batch)
    orders = epoch_orders(11, 4, n_pad, n)
    assert orders.shape == (4, n_pad)
    for row in orders.numpy():
        assert sorted(row[:n]) == list(range(n))
        assert sorted(row) == list(range(n_pad))
    assert torch.equal(orders, epoch_orders(11, 4, n_pad, n))
    assert not torch.equal(orders, epoch_orders(12, 4, n_pad, n))
