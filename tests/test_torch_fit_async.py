"""The port's retrain engine beyond the synchronous ``fit``: the
device-resident labeled set, the async handle, and the bucket keys held
against the JAX engine's.  On the CPU every path is the eager loop over
the same orders, so they agree bit for bit; the fused CUDA-graph retrain
is held against the eager loop on the card
(``tests/test_torch_runtime_cuda.py``, ``chip_smoke.py``)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models.registry import get_model as jget_model
from repro.training.fit_device import FitConfig as JFitConfig
from repro.training.fit_device import FitEngine as JFitEngine
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.registry import get_model
from repro_torch.training.fit_device import FitConfig, FitEngine, fit_plan

TC = dict(learning_rate=1e-2, schedule="constant", weight_decay=1e-4,
          grad_clip=1.0)
KW = dict(name="mlp-f", family="mlp", num_layers=1, d_model=16,
          num_classes=4, input_dim=8, dtype="float32")


def _engine(epochs=2, batch=64):
    return FitEngine(get_model(ModelConfig(**KW)), TrainConfig(**TC),
                     FitConfig(epochs=epochs, batch_size=batch),
                     device="cpu")


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.integers(0, 4, size=n).astype(np.int64))


def _same(a, b):
    (pa, la), (pb, lb) = a, b
    assert sorted(pa) == sorted(pb)
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)


@pytest.mark.parametrize("chunks", [[150], [100, 50], [40, 60, 50, 230]])
def test_fit_resident_equals_fit(chunks):
    """The resident set, grown chunk by chunk across bucket boundaries,
    retrains exactly as ``fit`` over the whole set."""
    eng = _engine()
    x, y = _data(sum(chunks))
    lo = 0
    for c in chunks:
        n = eng.extend_resident(x[lo:lo + c], y[lo:lo + c])
        lo += c
        assert n == lo == eng.resident_size
        assert eng._res_x.shape[0] == fit_plan(n, 64)[2]
        _same(eng.fit_resident(7), eng.fit(7, x[:n], y[:n]))
    eng.reset_resident()
    assert eng.resident_size == 0
    with pytest.raises(ValueError, match="empty"):
        eng.fit_resident(7)


def test_submit_fit_and_submit_call_equal_fit():
    eng = _engine()
    x, y = _data(200, seed=1)
    fut = eng.submit_fit(3, x, y)
    _same(fut.result(timeout=60), eng.fit(3, x, y))
    assert fut.done()
    call = eng.submit_call(lambda a, b: eng.fit(3, a, b), x, y)
    _same(call.result(timeout=60), eng.fit(3, x, y))
    eng.close()
    assert not eng._exec.alive


def test_fit_eager_and_fit_reference_equal_fit_on_cpu():
    eng = _engine()
    x, y = _data(130, seed=2)
    want = eng.fit(4, x, y)
    _same(eng.fit_eager(4, x, y), want)
    _same(eng.fit_reference(4, x, y), want)


def test_cache_keys_equal_jax_engine():
    """The same sequence of retrain sizes (growing, shrinking, repeated)
    leaves the same bucket keys in both engines; ``warm`` adds the same
    keys to both."""
    sizes = [20, 100, 300, 70, 520, 300]
    jeng = JFitEngine(jget_model(JModelConfig(remat="none", **KW)),
                      JTrainConfig(**TC), JFitConfig(epochs=1, batch_size=64))
    eng = _engine(epochs=1)
    for i, n in enumerate(sizes):
        x, y = _data(n, seed=i)
        jeng.fit(jax.random.key(i), x, y.astype(np.int32))
        eng.fit(i, x, y)
    want = [tuple(int(v) for v in k) for k in jeng.cache_keys()]
    assert eng.cache_keys() == want
    assert eng.cache_keys() == sorted({fit_plan(n, 64) for n in sizes})
    jeng.warm([(16, 64, 1024), 1500])
    assert eng.warm([(16, 64, 1024), 1500]) == 0   # nothing to build on CPU
    assert eng.cache_keys() == [tuple(int(v) for v in k)
                                for k in jeng.cache_keys()]


def test_task_fit_paths_agree():
    """LiveTask's retrain routes (fit, fit_resident over append-only
    growth and a rebuild, the host-loop oracle) give one classifier."""
    from repro_torch.core import LiveTask
    from repro_torch.data.synth import make_classification

    x, y = make_classification(400, num_classes=4, dim=8, seed=3)
    tasks = {name: LiveTask(features=x, groundtruth=y, num_classes=4,
                            epochs=2, seed=3, device="cpu", **kw)
             for name, kw in (("fit", {}), ("resident", {"fit_resident": True}),
                              ("reference", {"fit_fused": False}))}
    for idx in (np.arange(100), np.arange(160), np.arange(50, 200)):
        params = {}
        for name, task in tasks.items():
            assert task.train(idx, y[idx]) == pytest.approx(
                task.train_cost(len(idx)))
            params[name] = task._params
        for name in ("resident", "reference"):
            for k in params["fit"]:
                torch.testing.assert_close(params[name][k],
                                           params["fit"][k], rtol=0, atol=0)
    assert tasks["resident"]._fit.resident_size == 150
    keys = tasks["fit"].pack_cache_keys()
    assert keys["fit"] == [list(k) for k in
                           sorted({fit_plan(n, 256) for n in (100, 160, 150)})]


def test_measured_cost_prices_wall_time():
    from repro_torch.core import LiveTask
    from repro_torch.data.synth import make_classification

    x, y = make_classification(100, num_classes=3, dim=4, seed=0)
    task = LiveTask(features=x, groundtruth=y, num_classes=3, epochs=1,
                    device="cpu", measured_cost=True, price_per_hour=3600.0)
    assert task.train_cost(50) is None
    c = task.train(np.arange(50), y[:50])
    assert 0 < c < 60          # $1 a second: the retrain took under a minute
