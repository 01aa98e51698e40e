"""The slice as a whole: one MCAL campaign over a live MLP, run by the JAX
package and by the port on the same data.  The port's retrains start from
the JAX package's init params and epoch orders (its ``fit_source`` seam),
since ``jax.random`` cannot be drawn in torch; everything else — the host
rng's test/seed sets, scoring, M(.), the power-law fits and the search —
is the port's own.  The two trained classifiers differ in the last bits
(fp32 summation order), so decisions are compared with tolerances: the
same test and seed sets, the first measurement within one test item, the
same decision, |B| within 5% and cost within 2%, and both meet the
accuracy target (a budget-constrained campaign: the budget).  The size is
the JAX package's own live-campaign test (dim 16, max_iters 3) with the
pool doubled to 1,600 rows and 10 epochs: at 800 rows the three
acquisitions leave |B| under 100, and the JAX package's own campaigns
commit at up to 0.109 measured error against the 0.05 target."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.cost import AMAZON as JAMAZON
from repro.core.mcal import MCALCampaign as JCampaign
from repro.core.mcal import MCALConfig as JConfig
from repro.core.task import LiveTask as JLiveTask
from repro.data.synth import make_classification as jmake_classification
from repro.training.fit_device import _epoch_orders_jit
from repro.training.train_loop import init_train_state
from repro_torch.core import AMAZON, LiveTask, MCALCampaign, MCALConfig
from repro_torch.data.synth import make_classification
from repro_torch.models.convert import params_from_jax
from repro_torch.training.fit_device import fit_plan

SEED = 4
TASK = dict(num_classes=10, epochs=10, seed=SEED, score_microbatch=256)
POOL = 1600
CFG = dict(seed=SEED, max_iters=3, delta0_frac=0.02, eps_target=0.05)


def _jax_fit_source(jtask):
    """n -> the init params and epoch orders the JAX task's retrain of n
    rows uses (``FitEngine._run_impl``'s key derivation)."""
    init_key, shuffle_key = jax.random.split(jax.random.key(jtask.seed))
    init = params_from_jax(jax.tree.map(np.asarray, init_train_state(
        jtask.model, jtask.tc, init_key)["params"]), device="cpu")

    def source(n):
        key_data = jax.random.key_data(jax.random.fold_in(shuffle_key, n))
        n_pad = fit_plan(n, jtask.batch_size)[2]
        return init, np.asarray(_epoch_orders_jit(key_data, jtask.epochs,
                                                  n_pad, jnp.int32(n)))
    return source


def _run(camp):
    camp.bootstrap()
    T_idx, B0 = camp.pool.T_idx.copy(), camp.pool.B_idx.copy()
    first = {t: camp.eps_hist[t][0][1] for t in camp.cfg.thetas}
    while not camp.done:
        camp.iteration()
    return T_idx, B0, first, camp.commit()


@pytest.mark.parametrize("metric,budget", [("margin", None),
                                           ("kcenter", None),
                                           ("margin", 20.0)])
def test_campaign_matches_jax(metric, budget):
    """The budget case runs the budget-constrained search and commit."""
    x, y = make_classification(POOL, num_classes=10, dim=16, difficulty=0.3,
                               seed=SEED)
    jx, jy = jmake_classification(POOL, num_classes=10, dim=16,
                                  difficulty=0.3, seed=SEED)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    jtask = JLiveTask(features=x, groundtruth=y, sweep_page=256, **TASK)
    cfg = dict(CFG, metric=metric, budget=budget)
    want = _run(JCampaign(jtask, JAMAZON, JConfig(**cfg)))
    jtask.close()
    task = LiveTask(features=x, groundtruth=y, device="cpu",
                    fit_source=_jax_fit_source(jtask), **TASK)
    got = _run(MCALCampaign(task, AMAZON, MCALConfig(**cfg)))

    np.testing.assert_array_equal(got[0], want[0])     # T_idx
    np.testing.assert_array_equal(got[1], want[1])     # B0
    for t in sorted(got[2]):                           # first eps_theta
        assert abs(got[2][t] - want[2][t]) <= 1.0 / len(got[0]) + 1e-12, t
    res, jres = got[3], want[3]
    assert res.decision == jres.decision
    assert abs(res.B_size - jres.B_size) <= 0.05 * jres.B_size
    assert res.total_cost == pytest.approx(jres.total_cost, rel=0.02)
    for r in (res, jres):
        if budget is None:
            assert r.measured_error <= CFG["eps_target"] + 0.005
        else:
            assert r.total_cost <= budget
        assert (r.labels >= 0).all()


@pytest.mark.parametrize("metric", ["margin", "kcenter", "entropy",
                                    "random"])
def test_port_campaign_on_its_own_draws(metric):
    """Without the seam the port draws its own init and orders: the
    campaign still commits, every row is labeled, and the task's passes
    agree with one another on the final classifier."""
    x, y = make_classification(600, num_classes=6, dim=8, difficulty=0.2,
                               seed=1)
    cfg = MCALConfig(metric=metric, seed=1, max_iters=3, delta0_frac=0.02)
    task = LiveTask(features=x, groundtruth=y, num_classes=6, epochs=4,
                    seed=1, score_microbatch=128, device="cpu")
    camp = MCALCampaign(task, AMAZON, cfg)
    res = camp.run()
    assert camp.done_reason in ("converged", "max_iters")
    assert (res.labels >= 0).all() and res.labels.shape == (600,)
    assert res.B_size + res.S_size <= 600
    assert task.train_cost(40) == pytest.approx(40 * task.c_u_nominal)
    idx = np.arange(0, 600, 7)
    stats, feats = task.score(idx)
    np.testing.assert_array_equal(task.predict(idx), stats.top1)
    order, top1 = task.machine_label_sweep(idx)
    np.testing.assert_array_equal(top1, stats.top1)
    np.testing.assert_array_equal(order, np.argsort(-stats.margin.astype(
        np.float64), kind="stable"))
    np.testing.assert_allclose(task.anchor_features(idx), feats, atol=1e-6)
    picked, pf = task.kcenter_candidates(5, idx, anchors=feats[:3])
    assert len(set(picked)) == 5 and set(picked) <= set(idx)
    np.testing.assert_allclose(pf, feats[np.searchsorted(idx, picked)],
                               atol=1e-6)
