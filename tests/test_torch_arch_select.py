"""Architecture selection (paper §4), run by the JAX package and by the
port on the same inputs: ``select_architecture`` over one shared pool,
with the campaign surface it drives — ``SharedPool(ledger=)``,
``MCALCampaign(shared=)``, ``bootstrap(adopt=)``, forced acquisitions,
``propose_acquisition`` and ``freeze_delta``.

* Replay candidates (``make_emulated_task``'s cnn18/resnet18/resnet50
  calibrations): every draw is numpy in both packages, so a margin or
  random selection is equal exactly — the winner, the result, every
  candidate's history, the shared ledger and the labels.  k-center ranks
  float features whose fp32 distances split near ties between the
  packages (ROADMAP §C.1): held on its decisions.
* Live MLP candidates (the reference's own test specs): each port
  candidate's retrains start from the reference candidate's init params
  and epoch orders (``LiveTask.fit_source``); the two packages' trained
  classifiers differ in their last bits, so margin rankings can split
  near ties (ROADMAP §C.2) and decisions are held with the campaign
  test's tolerances: the same T and B0, the first measurement within one
  test item, the same winner and decision, |B| within 5%, cost within 2%.
* The port's own async selection (``fit_async``, ``sweep_async``) equals
  its synchronous one exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import AMAZON as JAMAZON
from repro.core import MCALCampaign as JCampaign
from repro.core import MCALConfig as JConfig
from repro.core import LiveTask as JLiveTask
from repro.core import make_emulated_task as jmake
from repro.core import mcal as jmcal
from repro.core import select_architecture as jselect
from repro.training.fit_device import _epoch_orders_jit
from repro.training.train_loop import init_train_state
from repro_torch.core import (AMAZON, LiveTask, MCALCampaign, MCALConfig,
                              SharedPool, make_emulated_task,
                              select_architecture)
from repro_torch.core import mcal as tmcal
from repro_torch.core.cost import CostLedger
from repro_torch.data.synth import make_classification
from repro_torch.models.convert import params_from_jax
from repro_torch.training.fit_device import fit_plan

ARCHS = ("cnn18", "resnet18", "resnet50")


def _emulated(dataset, make=None, **kw):
    if make is None:
        return {a: make_emulated_task(dataset, a, seed=0, device="cpu", **kw)
                for a in ARCHS}
    return {a: make(dataset, a, seed=0, **kw) for a in ARCHS}


def _histories(hist):
    return {n: [r.to_dict() for r in h] for n, h in hist.items()}


def _same_result(res, jres):
    assert res.to_dict() == jres.to_dict()     # decision, sizes, ledger,
    np.testing.assert_array_equal(res.labels, jres.labels)      # history
    np.testing.assert_array_equal(res.machine_mask, jres.machine_mask)
    assert res.total_cost == jres.total_cost


@pytest.mark.parametrize("dataset,metric", [("fashion", "margin"),
                                            ("cifar10", "margin"),
                                            ("cifar100", "margin"),
                                            ("cifar10", "random")])
def test_replay_selection_equals_jax(dataset, metric):
    """benchmarks/bench_table1.py's "DNN Selected" rows at the paper's
    50,000 rows: the same winner, result, histories, ledger and labels."""
    cfg = dict(seed=0, metric=metric)
    got = select_architecture(_emulated(dataset), AMAZON, MCALConfig(**cfg))
    want = jselect(_emulated(dataset, jmake), JAMAZON, JConfig(**cfg))
    assert got[0] == want[0]
    _same_result(got[1], want[1])
    assert _histories(got[2]) == _histories(want[2])
    if (dataset, metric) == ("cifar10", "margin"):
        # tests/test_mcal.py's selection: resnet18, within the target
        assert got[0] == "resnet18" and got[1].measured_error <= 0.055


def test_replay_kcenter_selection_decides_like_jax():
    """k-center at 5,000 rows: the fp32 distances split near ties
    (ROADMAP §C.1), so picks may part; the emulator's error depends only
    on |B|, so the winner and decisions agree."""
    cfg = dict(seed=0, metric="kcenter")
    w, res, hist = select_architecture(_emulated("cifar10", pool_size=5000),
                                       AMAZON, MCALConfig(**cfg))
    jw, jres, jhist = jselect(_emulated("cifar10", jmake, pool_size=5000),
                              JAMAZON, JConfig(**cfg))
    assert w == jw
    assert (res.decision, res.B_size, res.S_size, res.total_cost) == \
        (jres.decision, jres.B_size, jres.S_size, jres.total_cost)
    assert {n: len(h) for n, h in hist.items()} == \
        {n: len(h) for n, h in jhist.items()}


# -- live MLP candidates ----------------------------------------------------

# the reference's live selection test (tests/test_fit_device.py)
LIVE = dict(num_classes=10, epochs=3, seed=4, sweep_page=256,
            score_microbatch=256)
WIDTHS = {"small": 32, "big": 64}
LIVE_CFG = dict(seed=4, max_iters=4, delta0_frac=0.02)


@pytest.fixture(scope="module")
def small_pool():
    return make_classification(700, num_classes=10, dim=16, difficulty=0.3,
                               seed=4)


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


def _recording_bootstrap(monkeypatch, module, out):
    """Record the shared pool's T and B0 after the leader's bootstrap."""
    fn = module.MCALCampaign._bootstrap_impl

    def wrapped(self, *, adopt=False):
        fn(self, adopt=adopt)
        if not adopt:
            out.append((self.pool.T_idx.copy(), self.pool.B_idx.copy()))
    monkeypatch.setattr(module.MCALCampaign, "_bootstrap_impl", wrapped)


def _port_live(x, y, fit_sources=None, **kw):
    return {n: LiveTask(features=x, groundtruth=y, hidden=h, device="cpu",
                        fit_source=None if fit_sources is None
                        else fit_sources[n], **LIVE, **kw)
            for n, h in WIDTHS.items()}


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
def test_live_selection_decides_like_jax(metric, small_pool, monkeypatch):
    x, y = small_pool
    boots = {"jax": [], "port": []}
    _recording_bootstrap(monkeypatch, jmcal, boots["jax"])
    _recording_bootstrap(monkeypatch, tmcal, boots["port"])
    cfg = dict(LIVE_CFG, metric=metric)
    jtasks = {n: JLiveTask(features=x, groundtruth=y, hidden=h, **LIVE)
              for n, h in WIDTHS.items()}
    jw, jres, jhist = jselect(jtasks, JAMAZON, JConfig(**cfg),
                              max_explore_iters=3)
    for t in jtasks.values():
        t.close()
    tasks = _port_live(x, y, {n: _jax_fit_source(t)
                              for n, t in jtasks.items()})
    w, res, hist = select_architecture(tasks, AMAZON, MCALConfig(**cfg),
                                       max_explore_iters=3)
    for t in tasks.values():
        t.close()

    (T, B0), (jT, jB0) = boots["port"][0], boots["jax"][0]
    np.testing.assert_array_equal(T, jT)
    np.testing.assert_array_equal(B0, jB0)
    for n in WIDTHS:                      # each candidate's bootstrap fit
        first, jfirst = hist[n][0].eps_theta, jhist[n][0].eps_theta
        for t in first:
            assert abs(first[t] - jfirst[t]) <= 1.0 / len(T) + 1e-12, (n, t)
    assert w == jw
    assert res.decision == jres.decision
    assert abs(res.B_size - jres.B_size) <= 0.05 * jres.B_size
    assert res.total_cost == pytest.approx(jres.total_cost, rel=0.02)
    assert (res.labels >= 0).all() and (jres.labels >= 0).all()


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
def test_live_async_selection_equals_sync(metric, small_pool):
    """``fit_async`` retrains every candidate at once on its own fit
    worker and ``sweep_async`` overlaps the M(.) sweeps: the port's
    selection equals its synchronous one exactly (the reference's
    contract, tests/test_fit_device.py)."""
    x, y = small_pool

    def run(fast):
        tasks = _port_live(x, y)
        try:
            return select_architecture(
                tasks, AMAZON, MCALConfig(**LIVE_CFG, metric=metric,
                                          fit_async=fast, sweep_async=fast),
                max_explore_iters=3)
        finally:
            for t in tasks.values():
                t.close()
    (w_s, res_s, hist_s), (w_a, res_a, hist_a) = run(False), run(True)
    assert w_s == w_a
    assert _histories(hist_s) == _histories(hist_a)
    assert res_s.total_cost == res_a.total_cost
    np.testing.assert_array_equal(res_s.labels, res_a.labels)


# -- the campaign surface ----------------------------------------------------

class _Trace:
    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))

    def flush(self):
        pass

    def kinds(self, kind):
        return [p for k, p in self.events if k == kind]


def _replay_campaign(**cfg):
    task = make_emulated_task("cifar10", "resnet18", seed=0, pool_size=6000,
                              device="cpu")
    return MCALCampaign(task, AMAZON, MCALConfig(seed=0, **cfg))


@pytest.mark.parametrize("metric", ["margin", "kcenter", "random"])
def test_propose_acquisition_buys_nothing_and_is_the_next_pick(metric):
    camp = _replay_campaign(metric=metric)
    camp.bootstrap()
    camp.iteration()
    ledger, labels = camp.pool.ledger.snapshot(), camp.pool.labels.copy()
    B, rng = camp.pool.B_idx.copy(), camp.rng.bit_generator.state
    proposal = camp.propose_acquisition(camp.delta)
    assert camp.pool.ledger.snapshot() == ledger
    np.testing.assert_array_equal(camp.pool.labels, labels)
    np.testing.assert_array_equal(camp.pool.B_idx, B)
    # the next unforced pick (random draws it from the same rng state)
    camp.rng.bit_generator.state = rng
    camp.iteration()
    np.testing.assert_array_equal(camp.pool.B_idx[len(B):], proposal)


def test_forced_acquisition_is_bought_as_given_without_a_sweep(small_pool):
    x, y = small_pool
    task = LiveTask(features=x, groundtruth=y, hidden=32, device="cpu",
                    **LIVE)
    submitted = []
    submit = task.submit_candidates
    task.submit_candidates = lambda *a, **k: submitted.append(a) or \
        submit(*a, **k)
    camp = MCALCampaign(task, AMAZON, MCALConfig(**LIVE_CFG,
                                                 sweep_async=True))
    trace = _Trace()
    camp.attach_trace(trace)
    camp.bootstrap()
    cand = camp.pool.unlabeled_candidates()
    pick = cand[::-1][:9]                     # not M(.)'s order
    B = camp.pool.B_idx.copy()
    human = camp.pool.ledger.human
    camp.iteration(forced_acquisition=pick)
    assert submitted == []
    np.testing.assert_array_equal(camp.pool.B_idx, np.concatenate([B, pick]))
    assert (camp.pool.labels[pick] == y[pick]).all()
    assert camp.pool.ledger.human == pytest.approx(
        human + len(pick) * AMAZON.price_per_label)
    (acq,) = trace.kinds("acquisition")
    assert acq["forced"] is True and acq["n"] == len(pick)
    camp.iteration(acquire=False)             # no purchase, no sweep
    assert submitted == [] and len(camp.pool.B_idx) == len(B) + len(pick)
    camp.iteration()                          # an unforced round sweeps
    assert len(submitted) == 1
    assert trace.kinds("acquisition")[-1]["forced"] is False
    camp.close()


def test_adopting_bootstrap_draws_nothing():
    lead = _replay_campaign()
    lead.bootstrap()
    shared = lead.pool
    total = shared.ledger.total
    task = make_emulated_task("cifar10", "cnn18", seed=0, pool_size=6000,
                              device="cpu")
    camp = MCALCampaign(task, AMAZON, MCALConfig(seed=0), shared=shared)
    trace = _Trace()
    camp.attach_trace(trace)
    rng = camp.rng.bit_generator.state
    camp.bootstrap(adopt=True)
    assert camp.rng.bit_generator.state == rng
    assert camp.pool is shared and camp.delta == len(shared.B_idx)
    (boot,) = trace.kinds("bootstrap")
    assert boot == {"T_size": len(shared.T_idx),
                    "B_size": len(shared.B_idx), "adopt": True}
    # only its training was charged, into the shared ledger
    assert [k for k, _ in trace.events].count("charge") == 1
    assert shared.ledger.total == pytest.approx(
        total + camp.own_training)
    ledger = CostLedger()
    assert SharedPool(10, ledger=ledger).ledger is ledger


def test_search_keeps_its_surface_when_asked():
    """``search(keep_surface=)`` overrides the config for one search, as
    the reference's does; the surface equals the reference's."""
    camps = [_replay_campaign()]
    camps.append(JCampaign(jmake("cifar10", "resnet18", seed=0,
                                 pool_size=6000), JAMAZON, JConfig(seed=0)))
    got = []
    for camp in camps:
        camp.bootstrap()
        camp.iteration()
        assert camp.search().grid_B is None
        got.append(camp.search(keep_surface=True))
    res, jres = got
    assert res.grid_B is not None
    np.testing.assert_array_equal(res.grid_B, jres.grid_B)
    np.testing.assert_array_equal(res.grid_theta, jres.grid_theta)
    assert res.cost == jres.cost


def _frozen_runs(make, Camp, Cfg, svc, **kw):
    out = {}
    for frozen in (False, True):
        camp = Camp(make("cifar10", "resnet18", seed=0, **kw), svc,
                    Cfg(seed=0, max_iters=20))
        camp.freeze_delta = frozen
        trace = _Trace()
        camp.attach_trace(trace)
        camp.bootstrap()
        while not camp.done:
            camp.iteration()
        out[frozen] = ([r.to_dict() for r in camp.history],
                       trace.kinds("done")[0]["reason"])
    return out


def test_frozen_campaign_never_adapts_delta_nor_converges():
    """With delta frozen the campaign runs to max_iters at delta0 where
    the unfrozen one adapts delta and converges; the port's records equal
    the reference's."""
    out = _frozen_runs(make_emulated_task, MCALCampaign, MCALConfig, AMAZON,
                       device="cpu")
    unfrozen, frozen = out[False], out[True]
    assert unfrozen[1] == "converged"
    assert len({r["delta"] for r in unfrozen[0]}) > 1
    assert frozen[1] == "max_iters" and len(frozen[0]) == 20
    assert {r["delta"] for r in frozen[0]} == {frozen[0][0]["delta"]}
    assert any(r["stable"] for r in frozen[0])
    assert out == _frozen_runs(jmake, JCampaign, JConfig, JAMAZON)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exploring_state_resumes_in_the_other_package(direction):
    """An exploration-frozen campaign's state file (``freeze_delta``
    true) written by one package resumes in the other: still frozen, and
    it ends as the uninterrupted campaign does."""
    ports = {"port": (lambda: make_emulated_task(
                          "cifar10", "resnet18", seed=0, device="cpu"),
                      MCALCampaign, MCALConfig, AMAZON),
             "jax": (lambda: jmake("cifar10", "resnet18", seed=0),
                     JCampaign, JConfig, JAMAZON)}
    src, dst = direction.split("_to_")

    def fresh(side):
        make, Camp, Cfg, svc = ports[side]
        camp = Camp(make(), svc, Cfg(seed=0, max_iters=12))
        camp.freeze_delta = side == src
        return camp

    ref = fresh(src)
    ref.bootstrap()
    for _ in range(4):
        ref.iteration()
    blob = json.dumps(ref.state_dict())
    assert json.loads(blob)["freeze_delta"] is True
    resumed = fresh(dst)
    assert not resumed.freeze_delta
    resumed.load_state_dict(json.loads(blob))
    assert resumed.freeze_delta is True
    while not ref.done:
        ref.iteration()
    while not resumed.done:
        resumed.iteration()
    assert [r.to_dict() for r in resumed.history] == \
        [r.to_dict() for r in ref.history]
    a, b = ref.commit(), resumed.commit()
    assert a.to_dict() == b.to_dict()
    np.testing.assert_array_equal(a.labels, b.labels)
