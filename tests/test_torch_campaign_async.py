"""State files and sweep cursors written by the JAX package's launcher
resume in the port.

The JAX package's ``run_campaign`` preempts a live campaign after two
iterations; the port resumes its state file and reaches the decision the
uninterrupted port campaign reaches, within ``tests/test_torch_campaign.py``'s
tolerances (same decision, |B| within 5%, cost within 2%, the accuracy
target met).  The port's retrains start from the JAX package's init and
epoch orders (its ``fit_source`` seam), as in that test.  A JAX campaign
cut in the middle of its commit sweep leaves a state file with a sweep
cursor, and the port finishes that sweep from the cursor."""
import json

import pytest

from repro.core.cost import AMAZON as JAMAZON
from repro.core.mcal import MCALCampaign as JCampaign
from repro.core.mcal import MCALConfig as JConfig
from repro.core.task import LiveTask as JLiveTask
from repro.launch.label import _save_state as jsave_state
from repro.launch.label import run_campaign as jrun_campaign
from repro_torch.core import AMAZON, LiveTask, MCALCampaign, MCALConfig
from repro_torch.data.synth import make_classification
from repro_torch.launch.label import run_campaign
from repro_torch.trace import read_trace

from test_torch_campaign import _jax_fit_source

SEED = 4
TASK = dict(num_classes=10, epochs=10, seed=SEED, score_microbatch=256,
            sweep_page=256)
POOL = 1600
CFG = dict(seed=SEED, max_iters=3, delta0_frac=0.02, eps_target=0.05)
X, Y = make_classification(POOL, num_classes=10, dim=16, difficulty=0.3,
                           seed=SEED)


def _tasks():
    jtask = JLiveTask(features=X, groundtruth=Y, **TASK)
    task = LiveTask(features=X, groundtruth=Y, device="cpu",
                    fit_source=_jax_fit_source(jtask), **TASK)
    return jtask, task


def _close_to(res, want):
    assert res.decision == want.decision
    assert abs(res.B_size - want.B_size) <= 0.05 * want.B_size
    assert res.total_cost == pytest.approx(want.total_cost, rel=0.02)
    assert res.measured_error <= CFG["eps_target"] + 0.005
    assert (res.labels >= 0).all()


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
def test_jax_state_file_resumes_in_port(tmp_path, metric):
    cfg = dict(CFG, metric=metric)
    state = str(tmp_path / "state.json")
    jtask, _ = _tasks()
    jres, _ = jrun_campaign(jtask, JAMAZON, JConfig(**cfg),
                            state_path=state, iters_per_run=2)
    assert jres is None                       # preempted, resumable
    blob = json.load(open(state))["campaign"]
    assert blob["iter"] == 2 and blob["pack_keys"]["fit"]

    _, task = _tasks()
    res, camp = run_campaign(task, AMAZON, MCALConfig(**cfg),
                             state_path=state)
    assert res is not None
    # the resumed campaign kept the JAX package's first two records
    assert [r.to_dict() for r in camp.history[:2]] == blob["history"]
    # and warmed the JAX package's buckets
    assert {tuple(k) for k in blob["pack_keys"]["fit"]} <= \
        set(task._fit.cache_keys())

    _, task = _tasks()
    want = MCALCampaign(task, AMAZON, MCALConfig(**cfg)).run()
    _close_to(res, want)


def test_jax_commit_cursor_resumes_in_port(tmp_path):
    """The JAX campaign dies after the first cursor cut of its commit
    sweep; the port resumes the state file and the cursor in it."""
    state = str(tmp_path / "state.json")
    jtask, _ = _tasks()
    jcamp = JCampaign(jtask, JAMAZON, JConfig(**CFG))
    jcamp.bootstrap()
    while not jcamp.done:
        jcamp.iteration()
    jcamp.sweep_checkpoint_every = 1

    class Preempted(Exception):
        pass

    def cut(ck):
        jsave_state(state, jcamp, cursor=ck)
        raise Preempted

    jcamp.on_sweep_checkpoint = cut
    with pytest.raises(Preempted):
        jcamp.commit()
    jcamp.close()
    blob = json.load(open(state))
    cursor = json.loads(blob["sweep_cursor"])
    assert cursor["next_page"] == 1 and cursor["sink_kind"] == "rank"

    _, task = _tasks()
    trace = str(tmp_path / "resumed.jsonl")
    res, _ = run_campaign(task, AMAZON, MCALConfig(**CFG), state_path=state,
                          trace_path=trace)
    # the port's commit sweep started at the JAX package's cursor
    done = [e.payload for e in read_trace(trace) if e.kind == "sweep_done"]
    assert done[-1]["resumed_from"] == 1 and done[-1]["sink"] == "rank"
    _, task = _tasks()
    want = MCALCampaign(task, AMAZON, MCALConfig(**CFG)).run()
    _close_to(res, want)
    # the B the JAX campaign bought is the one the port committed with
    assert res.B_size == want.B_size == len(blob["campaign"]["B_idx"])
