"""The port's campaign trace: the store cases of ``tests/test_trace.py`` on
the port's own copy, traces read across the two packages, replay equal to
the live result, and sibling campaigns — synchronous, ``sweep_async``,
``fit_async`` (with the resident set), preempted and resumed — whose
decision streams diff clean under the port's ``diff`` and under
``repro.trace.replay.diff``."""
import json
import os

import numpy as np
import pytest

from repro.core import AMAZON as JAMAZON
from repro.core import MCALConfig as JConfig
from repro.core import make_emulated_task
from repro.trace import TraceStore as JTraceStore
from repro.trace import diff as jdiff
from repro.trace import read_trace as jread_trace
from repro.trace import replay as jreplay
from repro_torch.core import AMAZON, LiveTask, MCALCampaign, MCALConfig
from repro_torch.core.mcal import STATE_VERSION, IterationRecord, MCALResult
from repro_torch.data.synth import make_classification
from repro_torch.launch.label import run_campaign
from repro_torch.trace import (ALL_KINDS, TraceError, TraceEvent, TraceStore,
                               diff, read_trace, replay, sanitize)

# ---------------------------------------------------------------------------
# store level
# ---------------------------------------------------------------------------


def test_event_json_round_trip_with_numpy_payload():
    e = TraceEvent(seq=3, campaign="c", kind="charge", ts=1.5,
                   payload={"n": np.int64(7), "cost": np.float32(0.25),
                            "ok": np.bool_(True), "idx": np.arange(3)})
    e2 = TraceEvent.from_dict(json.loads(e.to_json()))
    assert (e2.seq, e2.campaign, e2.kind, e2.ts) == (3, "c", "charge", 1.5)
    assert e2.payload == {"n": 7, "cost": 0.25, "ok": True, "idx": [0, 1, 2]}


def test_event_rejects_non_finite_payload():
    e = TraceEvent(seq=0, campaign="c", kind="x", ts=0.0,
                   payload={"bad": float("nan")})
    with pytest.raises(ValueError):
        e.to_json()


def test_sanitize_makes_payloads_strict_json():
    out = sanitize({"nan": float("nan"), "inf": np.inf,
                    "f": np.float64(2.0), "i": np.int32(3),
                    "b": np.bool_(False),
                    "nest": [{"k": -np.inf}, (1.0, 2.0)],
                    "arr": np.array([1.5, np.nan])})
    assert out == {"nan": None, "inf": None, "f": 2.0, "i": 3, "b": False,
                   "nest": [{"k": None}, [1.0, 2.0]], "arr": [1.5, None]}
    json.dumps(out, allow_nan=False)


def test_store_buffers_then_flushes_monotone_seq(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with TraceStore(p, "camp", flush_every=100) as tr:
        tr.emit("campaign_begin", config={"seed": 0})
        tr.emit("charge", total=1.0)
        assert tr.next_seq == 2
        assert read_trace(p) == []          # buffered: not on disk yet
        tr.flush()
        assert [e.seq for e in read_trace(p)] == [0, 1]
        tr.emit("done", reason="x")
    ev = read_trace(p)                      # close() flushed the tail
    assert [e.seq for e in ev] == [0, 1, 2]
    assert all(e.campaign == "camp" for e in ev)
    assert read_trace(p, campaign="other") == []


def test_read_tolerates_truncated_final_line_only(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with TraceStore(p, "camp") as tr:
        for i in range(4):
            tr.emit("charge", total=float(i))
    with open(p, "a") as f:
        f.write('{"seq": 4, "campaign": "camp", "ki')   # mid-write tail
    assert [e.seq for e in read_trace(p)] == [0, 1, 2, 3]
    lines = open(p).read().splitlines()
    lines[1] = lines[1][:20]                            # mid-file garbage
    open(p, "w").write("\n".join(lines) + "\n")
    with pytest.raises(TraceError):
        read_trace(p)


def test_resume_truncates_tail_and_continues_without_gaps(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with TraceStore(p, "camp") as tr:
        for i in range(6):
            tr.emit("charge", total=float(i))
    with TraceStore.resume(p, 4) as tr:
        assert tr.campaign == "camp" and tr.next_seq == 4
        tr.emit("charge", total=99.0)
        tr.emit("done", reason="resumed")
    ev = read_trace(p)
    assert [e.seq for e in ev] == [0, 1, 2, 3, 4, 5]
    assert ev[4].payload["total"] == 99.0 and ev[5].kind == "done"
    with pytest.raises(TraceError):
        TraceStore.resume(p, 100)


class _TornOnce:
    """A file that writes half of the first payload and raises OSError."""

    def __init__(self, f):
        self._f, self.torn = f, False

    def write(self, data):
        if not self.torn:
            self.torn = True
            self._f.write(data[:len(data) // 2])
            self._f.flush()
            raise OSError("disk full")
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def test_torn_write_recovers_without_duplicate_or_gapped_seqs(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = TraceStore(p, "camp", flush_every=1000)
    tr._f = _TornOnce(tr._f)
    for i in range(4):
        tr.emit("charge", total=float(i))
    tr.flush()                       # torn: half the payload, then OSError
    assert tr.write_errors == 1
    assert len(read_trace(p)) < 4    # short, ending mid-line
    tr.emit("charge", total=4.0)
    tr.flush()                       # recovery: truncate + full rewrite
    tr.close()
    ev = read_trace(p)
    assert [e.seq for e in ev] == [0, 1, 2, 3, 4]
    assert [e.payload["total"] for e in ev] == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_store_down_hard_warns_but_never_raises_into_emitters(tmp_path):
    class Down(_TornOnce):
        def write(self, data):
            raise OSError("volume gone")

    p = str(tmp_path / "t.jsonl")
    tr = TraceStore(p, "camp", flush_every=1)
    tr._f = Down(tr._f)
    for i in range(3):
        tr.emit("charge", total=float(i))       # 3 failed flushes, no raise
    assert tr.write_errors == 3
    with pytest.warns(RuntimeWarning, match="unflushed"):
        tr.close()


def test_each_package_reads_the_others_trace(tmp_path):
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    for Store, path in ((TraceStore, a), (JTraceStore, b)):
        with Store(path, "camp") as tr:
            tr.emit("campaign_begin", config={"seed": 0}, runtime={})
            tr.emit("charge", ledger="campaign", total=1.5)
    for reader in (read_trace, jread_trace):
        for path in (a, b):
            ev = reader(path)
            assert [(e.seq, e.kind, e.payload) for e in ev] == [
                (0, "campaign_begin", {"config": {"seed": 0}, "runtime": {}}),
                (1, "charge", {"ledger": "campaign", "total": 1.5})]
    # a cursor cut by one package resumes in the other
    with JTraceStore.resume(a, 1) as tr:
        tr.emit("done", reason="x")
    with TraceStore.resume(b, 1) as tr:
        tr.emit("done", reason="x")
    assert [e.kind for e in read_trace(a)] == [e.kind for e in jread_trace(b)]


# ---------------------------------------------------------------------------
# campaign level
# ---------------------------------------------------------------------------

X, Y = make_classification(800, num_classes=10, dim=16, difficulty=0.3,
                           seed=4)
CFG = dict(seed=4, max_iters=3, delta0_frac=0.02)


def _task(**kw):
    return LiveTask(features=X, groundtruth=Y, num_classes=10, epochs=3,
                    seed=4, sweep_page=256, score_microbatch=256,
                    device="cpu", **kw)


def _traced(path, metric="margin", task_kw=None, **cfg):
    camp = MCALCampaign(_task(**(task_kw or {})), AMAZON,
                        MCALConfig(metric=metric, **CFG, **cfg))
    with TraceStore(str(path), "live-s4") as tr:
        camp.attach_trace(tr)
        res = camp.run()
    camp.close()
    return res, camp


@pytest.fixture(scope="module")
def siblings(tmp_path_factory):
    """Per metric: the synchronous campaign and its async (sweep_async +
    fit_async + fit_resident) and preempted-and-resumed siblings."""
    d = tmp_path_factory.mktemp("port-traces")
    out = {}
    for metric in ("margin", "kcenter"):
        sync = d / f"sync-{metric}.jsonl"
        res, camp = _traced(sync, metric)
        asy = d / f"async-{metric}.jsonl"
        ares, _ = _traced(asy, metric, task_kw={"fit_resident": True},
                          sweep_async=True, fit_async=True)
        prem, state = d / f"prem-{metric}.jsonl", str(d / f"{metric}.json")
        pres, hops = None, 0
        while pres is None:
            pres, _ = run_campaign(
                _task(), AMAZON, MCALConfig(metric=metric, **CFG),
                state_path=state, iters_per_run=1, trace_path=str(prem),
                campaign_id="live-s4")
            hops += 1
            assert hops < 10
        assert hops > 1 and not os.path.exists(state)
        out[metric] = {"sync": (str(sync), res, camp),
                       "async": (str(asy), ares), "prem": (str(prem), pres),
                       "hops": hops}
    return out


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
@pytest.mark.parametrize("sibling", ["async", "prem"])
@pytest.mark.parametrize("differ", ["port", "jax"])
def test_siblings_diff_clean(siblings, metric, sibling, differ):
    s = siblings[metric]
    d = (diff if differ == "port" else jdiff)(s["sync"][0], s[sibling][0])
    assert d is None, d.describe()
    assert s[sibling][1].total_cost == s["sync"][1].total_cost
    np.testing.assert_array_equal(s[sibling][1].labels, s["sync"][1].labels)


@pytest.mark.parametrize("metric", ["margin", "kcenter"])
@pytest.mark.parametrize("replayer", ["port", "jax"])
def test_replay_equals_live_result(siblings, metric, replayer):
    path, res, _ = siblings[metric]["sync"]
    rp = (replay if replayer == "port" else jreplay)(path)
    assert rp.result is not None and rp.decision == res.decision
    assert rp.total_cost == res.total_cost
    assert rp.pool_size == len(res.labels)
    assert [r.to_dict() for r in rp.history] == \
        [r.to_dict() for r in res.history]
    assert rp.result.to_dict(with_history=False) == \
        res.to_dict(with_history=False)
    kinds = [e.kind for e in rp.events]
    assert set(kinds) <= ALL_KINDS
    assert kinds.count("campaign_begin") == 1 and kinds[-1] == "commit"


def test_async_and_preempted_traces_carry_their_telemetry(siblings):
    s = siblings["margin"]
    assert {"fit_submit", "fit_done"} <= {e.kind for e in
                                          read_trace(s["async"][0])}
    ev = read_trace(s["prem"][0])
    assert [e.seq for e in ev] == list(range(len(ev)))   # no gaps/dups
    kinds = [e.kind for e in ev]
    assert kinds.count("campaign_begin") == 1
    assert kinds.count("resume") == s["hops"] - 1
    assert kinds.count("state_save") >= s["hops"] - 1


def test_diff_localizes_a_divergence(siblings, tmp_path):
    path = siblings["margin"]["sync"][0]
    other = tmp_path / "seed5.jsonl"
    camp = MCALCampaign(_task(), AMAZON, MCALConfig(
        metric="margin", **dict(CFG, seed=5)))
    with TraceStore(str(other), "live-s5") as tr:
        camp.attach_trace(tr)
        camp.run()
    for differ in (diff, jdiff):
        d = differ(path, str(other))
        assert d is not None and d.index == 0
        assert d.kind_a == d.kind_b == "campaign_begin"
        assert "config" in d.fields
    cut = str(tmp_path / "cut.jsonl")
    lines = [l for l in open(path).read().splitlines() if l.strip()]
    open(cut, "w").write("\n".join(lines[:-1]) + "\n")   # drop the commit
    d = diff(path, cut)
    assert d is not None and d.kind_b == "<end>" and "ends" in d.describe()
    gap = str(tmp_path / "gap.jsonl")
    open(gap, "w").write("\n".join(lines[:3] + lines[4:]) + "\n")
    with pytest.raises(TraceError):
        replay(gap)


def test_state_dict_version_gate_and_shared_serialization(siblings):
    _, res, camp = siblings["margin"]["sync"]
    sd = json.loads(json.dumps(camp.state_dict()))
    assert sd["version"] == STATE_VERSION
    assert sd["trace"] is not None       # the cursor, while traced
    fresh = MCALCampaign(_task(), AMAZON, MCALConfig(**CFG))
    with pytest.raises(ValueError, match="version"):
        fresh.load_state_dict(dict(sd, version=STATE_VERSION + 1))
    for rec in res.history:
        assert IterationRecord.from_dict(rec.to_dict()).to_dict() == \
            rec.to_dict()
    d = res.to_dict()
    r2 = MCALResult.from_dict(d)
    assert r2.to_dict() == d and r2.total_cost == res.total_cost
    assert len(r2.labels) == len(res.labels)


def test_port_reads_and_replays_a_jax_trace(tmp_path):
    """A JAX package campaign's trace read and replayed by the port."""
    from repro.core import MCALCampaign as JCampaign
    p = str(tmp_path / "jax.jsonl")
    task = make_emulated_task("cifar10", "resnet18", seed=0,
                              pool_size=2000, sweep_page=512)
    camp = JCampaign(task, JAMAZON, JConfig(seed=0, max_iters=4))
    with JTraceStore(p, "cifar10-s0") as tr:
        camp.attach_trace(tr)
        res = camp.run()
    rp = replay(p)
    assert rp.decision == res.decision and rp.total_cost == res.total_cost
    assert [r.to_dict() for r in rp.history] == \
        [r.to_dict() for r in res.history]
    assert diff(p, p) is None
