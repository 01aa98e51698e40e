"""The port's broker threads (``repro_torch.core.worker.SerialWorker``):
every engine worker is a daemon, runs its jobs in order, joins on close
and refuses work afterwards — the cases of ``tests/test_shutdown.py`` for
the JAX package, on the port's worker, sweep runner, fit engine and
campaign."""
import threading

import numpy as np
import pytest

from repro_torch.core.worker import SerialWorker, WorkerClosed


def test_worker_runs_jobs_in_order():
    out = []
    with SerialWorker("t") as w:
        futs = [w.submit(out.append, i) for i in range(8)]
        for f in futs:
            f.result(timeout=5)
    assert out == list(range(8))


def test_worker_thread_is_daemon():
    w = SerialWorker("t")
    w.submit(lambda: None).result(timeout=5)
    assert w._thread is not None and w._thread.daemon
    w.close()


def test_worker_close_joins_thread():
    w = SerialWorker("t")
    w.submit(lambda: None).result(timeout=5)
    th = w._thread
    assert th.is_alive()
    w.close()
    assert not th.is_alive() and not w.alive


def test_worker_close_idempotent_and_lazy():
    w = SerialWorker("t")
    w.close()           # never started: still fine
    w.close()
    assert w._thread is None
    w2 = SerialWorker("t2")
    w2.submit(lambda: 1).result(timeout=5)
    w2.close()
    w2.close()
    assert not w2.alive


def test_worker_submit_after_close_raises():
    w = SerialWorker("t")
    w.submit(lambda: 1).result(timeout=5)
    w.close()
    with pytest.raises(WorkerClosed):
        w.submit(lambda: 2)


def test_worker_propagates_exceptions():
    with SerialWorker("t") as w:
        f = w.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            f.result(timeout=5)
        # the worker survives a failing job
        assert w.submit(lambda: 7).result(timeout=5) == 7


def test_worker_close_reports_joined_thread():
    w = SerialWorker("t")
    assert w.close(timeout=1) is True       # never started: nothing leaks
    w2 = SerialWorker("t2")
    w2.submit(lambda: None).result(timeout=5)
    assert w2.close(timeout=5) is True
    assert w2.close(timeout=5) is True      # idempotent, still joined


def test_worker_close_times_out_on_stuck_job_and_warns():
    gate = threading.Event()
    w = SerialWorker("t")
    w.submit(gate.wait)
    with pytest.warns(RuntimeWarning, match="failed to join"):
        assert w.close(timeout=0.05) is False    # leaked (daemon) thread
    gate.set()                              # unstick; the daemon drains
    w._thread.join(timeout=5)
    assert not w.alive


def test_worker_close_drains_queued_jobs():
    done = []
    w = SerialWorker("t")
    futs = [w.submit(done.append, i) for i in range(32)]
    w.close()           # close waits for everything already queued
    for f in futs:
        f.result(timeout=5)
    assert done == list(range(32))


def test_worker_cancels_queued_job():
    gate = threading.Event()
    with SerialWorker("t") as w:
        first = w.submit(gate.wait)
        queued = w.submit(lambda: 1)
        assert queued.cancel()
        gate.set()
        first.result(timeout=5)
    assert queued.cancelled()


# ---------------------------------------------------------------------------
# the brokered engines and the campaign
# ---------------------------------------------------------------------------


def _live_task(n=96):
    from repro_torch.core.task import LiveTask
    from repro_torch.data.synth import make_classification
    x, y = make_classification(n, num_classes=3, difficulty=0.3, seed=0)
    return LiveTask(features=x, groundtruth=y, num_classes=3, epochs=2,
                    score_microbatch=32, sweep_page=32, seed=0, device="cpu")


def test_sweep_runner_close_joins_and_refuses():
    task = _live_task()
    task.train(np.arange(32), task.groundtruth[:32])
    fut = task.submit_candidates("margin", 4, np.arange(32, 96))
    assert len(fut.result()) == 4
    runner = task._sweep
    assert runner._exec is not None and runner._exec.alive
    runner.close()
    assert not runner._exec.alive
    with pytest.raises(WorkerClosed):
        task.submit_candidates("margin", 4, np.arange(32, 96))
    # synchronous sweeps remain valid after close
    assert len(task.topk_candidates("margin", 4, np.arange(32, 96))) == 4
    task.close()


def test_fit_engine_close_joins_and_refuses():
    task = _live_task()
    c = task.submit_train(np.arange(32), task.groundtruth[:32]).result()
    assert c > 0
    eng = task._fit
    assert eng._exec is not None and eng._exec.alive
    eng.close()
    assert not eng._exec.alive
    with pytest.raises(WorkerClosed):
        task.submit_train(np.arange(32), task.groundtruth[:32])
    # synchronous training remains valid after close
    assert task.train(np.arange(32), task.groundtruth[:32]) > 0
    task.close()


def test_campaign_close_tears_down_all_brokers():
    """A campaign that ran both async paths leaves no broker thread after
    ``close()``, and close is idempotent."""
    from repro_torch.core import AMAZON, MCALCampaign, MCALConfig
    task = _live_task()
    cfg = MCALConfig(max_iters=2, delta0_frac=0.1, test_frac=0.2,
                     sweep_async=True, fit_async=True)
    camp = MCALCampaign(task, AMAZON, cfg)
    camp.run()
    workers = [w for w in (task._sweep._exec, task._fit._exec)
               if w is not None]
    assert workers and all(w.alive for w in workers), \
        "campaign never exercised a broker thread"
    camp.close()
    assert not any(w.alive for w in workers)
    camp.close()        # idempotent


def test_run_campaign_closes_workers():
    from repro_torch.core import AMAZON, MCALConfig
    from repro_torch.launch.label import run_campaign
    task = _live_task()
    cfg = MCALConfig(max_iters=2, delta0_frac=0.1, test_frac=0.2,
                     sweep_async=True, fit_async=True)
    res, camp = run_campaign(task, AMAZON, cfg)
    assert res is not None
    for eng in (task._sweep, task._fit):
        assert eng._exec is None or not eng._exec.alive


def test_shared_model_forward_across_workers():
    """The fit and sweep workers share one model: concurrent forwards from
    several threads give each caller its own params' result."""
    import torch
    task = _live_task()
    task.train(np.arange(32), task.groundtruth[:32])
    x = torch.as_tensor(task.features[:64].astype(np.float32))
    params = [task._params,
              {k: v * 0.5 for k, v in task._params.items()}]
    want = [task.model.forward(p, {"features": x}) for p in params]
    errors = []

    def hammer(i):
        for _ in range(50):
            got = task.model.forward(params[i % 2], {"features": x})
            if not torch.equal(got, want[i % 2]):
                errors.append(i)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
