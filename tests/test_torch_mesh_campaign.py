"""The data-parallel MCAL campaign (``--mesh``) on gloo ranks.

Four ranks, one spawn:

* the launcher's ``--live --pool 400 --classes 4 --mesh data=4
  --iters-per-run 1 --state`` (``tests/test_label_launcher.py``'s run),
  invoked again until its state file is spent, resumes to the end, and
  its trace diffs clean against the port's unmeshed campaign;
* the same campaign with the JAX package's init and epoch orders (the
  ``fit_source`` seam) meets the reference launcher's ``--mesh data=4``
  run on four forced CPU devices under ``tests/test_torch_campaign.py``'s
  contract (the same decision, |B| within 5%, cost within 2%, both within
  the accuracy target);
* ``PoolScoringEngine`` over the mesh equals the unmeshed engine bit for
  bit (statistics, features, top-k, the L(.) order), with microbatches
  that split evenly and unevenly over the ranks; ``FitEngine`` over the
  mesh equals the unmeshed fit, and every rank's fit is the same bits.

Two ranks, one spawn: a ``--sweep-async --fit-async`` campaign diffs clean
against the synchronous one, and a fleet of eight tenants runs concurrent
= serial, tenant by tenant.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--live", "--pool", "400", "--classes", "4"]


def _launch(argv, rank, mesh):
    """One launcher invocation on this rank: rank 0's report, parsed."""
    from repro_torch.launch import label
    args = label.build_parser().parse_args(argv + ["--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        label._campaign(args, rank, mesh)
    return json.loads(out.getvalue()) if rank == 0 else None


def _engines_equal(rank, mesh):
    """Meshed engines against unmeshed ones in this rank, bit for bit."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
    from repro_torch.data.synth import make_classification
    from repro_torch.models.registry import get_model
    from repro_torch.training.fit_device import FitConfig, FitEngine
    x, y = make_classification(300, num_classes=4, difficulty=0.3, seed=3)
    model = get_model(ModelConfig(name="mlp-live", family="mlp",
                                  num_layers=2, d_model=64, num_classes=4,
                                  input_dim=x.shape[1], dtype="float32"))
    tc = TrainConfig(learning_rate=1e-2, schedule="constant",
                     weight_decay=1e-4, grad_clip=1.0)
    fits = [FitEngine(model, tc, FitConfig(epochs=3, batch_size=64),
                      device="cpu", mesh=m) for m in (None, mesh)]
    (p0, l0), (p1, l1) = (f.fit(0, x[:150], y[:150]) for f in fits)
    same = torch.equal(l0, l1) and all(torch.equal(p0[k], p1[k])
                                       for k in p0)
    # the "tp" policy replicates the MLP over a data-only mesh
    same &= all(pl == (Replicate(),) for pl in fits[1].placements.values())
    digest = float(sum(v.double().sum() for v in p1.values()))
    for mb in (64, 96):    # 300 rows: 8 microbatches, then 4 (3 ragged)
        engines = [PoolScoringEngine(model, ScoringConfig(microbatch=mb),
                                     device="cpu", mesh=m)
                   for m in (None, mesh)]
        (s0, f0), (s1, f1) = (e.score(p1, x) for e in engines)
        same &= all(torch.equal(a, b) for a, b in zip(s0, s1))
        same &= torch.equal(f0, f1)
        same &= np.array_equal(engines[0].top_k(p1, x, 37),
                               engines[1].top_k(p1, x, 37))
        same &= np.array_equal(engines[0].rank_confident(p1, x),
                               engines[1].rank_confident(p1, x))
    return bool(same), digest


def _four_ranks(rank, world, tmp, fit_table):
    import torch.distributed as dist
    from repro_torch.core import AMAZON, LiveTask, MCALConfig
    from repro_torch.data.synth import make_classification
    from repro_torch.launch import label
    from repro_torch.launch.label import build_mesh
    mesh = build_mesh("data=4", "cpu")
    state = os.path.join(tmp, "state.json")
    argv = FLAGS + ["--mesh", "data=4", "--iters-per-run", "1", "--state",
                    state, "--trace", os.path.join(tmp, "mesh.jsonl")]
    runs, report = 0, None
    while True:
        report = _launch(argv, rank, mesh) or report
        runs += 1
        dist.barrier()
        if not os.path.exists(state):
            break
    # the reference's draws through the fit_source seam
    x, y = make_classification(400, num_classes=4, difficulty=0.3, seed=0)
    task = LiveTask(features=x, groundtruth=y, num_classes=4, seed=0,
                    device="cpu", mesh=mesh,
                    fit_source=lambda n: (fit_table["init"],
                                          fit_table["orders"][n]))
    res, _ = label.run_campaign(task, AMAZON, MCALConfig(seed=0),
                                writer=rank == 0)
    seam = {"decision": res.decision, "B": res.B_size,
            "cost": res.total_cost, "error": res.measured_error}
    return runs, report, seam, _engines_equal(rank, mesh)


def _fit_table():
    """The JAX launcher task's init params and the epoch orders of every
    retrain size a 400-row campaign can ask for."""
    from repro.core.task import LiveTask as JLiveTask
    from repro.data.synth import make_classification as jmake
    from test_torch_campaign import _jax_fit_source
    x, y = jmake(400, num_classes=4, difficulty=0.3, seed=0)
    jtask = JLiveTask(features=x, groundtruth=y, num_classes=4, seed=0)
    source = _jax_fit_source(jtask)
    init = source(1)[0]
    return {"init": init, "orders": {n: source(n)[1] for n in range(1, 401)}}


def test_mesh_campaign_resumes_diffs_clean_and_meets_the_reference(tmp_path):
    from repro_torch.launch import label
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.trace import diff
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.label"] + FLAGS
        + ["--mesh", "data=4"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        table = _fit_table()
        ranks = run_ranks(_four_ranks, 4, "cpu", args=(str(tmp_path), table),
                          threads=1, timeout=300)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            label.main(FLAGS + ["--device", "cpu", "--trace",
                                str(tmp_path / "plain.jsonl")])
        plain = json.loads(out.getvalue())
    finally:
        jout, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    runs, report, seam, (same, _) = ranks[0]
    assert runs > 1 and report["iterations"] >= runs - 1
    assert {k: v for k, v in report.items() if k != "trace"} == \
        {k: v for k, v in plain.items() if k != "trace"}
    assert diff(str(tmp_path / "plain.jsonl"),
                str(tmp_path / "mesh.jsonl")) is None
    # every rank ran the same campaign and held its engines equal
    assert all(r[0] == runs and r[2] == seam for r in ranks)
    assert all(r[3][0] for r in ranks), [r[3] for r in ranks]
    assert len({r[3][1] for r in ranks}) == 1
    want = json.loads(jout)
    assert seam["decision"] == want["decision"]
    assert abs(seam["B"] - want["B_frac"] * 400) <= 0.05 * want["B_frac"] \
        * 400
    assert abs(seam["cost"] - want["cost"]) <= 0.02 * want["cost"]
    for e in (seam["error"], want["measured_error"]):
        assert e <= 0.05 + 0.005


def _two_ranks(rank, world, tmp):
    from repro_torch.core import AMAZON, MCALConfig
    from repro_torch.core.tenant import TenantSpec
    from repro_torch.data.synth import make_classification
    from repro_torch.launch.label import build_mesh
    from repro_torch.launch.orchestrator import build_fleet
    from repro_torch.trace import diff
    mesh = build_mesh("data=2", "cpu")
    traces = {}
    for name, extra in (("sync", []), ("async", ["--sweep-async",
                                                "--fit-async"])):
        traces[name] = os.path.join(tmp, f"{name}.jsonl")
        _launch(FLAGS + ["--metric", "kcenter", "--mesh", "data=2",
                         "--trace", traces[name]] + extra, rank, mesh)
    clean = diff(traces["sync"], traces["async"]) is None if rank == 0 \
        else None
    x, y = make_classification(320, num_classes=3, difficulty=0.3, seed=0)
    specs = [TenantSpec(f"t{i}", priority=i % 3, seed=i, cfg=MCALConfig(
        max_iters=2, delta0_frac=0.1, test_frac=0.2, seed=i,
        eps_target=0.05 + 0.01 * (i % 4))) for i in range(8)]
    fleets = {}
    for concurrent in (True, False):
        orch = build_fleet(x, y, specs, service=AMAZON,
                           concurrent=concurrent, device="cpu", mesh=mesh,
                           engine_kw=dict(epochs=2, score_microbatch=128,
                                          sweep_page=128))
        try:
            res = orch.run()
        finally:
            orch.close()
        fleets[concurrent] = {
            t: (r.decision, r.B_size, r.S_size, r.total_cost,
                r.measured_error, r.labels.tobytes())
            for t, r in res.items()}
    return clean, fleets[True] == fleets[False], len(fleets[True])


def test_async_campaign_and_concurrent_fleet_on_two_ranks(tmp_path):
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(_two_ranks, 2, "cpu", args=(str(tmp_path),),
                      threads=1, timeout=300)
    assert ranks[0][0] is True
    assert all(r[1:] == (True, 8) for r in ranks)
