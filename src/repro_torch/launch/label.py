"""MCAL labeling-campaign launcher (``repro.launch.label``) on this host's
device (a CUDA device unless ``--device cpu``).

Live mode (a classifier trained on the device):
    PYTHONPATH=src python -m repro_torch.launch.label --live --pool 50000 \\
        --sweep-async --fit-async
    PYTHONPATH=src python -m repro_torch.launch.label --live --device cpu \\
        --pool 2000

Replay mode (paper-scale emulated learning curves, ``core.emulator``):
    PYTHONPATH=src python -m repro_torch.launch.label --dataset cifar10 \\
        --arch resnet18 --device cpu

Noisy annotation service (repeated labeling, aggregated on the device):
    PYTHONPATH=src python -m repro_torch.launch.label --dataset cifar10 \\
        --annotator-noise 0.2 --label-repeats 3 --annotator-aggregate ds

``--annotator-noise > 0`` (or ``--label-repeats > 1``, or
``--adaptive-repeats``) replaces the perfect oracle with a seeded
noisy-annotator pool: every human label is an aggregation (majority vote
or Dawid-Skene EM) over per-worker votes, every vote is charged at the
service rate, and the campaign folds the measured residual label error
into its accuracy target (``MCALConfig.label_quality``).

Campaign state (ledger, pool bitmap, per-theta history, fitted power laws,
the engines' bucket keys) is saved to ``--state`` after every iteration,
so a preempted campaign resumes mid-loop; during the commit sweep a
resumable ``SweepCheckpoint`` cursor is embedded every
``--sweep-ckpt-pages`` pages.  ``--iters-per-run`` bounds how many
iterations one invocation runs: a campaign not done by then saves its
state and exits with a resumable report.  The state file's schema is the
reference's, so a campaign saved by ``repro.launch.label`` resumes here
and the other way round.  ``--trace`` writes the campaign's event log
(appended to at the checkpointed cursor on resume);
``--trace-replay`` and ``--trace-diff`` read traces of either package.

Resilience and observability: ``--chaos`` runs the campaign under the
standard transient fault plan with a retry policy, ``--autosave`` leaves a
resumable sidecar when a fault unwinds the loop, ``--sweep-timeout`` /
``--fit-timeout`` bound the async folds; ``--metrics``, ``--prom``,
``--slo`` and ``--profile`` record runtime telemetry, judge it, and trace
one iteration's kernels with ``torch.profiler``:
    PYTHONPATH=src python -m repro_torch.launch.label --live --device cpu \
        --pool 2000 --chaos --trace t.jsonl --metrics t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.report t.jsonl --metrics

``--mesh data=N`` shards every pool pass's microbatches over N ranks
and runs the same retrain on each (live mode): with N > 1 the launcher
spawns N ranks on this host (one card each on ``cuda``, gloo processes on
the CPU), rank 0 alone writes the report, trace, state file and sweep
cursor; ``--mesh data=1`` is a one-rank group in this process:
    PYTHONPATH=src python -m repro_torch.launch.label --live --device cpu \
        --pool 2000 --mesh data=4
"""
from __future__ import annotations

import argparse
import json
import math
import os

# the reference's literal (the launcher must not import torch until
# parsing succeeds: --help never pays for it)
METRIC_CHOICES = ("margin", "entropy", "least_confidence", "kcenter",
                  "random")
# annotation.service.AGGREGATORS, a literal for the same reason
AGGREGATE_CHOICES = ("majority", "ds")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--live", action="store_true",
                    help="live mode: train a classifier on this host's "
                         "device (default: the replay mode)")
    ap.add_argument("--dataset", default="cifar10",
                    choices=("fashion", "cifar10", "cifar100", "imagenet"))
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--pool", type=int, default=4000)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--difficulty", type=float, default=0.3)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--budget", type=float, default=None)
    ap.add_argument("--metric", default="margin", choices=METRIC_CHOICES)
    ap.add_argument("--service", default="amazon",
                    choices=("amazon", "satyam"))
    ap.add_argument("--sweep-page", type=int, default=8192,
                    help="pool-sweep runtime page rows (the paged, "
                         "double-buffered L(.)/M(.) pool passes)")
    ap.add_argument("--sweep-async", action="store_true",
                    help="overlap each iteration's M(.) sweep with the "
                         "host-side power-law fits + joint search")
    ap.add_argument("--fit-fused", dest="fit_fused", action="store_true",
                    default=True,
                    help="the fit engine's retrain: one CUDA graph per "
                         "retrain bucket on a card (default)")
    ap.add_argument("--no-fit-fused", dest="fit_fused", action="store_false",
                    help="per-step host training loop (the exact-agreement "
                         "oracle path)")
    ap.add_argument("--fit-async", action="store_true",
                    help="defer each retrain + its measurement onto the "
                         "fit-engine worker thread (iteration records are "
                         "identical to the synchronous campaign)")
    ap.add_argument("--fit-resident", action="store_true",
                    help="keep the labeled set device-resident across "
                         "iterations; only newly bought labels upload")
    ap.add_argument("--state", default="",
                    help="campaign state file: saved every iteration (and "
                         "every --sweep-ckpt-pages pages of the commit "
                         "sweep); an existing file is resumed")
    ap.add_argument("--autosave", default="", metavar="PATH",
                    help="crash-safe sidecar: on any unhandled fault past "
                         "bootstrap the campaign flushes its trace and "
                         "writes state_dict here (atomic rename); the "
                         "next invocation resumes from it bit-identically "
                         "(--state, when present, wins)")
    ap.add_argument("--sweep-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="straggler wall budget for the async M(.) sweep "
                         "fold: a hung sweep job raises StragglerTimeout "
                         "instead of blocking forever (default: wait "
                         "forever)")
    ap.add_argument("--fit-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="straggler wall budget for the async retrain "
                         "fold (default: wait forever)")
    ap.add_argument("--chaos", action="store_true",
                    help="demo fault injection: run under the standard "
                         "transient FaultPlan (flaky annotation backend, "
                         "one broker-job crash per engine, one torn trace "
                         "write) with the default RetryPolicy — the "
                         "campaign must complete and its trace must diff "
                         "clean against a fault-free sibling")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fault-plan seed (default: --seed)")
    ap.add_argument("--sweep-ckpt-pages", type=int, default=0,
                    help="cut a resumable commit-sweep cursor into --state "
                         "every N pages (0 disables)")
    ap.add_argument("--iters-per-run", type=int, default=0,
                    help="run at most N iterations this invocation, then "
                         "save --state and exit resumable (0 = run to "
                         "completion)")
    ap.add_argument("--mesh", default="",
                    help="host/device mesh spec, e.g. 'data=4': every "
                         "pool pass splits its microbatches over the data "
                         "ranks and each rank runs the retrain (live "
                         "mode; N > 1 spawns N ranks on this host, one "
                         "card each on cuda)")
    # -- annotation service (noisy multi-annotator oracle) -----------------
    ap.add_argument("--annotator-noise", type=float, default=0.0,
                    help="per-vote error rate of the noisy annotator "
                         "pool (0 = the paper's perfect-oracle "
                         "assumption, no service attached)")
    ap.add_argument("--annotator-workers", type=int, default=5,
                    help="annotator pool size (each worker votes at most "
                         "once per item)")
    ap.add_argument("--annotator-spammers", type=float, default=0.0,
                    help="fraction of workers answering uniformly at "
                         "random")
    ap.add_argument("--annotator-aggregate", default="majority",
                    choices=AGGREGATE_CHOICES,
                    help="vote aggregation: majority vote or Dawid-Skene "
                         "EM, on the device")
    ap.add_argument("--label-repeats", type=int, default=1,
                    help="votes bought per human label (repeated "
                         "labeling; each vote is charged at the service "
                         "rate)")
    ap.add_argument("--max-repeats", type=int, default=0,
                    help="adaptive-repeats vote cap (0 = --label-repeats, "
                         "no top-up)")
    ap.add_argument("--adaptive-repeats", action="store_true",
                    help="stop buying votes for an item once its "
                         "aggregated posterior confidence clears "
                         "--repeat-confidence")
    ap.add_argument("--repeat-confidence", type=float, default=0.9,
                    help="adaptive-repeats confidence threshold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--trace", default="",
                    help="append-only campaign trace (JSONL): every "
                         "decision/charge/measurement event; a campaign "
                         "resumed via --state appends to it at the "
                         "checkpointed cursor.  Watch it live with "
                         "python -m repro_torch.launch.report")
    ap.add_argument("--trace-replay", default="", metavar="TRACE",
                    help="reconstruct a campaign report from its trace "
                         "alone (no engines, zero recompute) and exit")
    ap.add_argument("--trace-diff", nargs=2, default=None,
                    metavar=("TRACE_A", "TRACE_B"),
                    help="first-divergence analysis between two sibling "
                         "campaign traces, then exit")
    # -- runtime metrics & profiling (repro_torch.obs) ---------------------
    ap.add_argument("--metrics", default="", metavar="PATH",
                    help="record runtime telemetry (spans, counters, "
                         "bucket-cache hits) as metric events at PATH; "
                         "pass the --trace path to interleave them into "
                         "the campaign trace (replay/diff ignore them).  "
                         "View with python -m repro_torch.launch.report "
                         "--metrics")
    ap.add_argument("--slo", default="", metavar="SPEC.json",
                    help="streaming health engine: judge the campaign "
                         "against the declarative SLO spec (cost per "
                         "committed label, iteration-latency p95, "
                         "projected quality) plus the detector suite "
                         "(budget burn ETA, annotator drift, fit "
                         "quality, cache storms, queue saturation, "
                         "fault pressure) at every iteration boundary; "
                         "hysteresis-gated alert events interleave into "
                         "--trace (observability kinds — replay/diff "
                         "ignore them).  Render with python -m "
                         "repro_torch.launch.report --health")
    ap.add_argument("--prom", default="", metavar="PATH",
                    help="write a Prometheus textfile snapshot of the "
                         "metrics registry at campaign teardown")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="bracket one iteration (see --profile-iter) with "
                         "torch.profiler; its Chrome trace lands in DIR")
    ap.add_argument("--profile-iter", type=int, default=1,
                    help="which iteration --profile brackets (1-based, "
                         "default: the first)")
    ap.add_argument("--device", default="cuda")
    return ap


def build_annotation(args, num_classes: int, service):
    """The campaign's annotation service from the CLI flags, aggregating on
    ``args.device`` — None when the flags describe the perfect oracle (no
    noise, single vote, no adaptive policy)."""
    if args.annotator_noise <= 0 and args.label_repeats <= 1 \
            and not args.adaptive_repeats:
        return None
    from repro_torch.annotation import make_annotation_service
    return make_annotation_service(
        num_classes, n_workers=args.annotator_workers,
        noise=args.annotator_noise, spammer_frac=args.annotator_spammers,
        repeats=args.label_repeats,
        max_repeats=args.max_repeats or None,
        adaptive=args.adaptive_repeats,
        confidence=args.repeat_confidence,
        aggregator=args.annotator_aggregate,
        pricing=service, seed=args.seed, device=args.device)


def parse_mesh(spec: str):
    """``"data=2,model=2"`` -> ``((2, 2), ("data", "model"))``."""
    axes, shape = [], []
    for part in spec.split(","):
        name, _, n = part.partition("=")
        axes.append(name.strip())
        shape.append(int(n))
    return tuple(shape), tuple(axes)


def build_mesh(spec: str, device="cuda"):
    """``--mesh data=4`` -> a ``DeviceMesh`` with those axes over this
    process's world (a one-rank world is initialized when there is none);
    None for ''."""
    if not spec:
        return None
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*parse_mesh(spec), device=device)


def _save_state(path: str, campaign=None, cursor=None, campaign_blob=None):
    """State write by rename: the campaign loop state + an optional
    mid-sweep cursor.  ``campaign_blob`` reuses a serialized campaign dict
    (the loop state is frozen for the whole commit sweep)."""
    blob = {"campaign": campaign_blob if campaign_blob is not None
            else campaign.state_dict()}
    if cursor is not None:
        blob["sweep_cursor"] = cursor.to_json()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def run_campaign(task, service, cfg, *, state_path: str = "",
                 sweep_ckpt_pages: int = 0, iters_per_run: int = 0,
                 trace_path: str = "", campaign_id: str = "campaign",
                 metrics_path: str = "", prom_path: str = "",
                 profile_dir: str = "", profile_iter: int = 1,
                 autosave_path: str = "", sweep_timeout=None,
                 fit_timeout=None, faults=None, retry=None,
                 slo_path: str = "", writer: bool = True):
    """Drive one campaign with optional ``--state`` preemption and an
    optional ``--trace`` event log.  Returns (MCALResult | None,
    campaign): None when ``iters_per_run`` stopped the loop first.  A
    campaign resumed from a state file whose trace cursor is set appends
    to its trace (no gaps, no duplicate sequence numbers).

    ``metrics_path``/``prom_path``/``profile_dir`` wire the runtime
    observability layer (``repro_torch.obs``): any of them builds a
    ``MetricsRegistry`` and attaches it to the campaign.  When
    ``metrics_path`` names the ``trace_path`` file the metric events
    interleave into the campaign trace (observability kinds: replay and
    diff ignore them); another path gets its own store.  ``profile_dir``
    brackets iteration ``profile_iter`` with ``torch.profiler``.
    ``faults``/``retry`` run the campaign under a fault plan, and
    ``autosave_path`` keeps a resumable sidecar when anything unwinds the
    loop past bootstrap (an injected kill included).

    ``writer=False`` (a mesh's ranks other than 0) reads ``state_path``
    and ``autosave_path`` but never writes or removes them; on a mesh
    every rank reads before any goes on (a barrier), so rank 0's first
    save cannot reach another rank's read."""
    from repro_torch.core import MCALCampaign
    from repro_torch.serving.sweep import SweepCheckpoint
    from repro_torch.trace import TraceStore

    camp = MCALCampaign(task, service, cfg)
    camp.sweep_timeout = sweep_timeout
    camp.fit_timeout = fit_timeout
    blob = None
    if state_path and os.path.exists(state_path):
        with open(state_path) as f:
            blob = json.load(f)
    elif autosave_path and os.path.exists(autosave_path):
        # a prior invocation died past bootstrap and left its sidecar:
        # resume from it (an explicit --state blob wins above — it is at
        # least as recent, saved every iteration)
        with open(autosave_path) as f:
            blob = json.load(f)
    if getattr(task, "mesh", None) is not None:
        import torch.distributed as dist
        dist.barrier()
    if not writer:
        state_path = autosave_path = ""

    trace = None
    if trace_path:
        cursor = blob["campaign"].get("trace") if blob is not None else None
        if cursor and os.path.exists(trace_path):
            trace = TraceStore.resume(trace_path, cursor["next_seq"])
        else:
            trace = TraceStore(trace_path, campaign_id)
        # before bootstrap/load: the trace opens with the campaign's first
        # event (campaign_begin or the resume marker)
        camp.attach_trace(trace)

    metrics = None
    metrics_store = None     # owned here iff metrics get their own file
    if metrics_path or prom_path or profile_dir:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
        if (metrics_path and trace is not None
                and os.path.abspath(metrics_path)
                == os.path.abspath(trace_path)):
            metrics.attach_trace(trace)
        elif metrics_path:
            metrics_store = TraceStore(metrics_path, campaign_id)
            metrics.attach_trace(metrics_store)
        camp.attach_metrics(metrics)

    if slo_path:
        # after attach_trace/attach_metrics: the health engine inherits
        # whatever surfaces the campaign already observes with
        from repro_torch.obs import HealthEngine, SLOSpec
        camp.attach_health(HealthEngine(SLOSpec.load(slo_path)))

    if faults is not None:
        # after attach_trace/attach_metrics: the injector mirrors its
        # events into whatever the campaign already observes with
        camp.attach_faults(faults, retry)

    bootstrapped = False
    try:
        if blob is not None:
            camp.load_state_dict(blob["campaign"])
            if "sweep_cursor" in blob:
                camp.resume_sweep_checkpoint = SweepCheckpoint.from_json(
                    blob["sweep_cursor"])
        else:
            camp.bootstrap()
            if state_path:
                _save_state(state_path, camp)
        bootstrapped = True

        if state_path and sweep_ckpt_pages:
            camp.sweep_checkpoint_every = sweep_ckpt_pages
            frozen = {}   # campaign blob serialized once, at the first cut

            def save_cursor(ck):
                if "blob" not in frozen:
                    frozen["blob"] = camp.state_dict()
                _save_state(state_path, cursor=ck,
                            campaign_blob=frozen["blob"])

            camp.on_sweep_checkpoint = save_cursor

        try:
            ran = 0
            while not camp.done:
                if profile_dir and ran + 1 == profile_iter:
                    from repro_torch.obs import profile_block
                    with profile_block(profile_dir):
                        camp.iteration()
                else:
                    camp.iteration()
                ran += 1
                if state_path:
                    _save_state(state_path, camp)
                if iters_per_run and ran >= iters_per_run and not camp.done:
                    return None, camp
            res = camp.commit()
        except BaseException:
            # crash-safe autosave: anything that unwinds past bootstrap —
            # an injected kill included — leaves a resumable sidecar.
            # Best-effort by design: the original exception always wins.
            if autosave_path and bootstrapped:
                try:
                    if trace is not None:
                        trace.emit("autosave", path=autosave_path,
                                   iterations=len(camp.history))
                    _save_state(autosave_path, camp)
                except Exception:
                    pass
            raise
        if state_path and os.path.exists(state_path):
            os.remove(state_path)   # campaign complete: the state is spent
        if autosave_path and os.path.exists(autosave_path):
            os.remove(autosave_path)
        return res, camp
    finally:
        # join the workers first (nothing emits afterwards), then the
        # final metrics snapshot (through the still-open stores), then
        # the stores
        camp.close()
        if metrics is not None:
            metrics.emit_snapshot(scope="campaign")
            if prom_path:
                metrics.write_prometheus(prom_path)
        if metrics_store is not None:
            metrics_store.close()
        if trace is not None:
            trace.close()


def main(argv=None):
    args = build_parser().parse_args(argv)

    # trace analysis modes read event files, not devices
    if args.trace_diff is not None:
        from repro_torch.trace import diff
        d = diff(*args.trace_diff)
        if d is None:
            print(json.dumps({"identical": True}))
        else:
            print(json.dumps({"identical": False,
                              "divergence": d.describe(),
                              "index": d.index, "kind_a": d.kind_a,
                              "kind_b": d.kind_b, "fields": d.fields},
                             indent=2))
        return
    if args.trace_replay:
        from repro_torch.trace import replay
        rp = replay(args.trace_replay)
        report = {
            "campaign": rp.campaign, "replayed_from": args.trace_replay,
            "decision": rp.decision, "done_reason": rp.done_reason,
            "iterations": len(rp.history), "cost": rp.total_cost,
            "ledger": rp.ledger, "votes": rp.votes,
            "config": rp.config, "runtime": rp.runtime,
        }
        if rp.result is not None:
            report.update(theta_final=rp.result.theta_final,
                          measured_error=rp.result.measured_error,
                          B_size=rp.result.B_size,
                          S_size=rp.result.S_size)
        print(json.dumps(report, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f)
        return
    mesh, owned = None, False
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.launch.mesh import run_ranks
        shape, _ = parse_mesh(args.mesh)
        if math.prod(shape) > 1:
            run_ranks(_rank_main, math.prod(shape), args.device,
                      args=(args,))
            return
        owned = not dist.is_initialized()   # a one-rank group made here
        mesh = build_mesh(args.mesh, args.device)
    try:
        _campaign(args, 0, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _rank_main(rank: int, world: int, args) -> None:
    """One spawned rank of a ``--mesh`` campaign."""
    _campaign(args, rank, build_mesh(args.mesh, args.device))


def _campaign(args, rank: int, mesh) -> None:
    """Build and run the campaign the flags describe; rank 0 alone prints
    the report and writes files."""
    if rank:
        args = argparse.Namespace(**{**vars(args), "trace": "",
                                     "metrics": "", "prom": "",
                                     "profile": "", "out": ""})
    from repro_torch.core import (DATASETS, SERVICES, LiveTask, MCALConfig,
                                  make_emulated_task)
    from repro_torch.data.synth import make_classification

    service = SERVICES[args.service]
    num_classes = (args.classes if args.live
                   else DATASETS[args.dataset]["classes"])
    annotation = build_annotation(args, num_classes, service)
    cfg = MCALConfig(eps_target=args.eps, metric=args.metric,
                     budget=args.budget, seed=args.seed,
                     sweep_async=args.sweep_async, fit_async=args.fit_async,
                     # measured (calibration-batch) quality: what DS and
                     # adaptive repeats deliver, deterministic per seed so
                     # a resumed run rebuilds the same config
                     label_quality=(annotation.calibrate()
                                    if annotation is not None else None))
    if args.live:
        x, y = make_classification(args.pool, num_classes=args.classes,
                                   difficulty=args.difficulty,
                                   seed=args.seed)
        task = LiveTask(features=x, groundtruth=y, num_classes=args.classes,
                        seed=args.seed, sweep_page=args.sweep_page,
                        fit_fused=args.fit_fused,
                        fit_resident=args.fit_resident, device=args.device,
                        annotation=annotation, mesh=mesh)
    else:
        task = make_emulated_task(args.dataset, args.arch, seed=args.seed,
                                  sweep_page=args.sweep_page,
                                  device=args.device)
        task.annotation = annotation

    faults = retry = None
    if args.chaos:
        from repro_torch.faults import FaultInjector, FaultPlan, RetryPolicy
        chaos_seed = (args.seed if args.chaos_seed is None
                      else args.chaos_seed)
        faults = FaultInjector(FaultPlan.standard_transient(chaos_seed))
        retry = RetryPolicy(seed=chaos_seed)

    campaign_id = (f"{'live' if args.live else args.dataset}-"
                   f"{args.arch}-s{args.seed}")
    res, camp = run_campaign(task, service, cfg, state_path=args.state,
                             sweep_ckpt_pages=args.sweep_ckpt_pages,
                             iters_per_run=args.iters_per_run,
                             trace_path=args.trace,
                             campaign_id=campaign_id,
                             metrics_path=args.metrics,
                             prom_path=args.prom,
                             profile_dir=args.profile,
                             profile_iter=args.profile_iter,
                             autosave_path=args.autosave,
                             sweep_timeout=args.sweep_timeout,
                             fit_timeout=args.fit_timeout,
                             faults=faults, retry=retry,
                             slo_path=args.slo, writer=rank == 0)
    if rank:
        return
    if res is None:
        report = {"resumable": True, "state": args.state,
                  "iterations": len(camp.history),
                  "B_size": len(camp.pool.B_idx)}
        if args.trace:
            report["trace"] = args.trace
        print(json.dumps(report, indent=2))
        return
    X = task.pool_size
    human_all = X * service.price_per_label
    if annotation is not None:   # the honest baseline pays repeats too
        human_all *= cfg.label_quality.avg_repeats
    report = {
        "decision": res.decision,
        "B_frac": res.B_size / X,
        "S_frac": res.S_size / X,
        "theta_final": res.theta_final,
        "measured_error": res.measured_error,
        "cost": res.total_cost,
        "human_all_cost": human_all,
        "savings": 1.0 - res.total_cost / human_all,
        "ledger": res.ledger,
        "iterations": len(res.history),
        "device": args.device,
    }
    if args.trace:
        report["trace"] = args.trace
    if args.metrics:
        report["metrics"] = args.metrics
    if faults is not None:
        report["chaos"] = {"faults_injected": faults.fired,
                           "sites_ticked": faults.counters()}
    if args.slo and camp.health is not None:
        report["health"] = camp.health.counts()
    if annotation is not None:
        report["annotation"] = {
            "votes": annotation.votes_bought,
            "avg_repeats": annotation.avg_repeats(),
            "residual_error_est": annotation.estimated_residual_error(),
            "worker_accuracy": annotation.worker_accuracy().tolist(),
        }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)


if __name__ == "__main__":
    main()
