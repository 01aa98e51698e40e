"""Multi-tenant campaign orchestrator (``repro.launch.orchestrator``):
many campaigns, one card.

One process hosts N concurrent :class:`~repro_torch.core.mcal.MCALCampaign`s
that SHARE the engine families — one
:class:`~repro_torch.core.scoring.PoolScoringEngine`, one
:class:`~repro_torch.serving.sweep.PoolSweepRunner`, one
:class:`~repro_torch.training.fit_device.FitEngine`, and (optionally) one
:class:`~repro_torch.annotation.service.AnnotationService` — so tenant #2's
first retrain in a ``fit_plan`` bucket tenant #1 already ran replays the
CUDA graph captured then instead of capturing its own (the engines' pow2
``pack_shape`` bucketing + ``cache_keys()`` make matched-shape fleets
capture once, run N times).  The tenants' scoring goes through the
``margin_head`` kernel and their k-center through ``pairwise_sqdist``,
as a solo campaign's does.

What stays per-tenant — and what makes per-tenant results bit-identical
to running the same campaign alone:

* the campaign itself (pool bitmap, RNG stream, measurement history,
  fitted laws) and its params — engines are stateless per call given
  params (``fit_resident`` is refused under sharing);
* the :class:`~repro_torch.annotation.service.AnnotationSession`: request
  cursor + vote/label counters, so worker schedules (hence vote
  streams) and ``buy_labels`` charges are pure functions of each
  tenant's OWN request history;
* the :class:`~repro_torch.trace.store.TraceStore` (campaign id = tenant id):
  each tenant's decision stream diffs clean against its solo sibling.

Scheduling is round-based: bootstrap everyone, then rounds of one
``iteration()`` per running tenant (threads in concurrent mode, a plain
loop in serial mode — SAME code path, so the two modes produce
identical decision streams), with the
:class:`~repro_torch.core.tenant.FleetController` rebalancing budgets at
every round boundary.  Fleet-level budget events land in a separate
fleet trace.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.orchestrator \
        --tenants fleet.json --global-budget 120 --trace-dir traces/

    PYTHONPATH=src python -m repro_torch.launch.orchestrator \
        --tenants fleet.json --device cpu --pool 2000

    PYTHONPATH=src python -m repro_torch.launch.orchestrator --report traces/

``fleet.json`` is a list of tenant specs::

    [{"tenant_id": "t0", "priority": 2, "budget": 40.0, "seed": 0,
      "cfg": {"eps_target": 0.1, "max_iters": 4}}, ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional

from repro_torch.faults.errors import FaultError


@dataclasses.dataclass
class SharedEngines:
    """The fleet's one-of-each engine bundle.

    Built once, injected into every tenant's
    :class:`~repro_torch.core.task.LiveTask` (``engines=...``), closed once by
    the fleet (tenant teardown leaves shared engines alone).  The model
    and train config ride along so every tenant's params fit the
    bundle's engines and retrain graphs."""

    cfg: object                  # ModelConfig
    model: object
    tc: object                   # TrainConfig
    scoring: object              # PoolScoringEngine
    sweep: object                # PoolSweepRunner
    fit: object                  # FitEngine
    service: Optional[object] = None   # shared AnnotationService
    input_dim: int = 0
    num_classes: int = 0
    mesh: Optional[object] = None      # the engines' DeviceMesh

    @classmethod
    def build(cls, input_dim: int, num_classes: int, *,
              arch_name: str = "mlp", hidden: int = 64, depth: int = 2,
              epochs: int = 40, batch_size: int = 256,
              learning_rate: float = 1e-2, score_microbatch: int = 2048,
              sweep_page: int = 8192, device="cuda", mesh=None,
              service=None) -> "SharedEngines":
        """One engine family set for a fleet of matched-shape tenants on
        ``device`` (over ``mesh`` when given) — the same construction
        :class:`~repro_torch.core.task.LiveTask` does privately, hoisted to
        fleet scope."""
        from repro_torch.configs.base import ModelConfig, TrainConfig
        from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
        from repro_torch.models.registry import get_model
        from repro_torch.serving.sweep import (EngineSweepAdapter,
                                         PoolSweepRunner, SweepConfig)
        from repro_torch.training.fit_device import FitConfig, FitEngine
        cfg = ModelConfig(
            name=f"{arch_name}-fleet", family="mlp", num_layers=depth,
            d_model=hidden, num_classes=num_classes, input_dim=input_dim,
            dtype="float32")
        model = get_model(cfg)
        tc = TrainConfig(learning_rate=learning_rate, schedule="constant",
                         weight_decay=1e-4, grad_clip=1.0)
        scoring = PoolScoringEngine(
            model, ScoringConfig(microbatch=score_microbatch), device=device,
            mesh=mesh)
        sweep = PoolSweepRunner(EngineSweepAdapter(scoring),
                                SweepConfig(page_rows=sweep_page))
        fit = FitEngine(model, tc, FitConfig(epochs=epochs,
                                             batch_size=batch_size),
                        device=device, mesh=mesh)
        return cls(cfg=cfg, model=model, tc=tc, scoring=scoring,
                   sweep=sweep, fit=fit, service=service,
                   input_dim=input_dim, num_classes=num_classes, mesh=mesh)

    def cache_keys(self) -> Dict:
        """The pow2 buckets run so far, per engine: the scoring engine's
        pack keys and the fit engine's ``fit_plan`` buckets (one captured
        retrain graph each on a card) — the shared-cache observability
        hook, in ``LiveTask.pack_cache_keys``' form."""
        return {"scoring": [list(k) for k in self.scoring.cache_keys()],
                "fit": [list(k) for k in self.fit.cache_keys()]}

    def compiled_count(self) -> int:
        return sum(len(v) for v in self.cache_keys().values())

    def close(self) -> None:
        """Idempotent fleet-engine shutdown: join the sweep, fit, and
        annotation broker threads."""
        self.sweep.close()
        self.fit.close()
        if self.service is not None:
            self.service.close()

    def __enter__(self) -> "SharedEngines":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class CampaignOrchestrator:
    """Round-based scheduler over a tenant fleet sharing one engine
    bundle.  ``concurrent=True`` runs each round's iterations on
    threads (one per running tenant, joined at the round barrier);
    ``concurrent=False`` runs the identical schedule serially — the
    bit-identical baseline the acceptance diff compares against."""

    def __init__(self, tenants: List, controller, *,
                 engines: Optional[SharedEngines] = None,
                 concurrent: bool = True, metrics=None,
                 metrics_trace=None):
        self.tenants = list(tenants)
        self.controller = controller
        self.engines = engines
        self.concurrent = concurrent
        # runtime metrics registry (repro_torch.obs); the fleet shares ONE —
        # per-tenant attribution rides the bound `tenant` label each
        # round pushes onto its worker thread
        self.metrics = metrics
        self._metrics_trace = metrics_trace   # owned metrics.jsonl store

    # -- barrier-parallel helper -------------------------------------------
    def _run_round(self, jobs: List, phase: str = "iteration") -> None:
        """Run ``(tenant, fn)`` jobs — threads + join in concurrent
        mode, in fleet order serially otherwise (the SAME guarded code
        path, so failure semantics are mode-independent).

        Failure semantics, applied after the barrier:

        * a TERMINAL resilience fault (:class:`repro_torch.faults.FaultError`:
          retries exhausted, straggler wall budget blown) QUARANTINES
          the failing tenant via the controller — the round goes on and
          the fleet commits everyone else;
        * anything else still fails the fleet, but no longer loses its
          siblings: the first error in FLEET ORDER (deterministic, not
          completion order) is raised with every other concurrent
          tenant failure attached as ``__notes__`` (and the raw
          exceptions on ``sibling_errors``).

        With metrics attached, each job runs inside a tenant-labeled
        ``round`` span (and a thread-local label bind, so every engine
        metric the tenant records attributes to it)."""
        m = self.metrics
        if m is not None:
            def timed(t, fn):
                def run():
                    with m.bind(tenant=t.tenant_id), \
                            m.span("round", phase=phase,
                                   tenant=t.tenant_id):
                        fn()
                return run
            jobs = [(t, timed(t, fn)) for t, fn in jobs]
        errors: List = []        # (job_index, tenant, exc) — fleet order
        quarantines: List = []
        lock = threading.Lock()

        def guarded(i, t, fn):
            def run():
                try:
                    fn()
                except FaultError as e:
                    with lock:
                        quarantines.append((t, e))
                except BaseException as e:   # noqa: BLE001 - re-raised
                    with lock:
                        errors.append((i, t, e))
            return run

        if not self.concurrent or len(jobs) <= 1:
            for i, (t, fn) in enumerate(jobs):
                guarded(i, t, fn)()
        else:
            threads = [threading.Thread(target=guarded(i, t, fn),
                                        name=f"tenant-{t.tenant_id}",
                                        daemon=True)
                       for i, (t, fn) in enumerate(jobs)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        for t, e in quarantines:
            if self.controller.quarantine(t, e, phase=phase) \
                    and m is not None:
                m.inc("tenants_quarantined_total", tenant=t.tenant_id)
        if errors:
            errors.sort(key=lambda ite: ite[0])
            primary = errors[0][2]
            for _i, t, e in errors[1:]:
                note = (f"concurrent tenant failure [{t.tenant_id}]: "
                        f"{type(e).__name__}: {e}")
                if hasattr(primary, "add_note"):      # 3.11+
                    primary.add_note(note)
            primary.sibling_errors = tuple(e for _i, _t, e in errors[1:])
            raise primary

    # -- the fleet loop ----------------------------------------------------
    def run(self) -> Dict[str, object]:
        """Bootstrap everyone, iterate in rebalanced rounds until every
        tenant is done, commit everyone.  Returns
        ``{tenant_id: MCALResult}``."""
        m = self.metrics
        self._run_round([(t, t.campaign.bootstrap) for t in self.tenants],
                        phase="bootstrap")
        while any(t.running for t in self.tenants):
            if m is not None:
                with m.span("rebalance"):
                    self.controller.rebalance()
                m.inc("fleet_rounds_total")
            else:
                self.controller.rebalance()
            active = [t for t in self.tenants if t.running and not t.paused]
            if not active:
                # every running tenant is paused: the ceiling cannot be
                # met by waiting (nothing will get cheaper) — resolve
                # the stall by forcing the rest out, least-critical
                # first, instead of spinning on identical rounds
                self.controller.resolve_stall()
                break
            self._run_round([(t, t.campaign.iteration) for t in active])
        results: Dict[str, object] = {}
        lock = threading.Lock()

        def committer(t):
            def commit():
                res = t.campaign.commit()
                with lock:
                    results[t.tenant_id] = res
            return commit

        # quarantined tenants never commit: their campaign ended on a
        # fault, and committing would charge residual labels for a
        # tenant the fleet already wrote off
        self._run_round([(t, committer(t)) for t in self.tenants
                         if not t.quarantined], phase="commit")
        self.controller.finish()
        if m is not None:
            # compile-cache census + one final registry snapshot: the
            # report's fleet --metrics panel reads these from the
            # metrics stream alone
            if self.engines is not None:
                for eng, keys in self.engines.cache_keys().items():
                    m.set_gauge("compiled_programs", len(keys),
                                engine=eng)
            m.emit_snapshot(scope="fleet")
        return results

    def close(self) -> None:
        """Tenant teardown (traces + owned task resources), then the
        shared engine bundle (and the fleet's owned metrics stream)."""
        for t in self.tenants:
            t.close()
            if t.trace is not None:
                t.trace.close()
        if self.engines is not None:
            self.engines.close()
        if self._metrics_trace is not None:
            self._metrics_trace.close()


def build_fleet(features, groundtruth, specs, *, service,
                global_budget: Optional[float] = None,
                trace_dir: str = "", concurrent: bool = True,
                annotation_service=None, engine_kw: Optional[Dict] = None,
                task_kw: Optional[Dict] = None,
                metrics=None, sweep_timeout: Optional[float] = None,
                fit_timeout: Optional[float] = None,
                health=None,
                slo_enforce: bool = False, device="cuda",
                fit_sources: Optional[Dict] = None,
                mesh=None) -> CampaignOrchestrator:
    """Wire a whole fleet: one :class:`SharedEngines` bundle, one
    :class:`~repro_torch.core.task.LiveTask` + campaign +
    :class:`~repro_torch.core.tenant.Tenant` per spec (per-tenant
    ``AnnotationSession`` when a shared annotation service is given),
    per-tenant traces under ``trace_dir`` (campaign id = tenant id) plus
    a fleet trace, and the :class:`~repro_torch.core.tenant.FleetController`
    over them all.

    ``metrics`` is an optional ``repro_torch.obs.MetricsRegistry`` shared by
    the whole fleet (tenant attribution via the orchestrator's bound
    labels).  With a ``trace_dir`` its events stream into
    ``metrics.jsonl`` beside the tenant traces — observability kinds
    only, so tenant decision streams still diff clean.

    ``health`` is an optional ``repro_torch.obs.HealthEngine``: the controller
    ticks it at every rebalance boundary, its alert events ride the
    FLEET trace (tenant decision streams untouched), and with
    ``slo_enforce`` its enforceable SLO breach verdicts drive the
    downgrade cascade.

    ``device`` places the engines (and the annotation aggregation is the
    service's own), over ``mesh`` when given: every tenant's passes then
    gather over the data group copy of the thread that runs them (its
    ``tenant-<id>`` thread, or the caller's in serial mode).  A meshed
    fleet refuses ``sweep_async`` and ``fit_async``: the shared workers
    would take the tenants' jobs in a different order on each rank.
    ``fit_sources`` maps a tenant id to its task's
    ``fit_source`` (the test seam that feeds a retrain the JAX package's
    init and epoch orders)."""
    import numpy as np

    from repro_torch.core.mcal import MCALCampaign
    from repro_torch.core.task import LiveTask
    from repro_torch.core.tenant import FleetController, Tenant

    features = np.asarray(features, np.float32)
    groundtruth = np.asarray(groundtruth, np.int64)
    num_classes = int(groundtruth.max()) + 1
    if mesh is not None and any(s.cfg.sweep_async or s.cfg.fit_async
                                for s in specs):
        raise ValueError(
            "a fleet over a mesh runs its tenants' passes synchronously: "
            "the shared sweep and fit workers would order the tenants' "
            "jobs differently on each rank")
    engines = SharedEngines.build(features.shape[1], num_classes,
                                  service=annotation_service, device=device,
                                  mesh=mesh, **(engine_kw or {}))
    if mesh is not None:
        # the tenant threads' own groups, created alike on every rank
        engines.scoring.add_threads([f"tenant-{s.tenant_id}"
                                     for s in specs])
    fleet_trace = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    tenants = []
    for spec in specs:
        ann = None
        if annotation_service is not None:
            ann = annotation_service.session(spec.tenant_id)
        task = LiveTask(features=features, groundtruth=groundtruth,
                        num_classes=num_classes, seed=spec.seed,
                        engines=engines, annotation=ann, device=device,
                        fit_source=(fit_sources or {}).get(spec.tenant_id),
                        **(task_kw or {}))
        camp = MCALCampaign(task, service, spec.cfg)
        # straggler wall budgets (--sweep-timeout/--fit-timeout): a hung
        # async fold raises StragglerTimeout -> FaultError -> quarantine
        camp.sweep_timeout = sweep_timeout
        camp.fit_timeout = fit_timeout
        trace = None
        if trace_dir:
            from repro_torch.trace import TraceStore
            trace = TraceStore(
                os.path.join(trace_dir, f"{spec.tenant_id}.jsonl"),
                spec.tenant_id)
            camp.attach_trace(trace)
        if metrics is not None:
            camp.attach_metrics(metrics)
        tenants.append(Tenant(spec, camp, trace))
    if trace_dir:
        from repro_torch.trace import TraceStore
        fleet_trace = TraceStore(os.path.join(trace_dir, "fleet.jsonl"),
                                 "fleet")
    metrics_trace = None
    if metrics is not None and trace_dir and metrics.trace is None:
        from repro_torch.trace import TraceStore
        metrics_trace = TraceStore(os.path.join(trace_dir, "metrics.jsonl"),
                                   "fleet-metrics")
        metrics.attach_trace(metrics_trace)
    if health is not None:
        # fleet-level judgment rides the fleet trace (alert kinds are
        # not FLEET_KINDS, so fleet traces still diff clean under them)
        if health.trace is None and fleet_trace is not None:
            health.attach_trace(fleet_trace)
        if health.metrics is None and metrics is not None:
            health.attach_metrics(metrics)
    controller = FleetController(tenants, global_budget, fleet_trace,
                                 health=health, slo_enforce=slo_enforce)
    return CampaignOrchestrator(tenants, controller, engines=engines,
                                concurrent=concurrent, metrics=metrics,
                                metrics_trace=metrics_trace)


# -- fleet report ------------------------------------------------------------

def fleet_report(trace_dir: str) -> Dict:
    """The ``--report`` fleet view: per-tenant campaign summaries (the
    single-campaign ``launch.report`` machinery, one trace each) rolled
    up with the fleet trace's budget decisions."""
    from repro_torch.launch.report import summarize
    from repro_torch.trace.store import read_trace

    out: Dict = {"tenants": {}, "fleet": None}
    for name in sorted(os.listdir(trace_dir)):
        if not name.endswith(".jsonl") or name in ("fleet.jsonl",
                                                   "metrics.jsonl"):
            continue
        path = os.path.join(trace_dir, name)
        out["tenants"][name[:-len(".jsonl")]] = summarize(path)
    fleet_path = os.path.join(trace_dir, "fleet.jsonl")
    if os.path.exists(fleet_path):
        rounds, downgrades, redistributions, final = 0, [], [], None
        quarantines = []
        ceiling = None
        for e in read_trace(fleet_path):
            if e.kind == "fleet_begin":
                ceiling = e.payload.get("ceiling")
            elif e.kind == "fleet_round":
                rounds += 1
            elif e.kind == "downgrade":
                downgrades.append(e.payload)
            elif e.kind == "redistribute":
                redistributions.append(e.payload)
            elif e.kind == "quarantine":
                quarantines.append(e.payload)
            elif e.kind == "fleet_done":
                final = e.payload
        out["fleet"] = {"ceiling": ceiling, "rounds": rounds,
                        "downgrades": downgrades,
                        "redistributions": redistributions,
                        "quarantines": quarantines,
                        "final": final}
    return out


def render_fleet(report: Dict) -> str:
    lines = ["== fleet =="]
    fl = report.get("fleet")
    if fl:
        lines.append(f"  ceiling   {fl['ceiling']}")
        lines.append(f"  rounds    {fl['rounds']}")
        lines.append(f"  downgrades {len(fl['downgrades'])}"
                     + ("".join(f"\n    r{d['round']} {d['action']:>13} "
                                f"{d['tenant']}"
                                for d in fl["downgrades"])))
        if fl.get("quarantines"):
            lines.append(
                f"  quarantined {len(fl['quarantines'])}"
                + "".join(f"\n    r{q['round']} {q['tenant']} "
                          f"({q.get('phase', '?')}: {q.get('error', '')})"
                          for q in fl["quarantines"]))
        if fl.get("final"):
            lines.append(f"  spent     ${fl['final']['total']:.4f}")
    for tid, s in report.get("tenants", {}).items():
        led = s.get("ledger") or {}
        lines.append(f"-- {tid}: iters={len(s.get('iterations') or ())} "
                     f"done={s.get('done_reason')} "
                     f"total=${led.get('total', 0.0):.4f}")
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", default="",
                    help="fleet config JSON: a list of tenant specs "
                         "({tenant_id, priority, budget, seed, cfg})")
    ap.add_argument("--global-budget", type=float, default=None,
                    help="hard fleet spend ceiling: breaching it runs "
                         "the criticality-ordered downgrade cascade")
    ap.add_argument("--trace-dir", default="traces",
                    help="per-tenant traces (<tenant_id>.jsonl) + the "
                         "fleet trace (fleet.jsonl) land here")
    ap.add_argument("--report", default="", metavar="TRACE_DIR",
                    help="render the fleet view from a trace dir and "
                         "exit (no engines)")
    ap.add_argument("--serial", action="store_true",
                    help="run the identical round schedule without "
                         "threads (the bit-identical baseline)")
    ap.add_argument("--metrics", action="store_true",
                    help="runtime metrics: per-tenant round spans + "
                         "engine telemetry stream into "
                         "<trace-dir>/metrics.jsonl and a Prometheus "
                         "snapshot lands at <trace-dir>/metrics.prom "
                         "(render with launch.report --metrics)")
    ap.add_argument("--slo", default="", metavar="SPEC.json",
                    help="streaming health engine: judge every tenant "
                         "against the declarative SLO spec (cost per "
                         "committed label, iteration-latency p95, "
                         "projected quality) at every rebalance "
                         "boundary; hysteresis-gated alert events land "
                         "in fleet.jsonl (render with launch.report "
                         "--health)")
    ap.add_argument("--slo-enforce", action="store_true",
                    help="act on enforceable SLO breaches: breaching "
                         "tenants walk the downgrade cascade (pause -> "
                         "shrink_votes -> force_commit, one step per "
                         "breached rebalance, deterministic walk order)")
    ap.add_argument("--sweep-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="straggler wall budget for async M(.) sweep "
                         "folds: a hung sweep job raises "
                         "StragglerTimeout and quarantines its tenant "
                         "(default: wait forever)")
    ap.add_argument("--fit-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="straggler wall budget for async retrain "
                         "folds (default: wait forever)")
    ap.add_argument("--pool", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--difficulty", type=float, default=0.3)
    ap.add_argument("--service", default="amazon",
                    choices=("amazon", "satyam"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--annotator-noise", type=float, default=0.0)
    ap.add_argument("--annotator-workers", type=int, default=5)
    ap.add_argument("--label-repeats", type=int, default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet's engines and the annotation "
                         "aggregation run")
    return ap


def main():
    args = build_parser().parse_args()
    if args.report:
        rep = fleet_report(args.report)
        print(render_fleet(rep))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=2)
        return
    if not args.tenants:
        raise SystemExit("--tenants config.json required (or --report)")

    from repro_torch.core import SERVICES
    from repro_torch.core.tenant import TenantSpec
    from repro_torch.data.synth import make_classification

    with open(args.tenants) as f:
        specs = [TenantSpec.from_dict(d) for d in json.load(f)]
    service = SERVICES[args.service]
    x, y = make_classification(args.pool, num_classes=args.classes,
                               difficulty=args.difficulty, seed=args.seed)
    annotation = None
    if args.annotator_noise > 0 or args.label_repeats > 1:
        from repro_torch.annotation import make_annotation_service
        annotation = make_annotation_service(
            args.classes, n_workers=args.annotator_workers,
            noise=args.annotator_noise, repeats=args.label_repeats,
            pricing=service, seed=args.seed, device=args.device)

    metrics = None
    if args.metrics:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    health = None
    if args.slo:
        from repro_torch.obs import HealthEngine, SLOSpec
        health = HealthEngine(SLOSpec.load(args.slo))
    elif args.slo_enforce:
        raise SystemExit("--slo-enforce requires --slo SPEC.json")
    orch = build_fleet(x, y, specs, service=service,
                       global_budget=args.global_budget,
                       trace_dir=args.trace_dir,
                       concurrent=not args.serial,
                       annotation_service=annotation,
                       metrics=metrics,
                       sweep_timeout=args.sweep_timeout,
                       fit_timeout=args.fit_timeout,
                       health=health, slo_enforce=args.slo_enforce,
                       device=args.device)
    try:
        results = orch.run()
    finally:
        if metrics is not None and args.trace_dir:
            metrics.write_prometheus(
                os.path.join(args.trace_dir, "metrics.prom"))
        orch.close()
    report = {
        "tenants": {tid: {"decision": r.decision, "cost": r.total_cost,
                          "B_size": r.B_size, "S_size": r.S_size,
                          "measured_error": r.measured_error,
                          "iterations": len(r.history)}
                    for tid, r in results.items()},
        "fleet": orch.controller.ledger_snapshot(),
        "compiled_programs": (orch.engines.compiled_count()
                              if orch.engines else None),
        "trace_dir": args.trace_dir,
    }
    if health is not None:
        report["health"] = health.counts()
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)


if __name__ == "__main__":
    main()
