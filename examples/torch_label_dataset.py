"""End-to-end live labeling campaign on the PyTorch port — the paper's
system, for real (the twin of ``examples/label_dataset.py``).

    PYTHONPATH=src python examples/torch_label_dataset.py [--device cuda]
    PYTHONPATH=src python examples/torch_label_dataset.py --noisy
    PYTHONPATH=src python examples/torch_label_dataset.py --trace run.jsonl
    PYTHONPATH=src python examples/torch_label_dataset.py \
        --slo examples/slo.json

Everything is live: a PyTorch MLP classifier is (re)trained by the port's
fit engine on every MCAL iteration (one CUDA graph per retrain bucket on a
card), the pool is scored through the ``margin_head`` kernel, human labels
are charged to the ledger, and the final hybrid labeling is validated
against the oracle.  ``--device`` picks where the classifier lives
(default cuda); the tests run it with ``--device cpu``, where it takes
seconds.

Default mode keeps the paper's assumption (human labels are perfect and
cost one request each).  ``--noisy`` replaces that oracle with the
annotation-service runtime: a seeded pool of imperfect annotators
(including a spammer), Dawid-Skene EM aggregation on the device, an
adaptive-repeats policy (extra votes only for items whose aggregated
posterior is still unsure), every vote charged at the service rate, and
the campaign folding the residual aggregated-label error into its
accuracy target.

``--trace run.jsonl`` records the campaign's full event stream (every
charge, fit, search, acquisition, iteration, commit) to an append-only
trace in the reference's schema — render it with ``python -m
repro_torch.launch.report run.jsonl``, replay it with ``python -m
repro_torch.launch.label --trace-replay run.jsonl``, or diff it against a
sibling run (of either package) with ``--trace-diff``.

``--metrics`` instruments the engines' hot paths with the runtime metrics
layer (``repro_torch.obs``): spans, cache counters, queue gauges; a
per-span breakdown prints at the end.  ``--chaos`` runs the campaign under
seeded fault injection (``repro_torch.faults``: a flaky annotation
backend, one worker crash per engine, one torn trace write), all
recovered, so the result equals the fault-free run's.  ``--slo
examples/slo.json`` runs the campaign under the streaming health engine
(``repro_torch.obs.health``); judgment counts print at the end.
"""
import argparse

import numpy as np

from repro_torch.core import AMAZON, LiveTask, MCALConfig, run_mcal
from repro_torch.data.synth import make_classification

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
ap.add_argument("--noisy", action="store_true")
ap.add_argument("--metrics", action="store_true")
ap.add_argument("--chaos", action="store_true")
ap.add_argument("--trace", default="")
ap.add_argument("--slo", default="")
args = ap.parse_args()
NOISY, METRICS, CHAOS = args.noisy, args.metrics, args.chaos
TRACE, SLO = args.trace, args.slo
POOL, CLASSES, DIM = 6_000, 10, 32

print(f"generating a {POOL:,}-sample / {CLASSES}-class pool "
      f"(25% hard tail) ...")
x, y = make_classification(POOL, num_classes=CLASSES, dim=DIM,
                           difficulty=0.3, hard_frac=0.25, seed=0)

annotation = None
eps_target = 0.05
if NOISY:
    from repro_torch.annotation import make_annotation_service
    annotation = make_annotation_service(
        CLASSES, n_workers=5, noise=0.15, spammer_frac=0.2,
        repeats=2, max_repeats=4, adaptive=True, confidence=0.9,
        aggregator="ds", pricing=AMAZON, seed=0, device=args.device)
    eps_target = 0.15     # leave budget for the annotators' residual
    q = annotation.calibrate()   # measured on a synthetic seeded batch
    print(f"noisy annotation service: 5 workers (1 spammer), "
          f"adaptive 2-4 votes/label, Dawid-Skene aggregation")
    print(f"calibrated label quality: residual error "
          f"~{q.residual_error:.1%}, ~{q.avg_repeats:.2f} votes/label")

task = LiveTask(features=x, groundtruth=y, num_classes=CLASSES,
                hidden=64, depth=2, epochs=30, c_u_nominal=2e-4, seed=0,
                annotation=annotation, device=args.device)

print("running MCAL (real training per iteration) ...")
cfg = MCALConfig(eps_target=eps_target, delta0_frac=0.02, max_iters=25,
                 seed=0, label_quality=q if annotation else None)
metrics = None
if METRICS:
    from repro_torch.obs import MetricsRegistry
    metrics = MetricsRegistry()
faults = retry = None
if CHAOS:
    from repro_torch.faults import FaultInjector, FaultPlan, RetryPolicy
    faults = FaultInjector(FaultPlan.standard_transient(0))
    retry = RetryPolicy(seed=0)
    print("chaos mode: standard transient fault plan injected "
          "(flaky annotation backend, one crash per engine broker, "
          "one torn trace write)")
health = None
if SLO:
    from repro_torch.obs import HealthEngine, SLOSpec
    spec = SLOSpec.load(SLO)
    health = HealthEngine(spec)
    print(f"health engine armed: SLO contract {spec.to_dict()} "
          f"judged every iteration (+ burn/drift/fit detectors)")
if TRACE:
    from repro_torch.trace import TraceStore
    with TraceStore(TRACE, "example-live-s0") as tr:
        if metrics is not None:
            metrics.attach_trace(tr)
        result = run_mcal(task, AMAZON, cfg, trace=tr, metrics=metrics,
                          faults=faults, retry=retry, health=health)
        if metrics is not None:
            metrics.emit_snapshot(scope="example")
    print(f"trace          : {TRACE} (replay: python -m "
          f"repro_torch.launch.label --trace-replay {TRACE}"
          + (f"; panel: python -m repro_torch.launch.report {TRACE} "
             f"--metrics)" if metrics is not None else ")"))
else:
    result = run_mcal(task, AMAZON, cfg, metrics=metrics,
                      faults=faults, retry=retry, health=health)
task.close()

human_all = POOL * AMAZON.price_per_label
bound = eps_target
if NOISY:
    human_all *= cfg.label_quality.avg_repeats
    bound = eps_target + cfg.label_quality.residual_error
print(f"\ndecision       : {result.decision}")
print(f"trained on     : {result.B_size:,} human labels "
      f"({result.B_size / POOL:.1%})")
print(f"machine-labeled: {result.S_size:,} ({result.S_size / POOL:.1%}) "
      f"at theta={result.theta_final:.2f}")
print(f"measured error : {result.measured_error:.2%} "
      f"(achievable bound {bound:.0%})")
print(f"cost           : ${result.total_cost:.2f} "
      f"(human-only ${human_all:.0f}; "
      f"{1 - result.total_cost / human_all:.1%} saved)")
print(f"ledger         : {result.ledger}")
if NOISY:
    print(f"annotation     : {annotation.votes_bought:,} votes for "
          f"{result.ledger['human_labels']:,} labels "
          f"(avg {annotation.avg_repeats():.2f}/label); "
          f"worker accuracy "
          f"{np.round(annotation.worker_accuracy(), 2).tolist()}")
if faults is not None:
    print(f"chaos          : {faults.fired} faults injected across "
          f"{sum(faults.counters().values()):,} seam ticks "
          f"({', '.join(sorted(faults.counters()))}) — all recovered")
if health is not None:
    c = health.counts()
    act = ", ".join(c["active"]) or "none"
    print(f"health         : {c['alerts_raised']} alerts raised / "
          f"{c['alerts_cleared']} cleared, {c['slo_breaches']} SLO "
          f"breaches over {c['ticks']} ticks (active: {act})"
          + (f" — panel: python -m repro_torch.launch.report {TRACE} "
             f"--health" if TRACE else ""))
if metrics is not None:
    snap = metrics.snapshot()
    spans = sorted((h for h in snap["histograms"]
                    if h["name"] == "span_seconds"),
                   key=lambda h: -h["sum"])
    parts = [f"{h['labels'].get('name', '?')} x{h['count']} "
             f"({h['sum']:.1f}s)" for h in spans[:5]]
    print("metrics        : " + ", ".join(parts))
assert result.measured_error <= bound + 0.01, "error bound violated!"
