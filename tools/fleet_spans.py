#!/usr/bin/env python3
"""Where a fleet's time goes: the span breakdown of ``chip_smoke.py``'s
fleet, run serially and then concurrently.

    python3 tools/fleet_spans.py [--pool 50000] [--max-iters 200]
                                 [--device cuda]

The eight tenants of ``chip_smoke.fleet_specs`` share one engine bundle
(``launch.orchestrator.build_fleet``) with a ``MetricsRegistry`` attached:
every tenant's rounds, fits, sweeps and k-center passes are spans labeled
with the tenant.  For each mode it prints the wall and, per span name, the
calls and the seconds summed over the tenants; a sum above the wall is
time that threads spent side by side (a ``fit`` span includes the wait for
the fit engine's lock).  Prints the card's line (on a CUDA device) and one
JSON line of both modes.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def span_totals(snapshot) -> dict:
    """{span name: {"calls", "seconds"}} summed over every label set."""
    out = {}
    for h in snapshot["histograms"]:
        if h["name"] != "span_seconds":
            continue
        row = out.setdefault(h["labels"]["name"], {"calls": 0,
                                                   "seconds": 0.0})
        row["calls"] += h["count"]
        row["seconds"] += h["sum"]
    return dict(sorted(out.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=50_000)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line, fleet_specs
    from repro_torch.core import AMAZON
    from repro_torch.data.synth import make_classification
    from repro_torch.launch.orchestrator import build_fleet
    from repro_torch.obs import MetricsRegistry

    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        print(f"card: {card_line()}", flush=True)
    x, y = make_classification(args.pool, num_classes=10, dim=32,
                               difficulty=0.3, seed=0)
    modes = {}
    for mode in ("serial", "concurrent"):
        m = MetricsRegistry()
        with tempfile.TemporaryDirectory() as tmp:
            orch = build_fleet(x, y, fleet_specs(args.max_iters),
                               service=AMAZON, trace_dir=tmp,
                               concurrent=mode == "concurrent", metrics=m,
                               device=args.device)
            t0 = time.perf_counter()
            try:
                orch.run()
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                orch.close()
        spans = span_totals(m.snapshot())
        modes[mode] = {"wall": wall, "spans": spans}
        print(f"{mode}: wall {wall:.3f} s; " + ", ".join(
            f"{k} {v['calls']} x -> {v['seconds']:.3f} s"
            for k, v in spans.items()), flush=True)
    print(json.dumps({"pool": args.pool, "device": args.device,
                      "modes": modes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
