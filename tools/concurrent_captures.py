#!/usr/bin/env python3
"""First CUDA-graph captures of several fit engines at once, with and
without ``fit_device.CAPTURE_LOCK``.

    python3 tools/concurrent_captures.py [--rounds 5] [--no-lock]
                                         [--widths 32 64 128]

Architecture selection with ``fit_async`` retrains every candidate at
once, each on its own ``FitEngine``.  Each round makes one fresh engine
per width (``LiveTask``'s MLP at that hidden width, 5 epochs) and starts
their first retrains on one thread each, released together, beside a
thread scoring a 50,000-row pool; a round is good when no thread raised
and every engine's params and losses equal its serial retrain's bit for
bit.  ``--no-lock`` swaps the lock for a no-op, which shows what it
prevents.  Prints one line per round and a last JSON line.  Needs a CUDA
device (``--device cpu`` runs the same threads on the CPU, where nothing
is captured).

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--no-lock", action="store_true")
    ap.add_argument("--widths", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
    from repro_torch.models.registry import get_model
    from repro_torch.training import fit_device
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.no_lock:
        fit_device.CAPTURE_LOCK = contextlib.nullcontext()
    tc = TrainConfig(learning_rate=1e-2, schedule="constant",
                     weight_decay=1e-4, grad_clip=1.0)
    cfg = fit_device.FitConfig(epochs=5, batch_size=256)
    models = [get_model(ModelConfig(
        name="mlp-live", family="mlp", num_layers=2, d_model=d,
        num_classes=10, input_dim=32, dtype="float32"))
        for d in args.widths]
    rng = np.random.default_rng(0)
    jobs = [(i, rng.normal(size=(n, 32)).astype(np.float32),
             rng.integers(0, 10, n))
            for i, n in enumerate(700 * 2 ** k for k in range(len(models)))]
    want = [fit_device.FitEngine(m, tc, cfg, device=args.device).fit(*job)
            for m, job in zip(models, jobs)]
    scorer = PoolScoringEngine(models[0], ScoringConfig(microbatch=2048),
                               device=args.device)
    sparams = models[0].init(0, args.device)
    pool = rng.normal(size=(50_000, 32)).astype(np.float32)
    rounds = []
    for r in range(args.rounds):
        engines = [fit_device.FitEngine(m, tc, cfg, device=args.device)
                   for m in models]
        gate = threading.Barrier(len(engines) + 1)
        out, errors = [None] * len(engines), []

        def guarded(label, fn):
            try:
                gate.wait()
                fn()
            except Exception as e:   # noqa: BLE001 - reported per round
                errors.append(f"{label}: {type(e).__name__}: "
                              + str(e).splitlines()[0][:200])

        def fit(i):
            out[i] = engines[i].fit(*jobs[i])

        threads = [threading.Thread(target=guarded,
                                    args=(f"fit {i}", lambda i=i: fit(i)))
                   for i in range(len(engines))]
        threads.append(threading.Thread(target=guarded, args=(
            "score", lambda: [scorer.score(sparams, pool)
                              for _ in range(5)])))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if args.device == "cuda":
            torch.cuda.synchronize()
        equal = not errors and all(
            torch.equal(o[1], w[1]) and all(torch.equal(o[0][k], w[0][k])
                                            for k in w[0])
            for o, w in zip(out, want))
        rounds.append({"errors": sorted(errors), "equal_to_serial": equal,
                       "captures": [e.captures for e in engines]})
        print(f"round {r}: {rounds[-1]}", flush=True)
    if args.device == "cuda":
        import subprocess
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"lock": not args.no_lock, "widths": args.widths,
                      "bad_rounds": sum(not r["equal_to_serial"]
                                        for r in rounds),
                      "rounds": len(rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
