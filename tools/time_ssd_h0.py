#!/usr/bin/env python3
"""Time the SSD scan's kernel pair from an incoming state against the
same pair from zeros, in turns on one card, with each forward launch's
device time.

    python3 tools/time_ssd_h0.py [--shapes 8x128 8x512] [--turns 3]

At a "model" rank's block of mamba2-1.3b's training shape (B x T of H 64,
hd 64, N 128, chunk 128, xh and dy bf16, inputs from a seed): the forward
``ssd_scan`` and the backward ``ssd_scan_bwd`` (no final-state gradient)
with ``h0`` None, with a random fp32 ``h0`` and with ``h0`` zeros (the
backward with ``with_dh0`` where ``h0`` is given), ``--turns`` times in
the order none, h0, zeros, zeros, h0, none.  Device ms: 20 calls queued
back to back between two CUDA events (``chip_smoke.device_ms``); then the
profiler's device time per forward launch (``ssd_scan_*``) over 20 calls
with and without ``h0``.  Prints the card's line, one line a shape and
side, and one JSON line.  Needs a CUDA device.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def launches(torch, fn, calls: int = 20) -> dict:
    """Device microseconds a call of each launch of ``fn``, by name."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)
        if t and "ssd_scan" in e.key:
            name = e.key.split("::")[-1].split("(")[0].split("<")[0]
            out[name] = t / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["8x128", "8x512"],
                    help="B x T blocks")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as ssdb
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    result = []
    for shape in args.shapes:
        B, T = (int(n) for n in shape.split("x"))
        case = (B, T, 64, 64, 128, 128)
        C = case[5]
        ins, dy, dh = cs.ssd_bwd_inputs(torch, np, case, torch.bfloat16)
        starts = {"none": None, "h0": dh * 0.1, "zeros": torch.zeros_like(dh)}
        states = {k: ssd.ssd_scan_with_states(*ins, chunk=C, h0=v)[2]
                  for k, v in starts.items()}
        times = {k: [] for k in starts}
        for _ in range(args.turns):
            for k in ("none", "h0", "zeros", "zeros", "h0", "none"):
                v = starts[k]
                fwd = cs.device_ms(
                    torch, lambda: ssd.ssd_scan(*ins, chunk=C, h0=v))
                bwd = cs.device_ms(torch, lambda: ssdb.ssd_scan_bwd(
                    *ins, states[k], dy, None, chunk=C,
                    with_dh0=v is not None))
                times[k].append((fwd, bwd))
        by_launch = {k: launches(torch, lambda: ssd.ssd_scan(
            *ins, chunk=C, h0=starts[k])) for k in ("none", "h0")}
        for k, v in times.items():
            f = sorted(t[0] for t in v)
            b = sorted(t[1] for t in v)
            print(f"{case} h0 {k}: forward device ms median "
                  f"{float(np.median(f)):.6f} ({f[0]:.6f}-{f[-1]:.6f}), "
                  f"backward {float(np.median(b)):.6f} "
                  f"({b[0]:.6f}-{b[-1]:.6f}) ({card})", flush=True)
        for k, v in by_launch.items():
            print(f"{case} h0 {k}: forward launches device us a call "
                  + ", ".join(f"{n} {t:.2f}" for n, t in v.items())
                  + f" ({card})", flush=True)
        result.append({"shape": list(case), "device_ms": {
            k: {"forward": [t[0] for t in v], "backward": [t[1] for t in v]}
            for k, v in times.items()}, "forward_launch_us": by_launch})
        del ins, dy, dh, starts, states
        torch.cuda.empty_cache()
    print(f"card: {card}", flush=True)
    print(json.dumps({"ssd_h0": result}), flush=True)


if __name__ == "__main__":
    main()
