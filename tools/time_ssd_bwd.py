#!/usr/bin/env python3
"""Time the SSD scan's backward kernel against another build of it, in
turns on one card, with each launch's device time.

    python3 tools/time_ssd_bwd.py [--variant build/pr23/ssd_scan_bwd.cu ...]
                                  [--shapes mamba2 zamba2 ...]
                                  [--reps 20] [--turns 2]

At each shape (xh and dy bf16, as training gives them, inputs from a seed,
the forward kernel's per-chunk states, no final-state gradient):
``ssd_scan_bwd`` as built from ``csrc/``, and each ``--variant`` source
(a ``ssd_scan_bwd.cu`` of the same C interface, e.g. an earlier commit's,
compiled with the same nvcc flags, the variant's own directory and then
``csrc/`` on the include path, so that headers saved beside it win).
Device ms: ``--reps`` calls queued back to back between two CUDA events
(``chip_smoke.device_ms``), taken in turns: the kernel, the variants in
order, again in reverse, the kernel, ``--turns`` times; the profiler's
device time per launch name (``ssd_bwd_*``) of the kernel and of each
variant; the bound (``chip_smoke``'s: the bytes or the products at the
bf16 peak); and the largest difference between the gradients of the
kernel and of each variant; each gradient's largest error against a
float64 truth (the split plain version run in float64 on float64 inputs
and forward states) for the kernel, each variant and the fp32 split
version.  Prints the card's line and one JSON line.
Needs a CUDA device.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (B, T, H, hd, N, C): the training paths' shapes, and their head blocks
# at 16 "model" ranks
SHAPES = {"mamba2": (8, 2048, 64, 64, 128, 128),
          "zamba2": (8, 2048, 80, 64, 64, 128),
          "mamba2_rank": (8, 2048, 4, 64, 128, 128),
          "zamba2_rank": (8, 2048, 5, 64, 64, 128)}


def print_spills(label: str, log: str) -> None:
    """ptxas's spill line of each ``ssd_bwd_*`` kernel in an nvcc log."""
    entry = ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            at = line.find("ssd_bwd_")
            entry = line[at:at + 40] if at >= 0 else ""
        elif "spill stores" in line and entry:
            print(f"ptxas {label} {entry}: {line.strip()}", flush=True)


def load_variant(path: Path):
    """The variant source's bf16 entry point, typed as the wrapper types
    its own."""
    from repro_torch.kernels import build
    out = (build.BUILD_ROOT / "variants"
           / f"lib{path.parent.name}_{path.stem}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-I", str(path.parent),
                           "-I", str(build.CSRC), "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print_spills(str(path), proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(out)).ssd_scan_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def float64_truth(torch, ref, ins, C: int):
    """The gradients of the split plain version run in float64 (its
    ``.float()`` casts bound to ``.double()`` for the call) on float64
    inputs and float64 forward states, dy given last in ``ins``."""
    as_float = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        xs = [t.double() for t in ins]
        _, _, states = ref.ssd_scan_passes_ref(*xs[:5], chunk=C)
        return ref.ssd_scan_bwd_passes_ref(*xs[:5], states, xs[5], None,
                                           chunk=C)
    finally:
        torch.Tensor.float = as_float


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", type=Path, nargs="+", default=[])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import ssd_scan_bwd as ssdb

    print(cs.card_line(), flush=True)
    build.build_all()
    print_spills("csrc", build.LOG.get("ssd_scan_bwd", ""))
    own = ssdb._fn(torch.bfloat16)
    variants = {str(p): load_variant(p) for p in args.variant}
    rows = []
    for name in args.shapes:
        case = SHAPES[name]
        B, T, H, hd, N, C = case
        ins, dy, _ = cs.ssd_bwd_inputs(torch, np, case, torch.bfloat16)
        _, _, states = ssd.ssd_scan_with_states(*ins, chunk=C)

        def kern():
            return ssdb.ssd_scan_bwd(*ins, states, dy, None, chunk=C)

        def other(fn):
            def call():
                ssdb._fns[torch.bfloat16] = fn
                try:
                    return kern()
                finally:
                    ssdb._fns[torch.bfloat16] = own
            return call
        nc = -(-T // C)
        b_ms, b_by = cs.bound(*cs.ssd_bwd_work(case), cs.BF16_FLOPS_PER_S)
        row = {"shape": name, "case": list(case), "bound_ms": b_ms,
               "bound_by": b_by, "device_ms": [],
               "variant_device_ms": {p: [] for p in variants},
               "smem_bytes": ssdb.smem_bytes(C, N, hd, False)}
        order = list(variants) + list(variants)[::-1]
        for _ in range(args.turns):
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
            for p in order:
                row["variant_device_ms"][p].append(
                    cs.device_ms(torch, other(variants[p]), args.reps))
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
        row["device_ms_by_launch"] = cs.launch_ms(torch, kern, "ssd_bwd_",
                                                  args.reps)
        row["variant_device_ms_by_launch"] = {
            p: cs.launch_ms(torch, other(fn), "ssd_bwd_", args.reps)
            for p, fn in variants.items()}
        row["max_abs_diff_vs_variant"] = {}
        for p, fn in variants.items():
            a, b = kern(), other(fn)()
            row["max_abs_diff_vs_variant"][p] = [
                float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b)]
        truth = float64_truth(torch, ref, (*ins, dy), C)
        got = {"kernel": kern(),
               "split_fp32": ref.ssd_scan_bwd_passes_ref(
                   *ins, states, dy, None, chunk=C)}
        got.update({p: other(fn)() for p, fn in variants.items()})
        row["max_abs_err_vs_float64"] = {
            k: [float((x.double() - t).abs().max())
                for x, t in zip(v, truth)] for k, v in got.items()}
        print(f"float64 {name}: max abs err (dxh, ddt, dA, dBm, dCm) "
              f"{row['max_abs_err_vs_float64']}", flush=True)
        del truth, got
        print(f"time {name} {case} (nc {nc}): kernel {row['device_ms']} ms, "
              f"variant {row['variant_device_ms']} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        for key, ms in row["device_ms_by_launch"].items():
            print(f"time {name} by launch: {ms} {key[:100]}", flush=True)
        for p, by in row["variant_device_ms_by_launch"].items():
            for key, ms in by.items():
                print(f"time {name} variant {p} by launch: {ms} {key[:100]}",
                      flush=True)
        rows.append(row)
        del ins, dy, states
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    print(json.dumps({"ssd_scan_bwd_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
