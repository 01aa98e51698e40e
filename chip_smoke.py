#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--pool 50000] [--max-iters 200]

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds every kernel from ``src/repro_torch/kernels/csrc`` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and the JAX package's test grids, and after the
   campaigns again at every shape the campaigns gave it.
4. Times each kernel at the largest shape the campaigns gave it, its
   plain version and (where one PyTorch call computes the same function)
   that call, with CUDA events: the median of
   30 single-call timings after a warm-up, host launch gaps included.  The
   profiler's CUDA trace gives the device time alone (``device_ms``,
   ``plain_device_ms``).  The bound is the larger of the
   bytes the function must move over 3.35 TB/s and its flops over the
   67 TFLOP/s fp32 (non-tensor-core) rate, both H100 SXM data-sheet peaks.
5. Runs two MCAL campaigns through the port's entry points
   (``run_mcal(LiveTask(...))``), one with the margin M(.) and one with
   k-center, on ``make_classification(50_000, 10 classes, dim 32)`` — the
   data ``python -m repro.launch.label --live --pool 50000`` builds.  The
   kernels' launch counts are zeroed just before each campaign and read
   just after it; each of the task's passes is timed up to a device
   synchronize, which gives the campaign's seconds by phase.
6. Prints one ``{"kernels": [...]}`` line, the card's line again, and last
   ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
   before a result is printed.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, reps: int = 20):
    """Device time per call from the profiler's CUDA trace: the kernel's
    own time (names containing ``kernel``) and all device time (what the
    call's launches take on the card, host gaps excluded).  None where the
    trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += t
        if kernel in e.key:
            own += t
    if total == 0.0:
        return None, None
    return own / reps / 1e3, total / reps / 1e3


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


MARGIN_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000),
               (65, 32, 257), (256, 128, 4096)]


def check_margin_head(torch, np, mh, ref, cases):
    """Kernel vs plain at each (T, D, V), fp32 and bf16; returns the max
    abs error in fp32."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for T, D, V in cases:
        h32 = rng.normal(size=(T, D)).astype(np.float32)
        w32 = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 5e-2)):
            h = torch.as_tensor(h32, device="cuda").to(dtype)
            w = torch.as_tensor(w32, device="cuda").to(dtype)
            got = mh.margin_head(h, w)
            want = ref.margin_head_ref(h, w)
            torch.cuda.synchronize()
            errs = [float((g - r).abs().max()) for g, r in zip(got[:3],
                                                               want[:3])]
            # the JAX package's test tolerances (assert_allclose with
            # atol = rtol = tol; entropy 10x)
            for name, g, r, lim in zip(("margin", "entropy", "max_logprob"),
                                       got, want, (tol, tol * 10, tol)):
                if not bool(((g - r).abs() <= lim + lim * r.abs()).all()):
                    fail(f"margin_head {name} at {(T, D, V)} {dtype}: "
                         f"beyond atol = rtol = {lim}")
            if dtype == torch.float32:
                if not torch.equal(got[3], want[3]):
                    fail(f"margin_head top1 differs at {(T, D, V)}")
                worst = max(worst, *errs)
            print(f"margin_head {(T, D, V)} {str(dtype)[6:]}: max abs err "
                  f"margin {errs[0]:.3g} entropy {errs[1]:.3g} "
                  f"max_logprob {errs[2]:.3g} ok", flush=True)
    return worst


# N = the padded k-center pool of a 50,000-row campaign; M = pow2(|B|)
# for |B| up to 4,096 anchors
PAIRWISE_GRID = [(65536, m, 64) for m in (512, 1024, 2048, 4096)] + [
    (130, 9, 33)]
PAIRWISE_INT_GRID = [(1025, 17, 32), (300, 8, 2), (4099, 513, 64)]


def check_pairwise(torch, np, pd, ref, cases, int_cases=()):
    """Kernel vs plain at each (N, M, D) on normal inputs (atol 1e-4 *
    max(d)), and exactly on integer-valued inputs; returns the max abs
    error on the normal inputs."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for N, M, D in cases:
        x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                            device="cuda")
        c = torch.as_tensor(rng.normal(size=(M, D)).astype(np.float32),
                            device="cuda")
        got, want = pd.pairwise_sqdist(x, c), ref.pairwise_sqdist_ref(x, c)
        err = float((got - want).abs().max())
        lim = 1e-4 * float(want.max())
        if got.shape != (N, M) or not err <= lim or bool((got < 0).any()):
            fail(f"pairwise_sqdist at {(N, M, D)}: err {err} > {lim}")
        worst = max(worst, err)
        del got, want
        print(f"pairwise_sqdist {(N, M, D)}: max abs err {err:.3g} "
              f"(limit {lim:.3g}) ok", flush=True)
    for N, M, D in int_cases:
        x = torch.as_tensor(rng.integers(0, 8, size=(N, D)).astype(
            np.float32), device="cuda")
        c = torch.as_tensor(rng.integers(0, 8, size=(M, D)).astype(
            np.float32), device="cuda")
        if not torch.equal(pd.pairwise_sqdist(x, c),
                           ref.pairwise_sqdist_ref(x, c)):
            fail(f"pairwise_sqdist not exact on the integer grid {(N, M, D)}")
        print(f"pairwise_sqdist integer grid {(N, M, D)}: exact ok",
              flush=True)
    return worst


def record_shapes(mod, name: str, seen: set):
    """Wrap the kernel wrapper ``mod.<name>`` (which ``kernels.ops`` looks
    up at each call) so every call adds its inputs' (rows, D, cols) to
    ``seen``; returns a function that restores it."""
    fn = getattr(mod, name)

    def wrapped(a, b):
        if name == "margin_head":
            seen.add((a.shape[0], a.shape[1], b.shape[1]))
        else:
            seen.add((a.shape[0], b.shape[0], a.shape[1]))
        return fn(a, b)
    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, fn)


def time_kernels(torch, np, mh, pd, ref, mh_shape, pd_shape):
    rng = np.random.default_rng(2)
    rows = []
    T, D, V = mh_shape
    h = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32),
                        device="cuda")
    w = torch.as_tensor((rng.normal(size=(D, V)) * 0.1).astype(np.float32),
                        device="cuda")
    b_ms, b_by = bound(4 * (T * D + D * V) + 16 * T,
                       2 * T * D * V + 6 * T * V)
    rows.append({"name": "margin_head",
                 "ms": median_ms(torch, lambda: mh.margin_head(h, w)),
                 "plain_ms": median_ms(torch,
                                       lambda: ref.margin_head_ref(h, w)),
                 "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                 "shape": [T, D, V]})
    N, M, D = pd_shape
    x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device="cuda")
    c = torch.as_tensor(rng.normal(size=(M, D)).astype(np.float32),
                        device="cuda")
    b_ms, b_by = bound(4 * (N * D + M * D + N * M),
                       2 * N * M * D + 2 * (N + M) * D + 3 * N * M)
    rows.append({"name": "pairwise_sqdist",
                 "ms": median_ms(torch, lambda: pd.pairwise_sqdist(x, c)),
                 "plain_ms": median_ms(torch,
                                       lambda: ref.pairwise_sqdist_ref(x, c)),
                 "library_ms": median_ms(
                     torch, lambda: torch.cdist(x, c).square()),
                 "bound_ms": b_ms, "bound_by": b_by, "shape": [N, M, D]})
    dev = {"margin_head": (lambda: mh.margin_head(h, w),
                           lambda: ref.margin_head_ref(h, w),
                           "margin_head_kernel"),
           "pairwise_sqdist": (lambda: pd.pairwise_sqdist(x, c),
                               lambda: ref.pairwise_sqdist_ref(x, c),
                               "pairwise_sqdist_kernel")}
    for r in rows:
        kern, plain, name = dev[r["name"]]
        r["device_ms"] = device_ms(torch, kern, name)[0]
        r["plain_device_ms"] = device_ms(torch, plain, name)[1]
        print(f"profiler {r['name']}: kernel {r['device_ms']} ms, plain "
              f"{r['plain_device_ms']} ms of device time per call",
              flush=True)
    for r in rows:
        print(f"time {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return rows


PHASES = ("train", "score", "eval_correct", "topk_candidates",
          "kcenter_candidates", "anchor_features", "machine_label_sweep")


def time_phases(torch, task):
    """Wrap the task's passes so each call's wall time, up to a device
    synchronize, adds to its phase: the campaign's breakdown."""
    spent = dict.fromkeys(PHASES, 0.0)
    for name in PHASES:
        def timed(*args, _fn=getattr(task, name), _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            spent[_name] += time.perf_counter() - t0
            return out
        setattr(task, name, timed)
    return spent


def run_campaigns(torch, np, mh, pd, pool: int, max_iters: int,
                  seen: dict):
    """Both campaigns; ``seen`` collects the shapes each kernel was given."""
    from repro_torch.core import AMAZON, LiveTask, MCALConfig, run_mcal
    from repro_torch.data.synth import make_classification

    x, y = make_classification(pool, num_classes=10, dim=32,
                               difficulty=0.3, seed=0)
    eps = 0.05
    launches = {"margin_head": 0, "pairwise_sqdist": 0}
    restore = [record_shapes(mh, "margin_head", seen["margin_head"]),
               record_shapes(pd, "pairwise_sqdist", seen["pairwise_sqdist"])]
    for metric in ("margin", "kcenter"):
        task = LiveTask(features=x, groundtruth=y, num_classes=10)
        spent = time_phases(torch, task)
        cfg = MCALConfig(eps_target=eps, seed=0, metric=metric,
                         max_iters=max_iters)
        torch.cuda.synchronize()
        mh.launches = 0
        pd.launches = 0
        t0 = time.perf_counter()
        res = run_mcal(task, AMAZON, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"margin_head": mh.launches, "pairwise_sqdist": pd.launches}
        for k, v in got.items():
            launches[k] += v
        print(f"campaign metric={metric} pool={pool} max_iters={max_iters}: "
              f"decision {res.decision}, |B| {res.B_size}, |S| {res.S_size}, "
              f"cost {res.total_cost:.2f}, measured error "
              f"{res.measured_error:.5f}, iterations {len(res.history)}, "
              f"wall {wall:.2f} s, launches {got}", flush=True)
        print(f"campaign metric={metric} seconds by phase: "
              + ", ".join(f"{k} {v:.3f}" for k, v in spent.items() if v)
              + f", rest {wall - sum(spent.values()):.3f}", flush=True)
        if res.labels.shape != (pool,) or (res.labels < 0).any():
            fail(f"{metric} campaign left rows unlabeled")
        if not res.measured_error <= eps + 0.01:
            fail(f"{metric} campaign error {res.measured_error} > "
                 f"{eps + 0.01}")
        if got["margin_head"] == 0:
            fail(f"margin_head never launched in the {metric} campaign")
        if metric == "kcenter" and got["pairwise_sqdist"] == 0:
            fail("pairwise_sqdist never launched in the k-center campaign")
    for r in restore:
        r()
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=50_000)
    ap.add_argument("--max-iters", type=int, default=200)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"the port is not here ({e})")
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        fail(f"imported the port from {repro_torch.__file__}, not {ROOT}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules) or "repro" in sys.modules:
        fail("JAX or the JAX package was imported")
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import margin_head as mh
    from repro_torch.kernels import pairwise_dist as pd

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    check_margin_head(torch, np, mh, ref, MARGIN_GRID)
    check_pairwise(torch, np, pd, ref, PAIRWISE_GRID, PAIRWISE_INT_GRID)
    seen = {"margin_head": set(), "pairwise_sqdist": set()}
    launches = run_campaigns(torch, np, mh, pd, args.pool, args.max_iters,
                             seen)
    # every shape the campaigns gave a kernel, held against the plain
    # version again; max_abs_err is the worst of these
    for name, shapes in seen.items():
        print(f"main-path shapes of {name}: {sorted(shapes)}", flush=True)
    errs = {"margin_head": check_margin_head(
                torch, np, mh, ref, sorted(seen["margin_head"])),
            "pairwise_sqdist": check_pairwise(
                torch, np, pd, ref, sorted(seen["pairwise_sqdist"]))}
    # timed at the largest main-path shape of each
    rows = time_kernels(
        torch, np, mh, pd, ref,
        max(seen["margin_head"], key=lambda s: (s[0] * s[2], s)),
        max(seen["pairwise_sqdist"], key=lambda s: (s[0] * s[1], s)))

    meta = {
        "margin_head": ("src/repro_torch/kernels/csrc/margin_head.cu",
                        "src/repro/kernels/margin_head.py:81"),
        "pairwise_sqdist": ("src/repro_torch/kernels/csrc/pairwise_dist.cu",
                            "src/repro/kernels/pairwise_dist.py:49"),
    }
    kernels = []
    for r in rows:
        source, replaces = meta[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[r["name"]],
            "max_abs_err": errs[r["name"]], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
