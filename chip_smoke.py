#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--pool 50000] [--max-iters 200]
                          [--serve-batch 8] [--prompt-len 2048] [--gen 32]

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds every kernel from ``src/repro_torch/kernels/csrc`` with nvcc (one
   nvcc per source, all started together), and counts the tensor-core
   (HMMA) instructions of ``flash_attention`` and ``ssd_scan`` in their
   SASS: none fails the run.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, the JAX package's test grids and the tile edges of
   the kernels, and after the main paths again at every shape they gave
   it; and the per-chunk states ``ssd_scan`` leaves in its scratch against
   the plain three-pass split (``ref.ssd_scan_passes_ref``).
4. Runs two MCAL campaigns through the port's entry points
   (``run_mcal(LiveTask(...))``), one with the margin M(.) and one with
   k-center, on ``make_classification(50_000, 10 classes, dim 32)`` — the
   data ``python -m repro.launch.label --live --pool 50000`` builds.  Each
   of the task's passes is timed up to a device synchronize, which gives
   the campaign's seconds by phase.
5. Serves zamba2-2.7b (full config: 54 layers, d_model 2560, bf16 weights
   from ``Model.init(seed 0)``) through ``ServeEngine``: 8 requests of
   2,048 random tokens are scored (``score``, the fp32 LM head through
   ``margin_head``), and 32 tokens are generated greedily; the first equals
   the argmax of the forward pass's last logits.  Prints init seconds,
   prefill tokens/s, decode tokens/s, score rows/s and peak device memory.
6. The kernels' launch counts are zeroed just before each main-path pass
   (each campaign; each serving pass) and read just after it; a kernel of
   a path that was never launched there fails the run.
7. Times each kernel at the largest shape the main paths gave it, its plain
   version and (where one PyTorch call computes the same function) that
   call, with CUDA events: the median of 30 single-call timings after a
   warm-up, host launch gaps included.  The profiler's CUDA trace gives the
   device time alone (``device_ms``, ``plain_device_ms``,
   ``library_device_ms``), summed over every launch whose name carries the
   kernel's prefix, and each launch's own (``ssd_scan``'s three passes,
   ``device_ms_by_launch``).  The bound is
   the larger of the bytes the function must move over 3.35 TB/s and its
   flops over the peak for the inputs' type: 67 TFLOP/s for fp32 (no
   tensor cores), 989 TFLOP/s for bf16 (tensor cores), H100 SXM
   data-sheet peaks.
8. Prints one ``{"kernels": [...]}`` line, the card's line again, and last
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
BF16_FLOPS_PER_S = 989e12


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


def device_ms(torch, fn, kernel: str, reps: int = 20, by_name=None):
    """Device time per call from the profiler's CUDA trace: the kernel's
    own time (names containing ``kernel``, which every launch of a
    multi-launch kernel shares as a prefix) and all device time (what the
    call's launches take on the card, host gaps excluded).  None where the
    trace holds no device events.  ``by_name``, a dict, collects the time
    per call of each of the kernel's launches by name."""
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
            if by_name is not None:
                by_name[e.key] = t / reps / 1e3
    if total == 0.0:
        return None, None
    return own / reps / 1e3, total / reps / 1e3


def tensor_core_instructions(nvcc: str, lib: Path) -> int:
    """How many HMMA (tensor-core) instructions the library's SASS holds,
    from the toolkit's cuobjdump beside nvcc; -1 where it is missing."""
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.exists():
        return -1
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the campaigns' shape, the JAX package's test grid, and the zamba2-2.7b
# LM head at 8 and 64 requests
MARGIN_GRID = [(2048, 64, 10), (128, 64, 512), (200, 48, 1000),
               (65, 32, 257), (256, 128, 4096), (8, 2560, 32000),
               (64, 2560, 32000)]


def check_margin_head(torch, np, mh, ref, cases, bf16=True):
    """Kernel vs plain at each (T, D, V), fp32 (and bf16); returns the max
    abs error in fp32."""
    rng = np.random.default_rng(0)
    worst = 0.0
    dtypes = [(torch.float32, 5e-5)] + ([(torch.bfloat16, 5e-2)] if bf16
                                        else [])
    for T, D, V in cases:
        h32 = rng.normal(size=(T, D)).astype(np.float32)
        w32 = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
        for dtype, tol in dtypes:
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


# the JAX package's grid (tests/test_kernels.py:40-46), a window without
# causal, zamba2-2.7b's serving shape, and the tile edges of the kernel: Tq
# and Tk off its 128-row query and 64-key tiles, GQA group 4, windows that
# cross a tile border, hd 8 padded to the mma's k = 16: (B, H, Hk, Tq, Tk,
# hd, causal, window)
FLASH_GRID = [(2, 4, 2, 128, 128, 32, True, 0), (1, 4, 4, 96, 96, 16, True, 0),
              (2, 8, 2, 64, 64, 32, True, 24),
              (1, 2, 1, 50, 130, 16, False, 0), (1, 6, 3, 33, 77, 8, True, 0),
              (1, 2, 1, 70, 70, 16, False, 24),
              (8, 32, 32, 2048, 2048, 80, True, 0),
              (1, 4, 1, 129, 129, 80, True, 0),
              (2, 8, 2, 200, 333, 16, True, 0),
              (2, 8, 2, 200, 333, 16, False, 0),
              (1, 8, 2, 256, 256, 80, True, 0),
              (1, 4, 2, 300, 300, 32, True, 100),
              (1, 2, 1, 190, 190, 80, False, 70),
              (2, 4, 2, 150, 150, 8, True, 0)]


def flash_inputs(torch, np, case, dtype, seed=3):
    B, H, Hk, Tq, Tk, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device="cuda").to(dtype)
            for s in ((B, H, Tq, hd), (B, Hk, Tk, hd), (B, Hk, Tk, hd))]


def check_flash(torch, np, fa, ref, cases):
    """Kernel vs plain at each case, fp32 (atol = rtol = 5e-4) and bf16
    (3e-2), the JAX package's tolerances; returns the max abs error in
    bf16, the serving dtype."""
    worst = 0.0
    for case in cases:
        causal, window = case[6], case[7]
        for dtype, tol in ((torch.float32, 5e-4), (torch.bfloat16, 3e-2)):
            q, k, v = flash_inputs(torch, np, case, dtype)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            g, r = got.float(), want.float()
            err = float((g - r).abs().max())
            if got.dtype != dtype or got.shape != want.shape or \
                    not bool(((g - r).abs() <= tol + tol * r.abs()).all()):
                fail(f"flash_attention at {case} {dtype}: err {err} beyond "
                     f"atol = rtol = {tol}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            print(f"flash_attention {case} {str(dtype)[6:]}: max abs err "
                  f"{err:.3g} ok", flush=True)
            del q, k, v, got, want, g, r
    return worst


# the JAX package's grid (tests/test_kernels.py:61-66), zamba2-2.7b's
# serving shape, and the edges of the kernel's split: T off the chunk, one
# chunk (C = T = 100), H off its group of 8 heads: (B, T, H, hd, N, chunk)
SSD_GRID = [(2, 128, 4, 16, 32, 64), (1, 96, 2, 8, 16, 32),
            (2, 64, 8, 32, 64, 64), (1, 256, 4, 64, 128, 128),
            (8, 2048, 80, 64, 64, 128), (2, 300, 4, 32, 64, 128),
            (2, 100, 5, 16, 32, 128), (1, 256, 12, 64, 64, 64)]


def ssd_inputs(torch, np, case, dtype, seed=4):
    B, T, H, hd, N = case[:5]
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device="cuda")
    return (t(rng.normal(size=(B, T, H, hd))).to(dtype),
            t(np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.01),
            t(np.abs(rng.normal(size=(H,))) * 0.5 + 0.1),
            t(rng.normal(size=(B, T, N))), t(rng.normal(size=(B, T, N))))


def check_ssd(torch, np, ssd, ref, cases):
    """Kernel vs plain at each case with xh in fp32 and in bf16: the JAX
    package's 2e-3 (atol = rtol), and for bf16 y an rtol of 2e-3 + 2^-7,
    since both round y from fp32 to bf16 and fp32 sums taken in another
    order can round it one bf16 step (2^-7 relative) apart; the state is
    fp32 either way.  Returns the max abs error of y in bf16, the serving
    dtype."""
    worst = 0.0
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(torch, np, case, dtype)
            y, h = ssd.ssd_scan(*ins, chunk=case[5])
            yr, hr = ref.ssd_scan_ref(*ins, chunk=case[5])
            torch.cuda.synchronize()
            rtol = 2e-3 if dtype == torch.float32 else 2e-3 + 2 ** -7
            err = float((y.float() - yr.float()).abs().max())
            herr = float((h - hr).abs().max())
            if y.dtype != dtype or h.dtype != torch.float32 or \
                    not bool(((y.float() - yr.float()).abs()
                              <= 2e-3 + rtol * yr.float().abs()).all()) or \
                    not bool(((h - hr).abs() <= 2e-3 + 2e-3 * hr.abs()).all()):
                fail(f"ssd_scan at {case} {dtype}: y err {err}, state err "
                     f"{herr}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            print(f"ssd_scan {case} {str(dtype)[6:]}: max abs err y {err:.3g}"
                  f" state {herr:.3g} ok", flush=True)
            del ins, y, h, yr, hr
    return worst


def check_ssd_states(torch, np, ssd, ref, case):
    """The state each chunk starts from, which the kernel's inter-chunk
    pass leaves in its scratch, against the plain three-pass split
    (``ref.ssd_scan_passes_ref``) at the state's tolerance, 2e-3."""
    ins = ssd_inputs(torch, np, case, torch.bfloat16)
    _, _, h_in = ssd.ssd_scan_with_states(*ins, chunk=case[5])
    _, _, h_in_r = ref.ssd_scan_passes_ref(*ins, chunk=case[5])
    torch.cuda.synchronize()
    err = float((h_in - h_in_r).abs().max())
    if h_in.shape != h_in_r.shape or \
            not bool(((h_in - h_in_r).abs() <= 2e-3 + 2e-3 * h_in_r.abs())
                     .all()):
        fail(f"ssd_scan chunk states at {case}: err {err}")
    print(f"ssd_scan chunk states {case} {tuple(h_in.shape)}: max abs err "
          f"{err:.3g} ok", flush=True)


def record_shapes(mod, name: str, seen: set, key):
    """Wrap the kernel wrapper ``mod.<name>`` (which ``kernels.ops`` looks
    up at each call) so every call adds ``key(*args, **kw)`` to ``seen``;
    returns a function that restores it."""
    fn = getattr(mod, name)

    def wrapped(*args, **kw):
        seen.add(key(*args, **kw))
        return fn(*args, **kw)
    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, fn)


def margin_key(h, w):
    return (h.shape[0], h.shape[1], w.shape[1])


def pairwise_key(x, c):
    return (x.shape[0], c.shape[0], x.shape[1])


def flash_key(q, k, v, *, causal=True, window=0, scale=None):
    B, H, Tq, hd = q.shape
    return (B, H, k.shape[1], Tq, k.shape[2], hd, bool(causal), int(window))


def ssd_key(xh, dt, A, Bm, Cm, *, chunk=128):
    B, T, H, hd = xh.shape
    return (B, T, H, hd, Bm.shape[-1], chunk)


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
    restore = [record_shapes(mh, "margin_head", seen["margin_head"],
                             margin_key),
               record_shapes(pd, "pairwise_sqdist", seen["pairwise_sqdist"],
                             pairwise_key)]
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


def run_serving(torch, np, mods, batch: int, prompt_len: int, gen: int,
                seen: dict):
    """zamba2-2.7b, full config, bf16, through ServeEngine; returns the
    serving path's launch counts.  ``seen`` collects kernel shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("zamba2-2.7b")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"serve init seconds: {model.init_seconds:.3f} ({n_params:,} "
          f"params, {cfg.num_layers} layers, d_model {cfg.d_model})",
          flush=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    engine = ServeEngine(model, params, max_seq=prompt_len + gen + 8,
                         batch_size=batch, device="cuda")
    per_pass = {"flash_attention": cfg.num_layers // cfg.shared_attn_every,
                "ssd_scan": cfg.num_layers}
    restore = [record_shapes(mods["margin_head"], "margin_head",
                             seen["margin_head"], margin_key),
               record_shapes(mods["flash_attention"], "flash_attention",
                             seen["flash_attention"], flash_key),
               record_shapes(mods["ssd_scan"], "ssd_scan", seen["ssd_scan"],
                             ssd_key)]
    total = dict.fromkeys(mods, 0)

    def counted(label, fn, want):
        """Run one pass with the counts zeroed just before and read just
        after; ``want`` is the exact count of each kernel it must launch."""
        torch.cuda.synchronize()
        for m in mods.values():
            m.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: m.launches for k, m in mods.items()}
        for k, v in got.items():
            total[k] += v
        print(f"serve {label}: {secs:.3f} s, launches {got}", flush=True)
        for k, n in want.items():
            if got[k] != n:
                fail(f"serve {label}: {k} launched {got[k]} times, want {n}")
        return out, secs

    hidden, _ = counted("forward", lambda: model.forward(
        params, {"tokens": torch.as_tensor(tokens, device="cuda")}),
        dict(per_pass, margin_head=0))
    last = model.logits(params, hidden[:, -1:, :])
    want_first = torch.argmax(last[:, -1, :], dim=-1).to(torch.int32)
    if hidden.shape != (batch, prompt_len, cfg.d_model) or \
            not bool(torch.isfinite(hidden).all()):
        fail(f"serve forward: hidden {tuple(hidden.shape)} not finite")
    del hidden

    stats, secs = counted("score", lambda: engine.score({"tokens": tokens}),
                          dict(per_pass, margin_head=1))
    print(f"serve score rows/s: {batch / secs:.3f}", flush=True)
    if not all(bool(torch.isfinite(a).all()) for a in stats[:3]) or \
            not bool(((stats.top1 >= 0) & (stats.top1 < cfg.vocab_size))
                     .all()) or stats.margin.shape != (batch,):
        fail(f"serve score: bad stats {stats}")
    print(f"serve score margin {stats.margin.tolist()} top1 "
          f"{stats.top1.tolist()}", flush=True)

    (_, cache, _), secs = counted(
        "prefill", lambda: engine.prefill({"tokens": tokens}),
        dict(per_pass, margin_head=0))
    print(f"serve prefill tokens/s: {batch * prompt_len / secs:.1f}",
          flush=True)
    del cache

    decode_s = []
    step = engine.decode

    def timed_decode(*args):
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out
    engine.decode = timed_decode
    out, secs = counted("generate", lambda: engine.generate(
        {"tokens": tokens}, gen), dict(per_pass, margin_head=0))
    engine.decode = step
    print(f"serve decode tokens/s: {batch * len(decode_s) / sum(decode_s):.1f}"
          f" ({len(decode_s)} steps of {batch} rows)", flush=True)
    print(f"serve max_memory_allocated bytes: "
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    if out.shape != (batch, gen) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"serve generate: bad tokens {tuple(out.shape)}")
    if not torch.equal(out[:, 0], want_first):
        fail(f"serve generate: first tokens {out[:, 0].tolist()} differ from "
             f"the forward pass's argmax {want_first.tolist()}")
    print(f"serve generated {tuple(out.shape)}, first tokens "
          f"{out[:, 0].tolist()} equal the forward argmax", flush=True)
    for r in restore:
        r()
    # where the time goes: one forward pass and one decode step, profiled
    # outside the counted passes
    batch_t = {"tokens": torch.as_tensor(tokens, device="cuda")}
    profile_pass(torch, "forward", lambda: model.forward(params, batch_t))
    logits, cache, pos = engine.prefill({"tokens": tokens})
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    profile_pass(torch, "decode step",
                 lambda: engine.decode(cache, tok, pos))
    del params, engine, cache
    torch.cuda.empty_cache()
    return total


def profile_pass(torch, label: str, fn, top: int = 10):
    """Where one pass's time goes: the profiler's device time by kernel
    name, and the device's busy share of the pass's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"serve {label} profile: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall (idle share {1 - busy / wall:.4f} under the "
          f"profiler), {sum(r[1] for r in rows)} device events", flush=True)
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        print(f"serve {label} profile: {ms:10.3f} ms "
              f"{100 * ms / max(busy, 1e-9):6.2f}% x{n:<5d} {key[:90]}",
              flush=True)


def timing_row(torch, name, shape, kern, plain, library, nbytes, flops,
               peak, own):
    b_ms, b_by = bound(nbytes, flops, peak)
    passes = {}
    row = {"name": name, "shape": list(shape),
           "ms": median_ms(torch, kern), "plain_ms": median_ms(torch, plain),
           "library_ms": None if library is None
           else median_ms(torch, library),
           "bound_ms": b_ms, "bound_by": b_by,
           "device_ms": device_ms(torch, kern, own, by_name=passes)[0],
           "plain_device_ms": device_ms(torch, plain, own)[1],
           "library_device_ms": None if library is None
           else device_ms(torch, library, own)[1]}
    print(f"time {name} {row['shape']}: kernel {row['ms']:.4f} ms "
          f"(device {row['device_ms']}), plain {row['plain_ms']:.4f} ms "
          f"(device {row['plain_device_ms']}), library {row['library_ms']} "
          f"ms (device {row['library_device_ms']}), bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    row["device_ms_by_launch"] = passes
    for key, ms in passes.items():
        print(f"time {name} {row['shape']} device ms by launch: {ms:.6f} "
              f"{key[:100]}", flush=True)
    return row


def time_kernels(torch, np, mods, ref, shapes):
    """Each kernel at its largest main-path shape."""
    rng = np.random.default_rng(2)
    mh, pd, fa, ssd = (mods[k] for k in ("margin_head", "pairwise_sqdist",
                                         "flash_attention", "ssd_scan"))
    rows = []
    for T, D, V in shapes["margin_head"]:
        h = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32),
                            device="cuda")
        w = torch.as_tensor((rng.normal(size=(D, V)) * 0.1)
                            .astype(np.float32), device="cuda")
        # fp32 in, 4 fp32 outputs per row; the product and ~6 flops per
        # logit for the online statistics
        rows.append(timing_row(
            torch, "margin_head", (T, D, V), lambda: mh.margin_head(h, w),
            lambda: ref.margin_head_ref(h, w), None,
            4 * (T * D + D * V) + 16 * T, 2 * T * D * V + 6 * T * V,
            FP32_FLOPS_PER_S, "margin_head_kernel"))
        del h, w
    N, M, D = shapes["pairwise_sqdist"]
    x = torch.as_tensor(rng.normal(size=(N, D)).astype(np.float32),
                        device="cuda")
    c = torch.as_tensor(rng.normal(size=(M, D)).astype(np.float32),
                        device="cuda")
    rows.append(timing_row(
        torch, "pairwise_sqdist", (N, M, D), lambda: pd.pairwise_sqdist(x, c),
        lambda: ref.pairwise_sqdist_ref(x, c),
        lambda: torch.cdist(x, c).square(),
        4 * (N * D + M * D + N * M),
        2 * N * M * D + 2 * (N + M) * D + 3 * N * M, FP32_FLOPS_PER_S,
        "pairwise_sqdist_kernel"))
    del x, c
    case = shapes["flash_attention"]
    B, H, Hk, Tq, Tk, hd, causal, window = case
    q, k, v = flash_inputs(torch, np, case, torch.bfloat16)
    # visible (query, key) pairs of this mask; 4 hd flops each (QK^T, PV)
    qp = np.arange(Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    vis = np.ones((Tq, Tk), bool)
    if causal:
        vis &= qp >= kp
    if window > 0:
        vis &= (qp - kp) < window
    pairs = B * H * int(vis.sum())
    rows.append(timing_row(
        torch, "flash_attention", case,
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window),
        (lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)) if causal and not window and H == Hk
        else None,
        2 * (2 * B * H * Tq * hd + 2 * B * Hk * Tk * hd), 4 * hd * pairs,
        BF16_FLOPS_PER_S, "flash_attention_"))
    del q, k, v
    case = shapes["ssd_scan"]
    B, T, H, hd, N, C = case
    ins = ssd_inputs(torch, np, case, torch.bfloat16)
    C = min(C, T)
    nc = -(-T // C)
    # xh and y bf16; dt, B, C and the final state fp32.  Flops: C.B^T per
    # (batch, chunk); per (batch, chunk, head) the lower-triangle intra
    # term (C (C+1)/2 * hd FMAs), the chunk summary and the inter term
    # (C hd N FMAs each)
    nbytes = 2 * 2 * B * T * H * hd + 4 * (B * T * H + H + 2 * B * T * N
                                           + B * H * hd * N)
    flops = B * nc * (2 * C * C * N + H * (C * (C + 1) * hd
                                          + 4 * C * hd * N))
    rows.append(timing_row(
        torch, "ssd_scan", case, lambda: ssd.ssd_scan(*ins, chunk=C),
        lambda: ref.ssd_scan_ref(*ins, chunk=C), None, nbytes, flops,
        BF16_FLOPS_PER_S, "ssd_scan_"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", type=int, default=50_000)
    ap.add_argument("--max-iters", type=int, default=200)
    ap.add_argument("--serve-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=32)
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
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import margin_head as mh
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.serving import engine  # noqa: F401 (the serving path)
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules) or "repro" in sys.modules:
        fail("JAX or the JAX package was imported")
    mods = {"margin_head": mh, "pairwise_sqdist": pd, "flash_attention": fa,
            "ssd_scan": ssd}

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
    # the redesigned kernels run on tensor cores: their SASS holds HMMA
    for name in ("flash_attention", "ssd_scan"):
        n = tensor_core_instructions(build.nvcc(), libs[name])
        print(f"sass {name}: {n} HMMA instructions"
              + (" (cuobjdump not found: not measured)" if n < 0 else ""),
              flush=True)
        if n == 0:
            fail(f"{name} compiled to no tensor-core instruction")

    check_margin_head(torch, np, mh, ref, MARGIN_GRID[:5])
    check_margin_head(torch, np, mh, ref, MARGIN_GRID[5:], bf16=False)
    check_pairwise(torch, np, pd, ref, PAIRWISE_GRID, PAIRWISE_INT_GRID)
    check_flash(torch, np, fa, ref, FLASH_GRID)
    check_ssd(torch, np, ssd, ref, SSD_GRID)
    check_ssd_states(torch, np, ssd, ref, SSD_GRID[4])

    # the shapes each main path gave each kernel
    seen_by = {p: {k: set() for k in mods} for p in ("campaigns", "serving")}
    launches = run_campaigns(torch, np, mh, pd, args.pool, args.max_iters,
                             seen_by["campaigns"])
    served = run_serving(torch, np, mods, args.serve_batch, args.prompt_len,
                         args.gen, seen_by["serving"])
    by_path = {k: {"campaigns": launches.get(k, 0), "serving": served[k]}
               for k in mods}
    seen = {k: seen_by["campaigns"][k] | seen_by["serving"][k] for k in mods}
    # every shape the main paths gave a kernel, held against the plain
    # version again; max_abs_err is the worst of these
    for name, shapes in seen.items():
        print(f"main-path shapes of {name}: {sorted(shapes)}", flush=True)
        if not shapes:
            fail(f"{name} was given no shape on the main paths")
    errs = {"margin_head": check_margin_head(
                torch, np, mh, ref, sorted(seen["margin_head"])),
            "pairwise_sqdist": check_pairwise(
                torch, np, pd, ref, sorted(seen["pairwise_sqdist"])),
            "flash_attention": check_flash(
                torch, np, fa, ref, sorted(seen["flash_attention"])),
            "ssd_scan": check_ssd(torch, np, ssd, ref,
                                  sorted(seen["ssd_scan"]))}
    # timed at the largest main-path shape of each (margin_head at the
    # largest of each path: the campaigns' and the LM head's, that last)
    rows = time_kernels(torch, np, mods, ref, {
        "margin_head": [max(seen_by[p]["margin_head"],
                            key=lambda s: (s[0] * s[2], s))
                        for p in ("campaigns", "serving")],
        "pairwise_sqdist": max(seen["pairwise_sqdist"],
                               key=lambda s: (s[0] * s[1], s)),
        "flash_attention": max(seen["flash_attention"],
                               key=lambda s: (s[0] * s[1] * s[3] * s[4], s)),
        "ssd_scan": max(seen["ssd_scan"],
                        key=lambda s: (s[0] * s[1] * s[2], s))})

    meta = {
        "margin_head": ("src/repro_torch/kernels/csrc/margin_head.cu",
                        "src/repro/kernels/margin_head.py:81"),
        "pairwise_sqdist": ("src/repro_torch/kernels/csrc/pairwise_dist.cu",
                            "src/repro/kernels/pairwise_dist.py:49"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:69"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:86"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["name"] == name]
        r = mine[-1]   # the largest shape
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r["library_device_ms"],
            "device_ms_by_launch": r["device_ms_by_launch"],
            "shape": r["shape"],
            "other_shapes": [{k: o[k] for k in ("shape", "ms", "device_ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")}
                             for o in mine[:-1]]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
