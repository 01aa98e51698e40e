#!/usr/bin/env python3
"""Time the attention backward kernel against another build of it, in turns
on one card.

    python3 tools/time_attention_bwd.py [--variant build/other_bwd.cu ...]
                                        [--shapes qwen2 whisper_enc ...]
                                        [--reps 20] [--turns 2]

At each shape (bf16, inputs from a seed, the forward kernel's output and
log-sum-exp; the training paths' shapes, and gemma3-4b's halo frame, whose
2,048 queries sit at offset 1,024 over 3,072 keys with the first 1,024
hidden): ``flash_attention_bwd`` as built from ``csrc/``, each
``--variant`` source (a ``flash_attention_bwd.cu`` of the same C
interface, e.g. an earlier commit's, compiled with the same nvcc flags and
``csrc/`` on the include path), and the backward of
``scaled_dot_product_attention`` (``enable_gqa``; an explicit boolean mask
for a window or a shifted frame).  A variant from before
the mask's ``q_offset`` / ``kv_start`` (two mask ints in its C interface)
is called with the two dropped (give it no shifted shape).  Device ms:
``--reps``
calls queued back to back between two CUDA events (``chip_smoke.device_ms``),
taken in turns: the kernel, the variants in order, again in reverse, the
kernel, ``--turns`` times; the profiler's device time per launch name of
the kernel; the bound (``chip_smoke``'s: 2.5 times the forward's
operations at the bf16 peak, or the bytes); and the largest difference
between the gradients of the kernel and of each variant.  Prints the
card's line and one JSON line.  Needs a CUDA device.

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

# (B, H, Hk, Tq, Tk, hd, causal, window[, q_offset, kv_start]): the
# training paths' shapes (gemma3-4b's local and global layers at hd 256),
# and gemma3-4b's halo frame (chip_smoke.FLASH_HALO)
SHAPES = {"qwen2": (8, 12, 2, 2048, 2048, 128, True, 0),
          "whisper_enc": (8, 6, 6, 1500, 1500, 64, False, 0),
          "whisper_dec": (8, 6, 6, 448, 448, 64, True, 0),
          "whisper_cross": (8, 6, 6, 448, 1500, 64, False, 0),
          "zamba2": (8, 32, 32, 2048, 2048, 80, True, 0),
          "gemma3_local": (8, 8, 4, 2048, 2048, 256, True, 1024),
          "gemma3_global": (8, 8, 4, 2048, 2048, 256, True, 0),
          "gemma3_halo": (8, 8, 4, 2048, 3072, 256, True, 1024, 1024, 1024)}


def load_variant(path: Path, symbol: str = "flash_attention_bwd_bf16",
                 pointers: int = 11):
    """The variant source's ``symbol`` (a bf16 entry point with
    ``pointers`` pointer arguments), called as the wrapper calls its own
    (an entry point without ``q_offset`` and ``kv_start`` gets them
    dropped)."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT / "variants" / f"lib{path.stem}.{symbol}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.FLAGS, "-I", str(build.CSRC),
                           "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    masks = 4 if "int q_offset" in path.read_text() else 2
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * masks
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if masks == 4:
        return fn
    return lambda *args: fn(*args[:-3], args[-1])


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
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    print(cs.card_line(), flush=True)
    build.build_all()
    own = fab._fn(torch.bfloat16)
    variants = {str(p): load_variant(p) for p in args.variant}
    rows = []
    for name in args.shapes:
        case = SHAPES[name]
        B, H, Hk, Tq, Tk, hd, causal = case[:7]
        mask = cs.mask_of(case)
        q, k, v = cs.flash_inputs(torch, np, case, torch.bfloat16)
        dout = cs.flash_inputs(torch, np, case, torch.bfloat16, seed=5)[0]
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **mask)

        def kern():
            return fab.flash_attention_bwd(q, k, v, out, dout, lse, **mask)

        def other(fn):
            def call():
                fab._fns[torch.bfloat16] = fn
                try:
                    return kern()
                finally:
                    fab._fns[torch.bfloat16] = own
            return call
        vis = cs.sdpa_mask(np, case)
        lib_mask = torch.as_tensor(vis, device="cuda") \
            if cs.shifted(case) else None
        lib_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *lib_in, is_causal=causal and lib_mask is None,
            attn_mask=lib_mask, enable_gqa=H != Hk)
        b_ms, b_by = cs.bound(
            2 * (4 * B * H * Tq * hd + 4 * B * Hk * Tk * hd) + 4 * B * H * Tq,
            2.5 * 4 * hd * B * H * int(vis.sum()), cs.BF16_FLOPS_PER_S)
        row = {"shape": name, "case": list(case), "bound_ms": b_ms,
               "bound_by": b_by, "device_ms": [],
               "variant_device_ms": {p: [] for p in variants}}
        order = list(variants) + list(variants)[::-1]
        for _ in range(args.turns):
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
            for p in order:
                row["variant_device_ms"][p].append(
                    cs.device_ms(torch, other(variants[p]), args.reps))
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
        row["library_device_ms"] = cs.device_ms(
            torch, lambda: torch.autograd.grad(lib_out, lib_in, dout,
                                               retain_graph=True), args.reps)
        row["device_ms_by_launch"] = cs.launch_ms(torch, kern, "fa_bwd_",
                                                  args.reps)
        row["max_abs_diff_vs_variant"] = {}
        for p, fn in variants.items():
            a, b = kern(), other(fn)()
            row["max_abs_diff_vs_variant"][p] = max(
                float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b))
        print(f"time {name} {case}: kernel {row['device_ms']} ms, variant "
              f"{row['variant_device_ms']} ms, SDPA backward "
              f"{row['library_device_ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        for key, ms in row["device_ms_by_launch"].items():
            print(f"time {name} by launch: {ms} {key[:100]}", flush=True)
        rows.append(row)
        del q, k, v, dout, out, lse, lib_in, lib_out, lib_mask
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    print(json.dumps({"flash_attention_bwd_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
