#!/usr/bin/env python3
"""Time the attention forward kernel against another build of it, in turns
on one card.

    python3 tools/time_attention_fwd.py [--variant build/other.cu ...]
                                        [--shapes qwen2 whisper_enc ...]
                                        [--reps 20] [--turns 3]

At each shape (bf16, inputs from a seed): ``flash_attention`` as built from
``csrc/``, and each ``--variant`` source (a ``flash_attention.cu`` of the
same or the earlier C interface, e.g. an earlier commit's saved with
``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu >
build/fa_fwd_<commit>.cu``, loaded by ``time_attention_bwd.load_variant``),
their outputs compared bit for bit and by their largest difference.
Device ms: ``--reps`` calls queued back to back between two CUDA events
(``chip_smoke.device_ms``), taken in turns: the kernel, the variants in
order, again in reverse, the kernel, ``--turns`` times; beside them the
bound (``chip_smoke``'s: 4 hd flops a visible pair at the bf16 peak, or
the bytes of q, k, v read and o written) and
``scaled_dot_product_attention`` (``enable_gqa``; an explicit boolean mask
for a window or a shifted frame).  Then the host's microseconds a call
of the kernel and of each variant at whisper-tiny's shapes (``--reps``
calls enqueued after a synchronize, the host clock stopped before the
card finishes; whisper's forward is host-bound).  Prints the card's line
and one JSON line.  Needs a CUDA device.

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

# (B, H, Hk, Tq, Tk, hd, causal, window[, q_offset, kv_start]): the
# serving and training paths' shapes, qwen2-1.5b's pool pass (64 rows of
# 256 tokens a microbatch) and the last block of its 16-way sequence split
SHAPES = {"qwen2": (8, 12, 2, 2048, 2048, 128, True, 0),
          "qwen2_pool": (64, 12, 2, 256, 256, 128, True, 0),
          "qwen2_split": (8, 12, 2, 128, 2048, 128, True, 0, 1920, 0),
          "dbrx": (8, 48, 8, 2048, 2048, 128, True, 0),
          "internvl2": (8, 48, 8, 3072, 3072, 128, True, 0),
          "zamba2": (8, 32, 32, 2048, 2048, 80, True, 0),
          "whisper_enc": (8, 6, 6, 1500, 1500, 64, False, 0),
          "gemma3_local": (8, 8, 4, 2048, 2048, 256, True, 1024),
          "gemma3_global": (8, 8, 4, 2048, 2048, 256, True, 0)}
# whisper-tiny's serving shapes (8 requests, 448-token decoder prompts):
# the encoder over 1,500 frames, the decoder's causal self-attention and
# its cross-attention
HOST_SHAPES = {"whisper_enc": (8, 6, 6, 1500, 1500, 64, False, 0),
               "whisper_dec": (8, 6, 6, 448, 448, 64, True, 0),
               "whisper_cross": (8, 6, 6, 448, 1500, 64, False, 0)}


def host_us(torch, fn, reps: int) -> float:
    """The host's microseconds a call: ``reps`` calls enqueued after a
    synchronize, the clock stopped before the card finishes."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", type=Path, nargs="+", default=[])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from time_attention_bwd import load_variant

    print(cs.card_line(), flush=True)
    build.build_all()
    own = fa._fn(torch.bfloat16)
    variants = {str(p): load_variant(p, "flash_attention_bf16", 6)
                for p in args.variant}
    def calls(case):
        """The kernel and each variant as functions of no argument, on
        inputs drawn for ``case``."""
        q, k, v = cs.flash_inputs(torch, np, case, torch.bfloat16)

        def kern():
            return fa.flash_attention(q, k, v, **cs.mask_of(case))

        def other(fn):
            def call():
                fa._fns[torch.bfloat16] = fn
                try:
                    return kern()
                finally:
                    fa._fns[torch.bfloat16] = own
            return call
        return (q, k, v), kern, {p: other(fn) for p, fn in variants.items()}

    rows = []
    for name in args.shapes:
        case = SHAPES[name]
        B, H, Hk, Tq, Tk, hd, causal = case[:7]
        (q, k, v), kern, others = calls(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = None if causal and not cs.shifted(case) else torch.as_tensor(
            cs.sdpa_mask(np, case), device="cuda")
        b_ms, b_by = cs.bound(2 * (2 * B * H * Tq * hd + 2 * B * Hk * Tk * hd),
                              cs.attention_flops(case), cs.BF16_FLOPS_PER_S)
        mine = kern()
        row = {"shape": name, "case": list(case), "bound_ms": b_ms,
               "bound_by": b_by, "device_ms": [],
               "variant_device_ms": {p: [] for p in variants},
               "bit_equal_to_variant": {}, "max_abs_diff_vs_variant": {}}
        for p, fn in others.items():
            theirs = fn()
            row["bit_equal_to_variant"][p] = bool(torch.equal(mine, theirs))
            row["max_abs_diff_vs_variant"][p] = float(
                (mine.float() - theirs.float()).abs().max())
        order = list(variants) + list(variants)[::-1]
        for _ in range(args.turns):
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
            for p in order:
                row["variant_device_ms"][p].append(
                    cs.device_ms(torch, others[p], args.reps))
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
        row["library_device_ms"] = cs.device_ms(
            torch, lambda: sdpa(q, k, v, is_causal=mask is None,
                                attn_mask=mask, enable_gqa=H != Hk),
            args.reps)
        print(f"time {name} {case}: kernel {row['device_ms']} ms, variant "
              f"{row['variant_device_ms']} ms, SDPA "
              f"{row['library_device_ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), bit-equal {row['bit_equal_to_variant']}, max abs "
              f"diff {row['max_abs_diff_vs_variant']}", flush=True)
        rows.append(row)
        del q, k, v, mine, mask
        torch.cuda.empty_cache()
    host = {}
    for name, case in HOST_SHAPES.items():
        _, kern, others = calls(case)
        host[name] = {"kernel": host_us(torch, kern, args.reps), **{
            p: host_us(torch, fn, args.reps) for p, fn in others.items()}}
        print(f"host us a call {name} {case}: {host[name]}", flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"flash_attention_variants": rows,
                      "host_us_per_call": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
