#!/usr/bin/env python3
"""Time the attention forward kernel against another build of it, in turns
on one card.

    python3 tools/time_attention_fwd.py [--variant build/other.cu ...]
                                        [--shapes qwen2 gemma3_local ...]
                                        [--reps 20] [--turns 3]

At each shape (bf16, inputs from a seed): ``flash_attention`` as built from
``csrc/``, and each ``--variant`` source (a ``flash_attention.cu`` of the
same or the earlier C interface, e.g. an earlier commit's, loaded by
``time_attention_bwd.load_variant``; every shape here has no ``q_offset``
and no ``kv_start``), their outputs compared bit for bit.  Device ms:
``--reps`` calls queued back to back between two CUDA events
(``chip_smoke.device_ms``), taken in turns: the kernel, the variants in
order, again in reverse, the kernel, ``--turns`` times.  Prints the
card's line and one JSON line.  Needs a CUDA device.

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

# (B, H, Hk, Tq, Tk, hd, causal, window): the serving and training paths'
# shapes
SHAPES = {"qwen2": (8, 12, 2, 2048, 2048, 128, True, 0),
          "gemma3_local": (8, 8, 4, 2048, 2048, 256, True, 1024),
          "gemma3_global": (8, 8, 4, 2048, 2048, 256, True, 0),
          "zamba2": (8, 32, 32, 2048, 2048, 80, True, 0),
          "internvl2": (8, 48, 8, 3072, 3072, 128, True, 0),
          "whisper_enc": (8, 6, 6, 1500, 1500, 64, False, 0)}


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
    rows = []
    for name in args.shapes:
        case = SHAPES[name]
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
        row = {"shape": name, "case": list(case), "device_ms": [],
               "variant_device_ms": {p: [] for p in variants},
               "bit_equal_to_variant": {p: bool(torch.equal(
                   kern(), other(fn)())) for p, fn in variants.items()}}
        order = list(variants) + list(variants)[::-1]
        for _ in range(args.turns):
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
            for p in order:
                row["variant_device_ms"][p].append(
                    cs.device_ms(torch, other(variants[p]), args.reps))
            row["device_ms"].append(cs.device_ms(torch, kern, args.reps))
        print(f"time {name} {case}: kernel {row['device_ms']} ms, variant "
              f"{row['variant_device_ms']} ms, bit-equal "
              f"{row['bit_equal_to_variant']}", flush=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    print(json.dumps({"flash_attention_variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
