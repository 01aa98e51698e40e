#!/usr/bin/env python3
"""Time the ``margin_head`` kernel against its plain version by row count.

    python3 tools/time_margin_head.py [--rows 1 8 64 256] [--dim 2560]
                                      [--vocab 32000]

For each row count T: the kernel and ``ref.margin_head_ref`` on the same
fp32 (T, dim) hidden rows and (dim, vocab) W, timed as ``chip_smoke.py``
times a kernel (its ``timing_row``: CUDA-event medians, the profiler's
device time summed over the ``margin_head_`` launches, the bound from the
bytes and flops).  The kernel re-reads W once per group of 8 rows, so
this shows where more rows stop paying.  Prints the card's line and one
JSON line of the rows.  Needs a CUDA device.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 8, 64, 256])
    ap.add_argument("--dim", type=int, default=2560)
    ap.add_argument("--vocab", type=int, default=32000)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import margin_head as mh
    from repro_torch.kernels import ref

    print(cs.card_line(), flush=True)
    rng = np.random.default_rng(2)
    D, V = args.dim, args.vocab
    w = torch.as_tensor((rng.normal(size=(D, V)) * 0.1).astype(np.float32),
                        device="cuda")
    rows = []
    for T in args.rows:
        h = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32),
                            device="cuda")
        rows.append(cs.timing_row(
            torch, "margin_head", (T, D, V), lambda: mh.margin_head(h, w),
            lambda: ref.margin_head_ref(h, w), None,
            4 * (T * D + D * V) + 16 * T, 2 * T * D * V + 6 * T * V,
            cs.FP32_FLOPS_PER_S, "margin_head_"))
    print(json.dumps({"margin_head_by_rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
