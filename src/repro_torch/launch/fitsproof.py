"""Analytic per-device memory residents per cell (the fits-proof,
``repro.launch.fitsproof``):

  params shard + optimizer slots + grad/accum carry (train)
  + residual-stream carries + KV/SSM cache shard (serve)

Every term is the reference's.  ``fits`` compares the total with 0.9 of
the card's memory, read from ``torch.cuda.get_device_properties``; only a
caller that asks for the CPU (``capacity("cpu")`` or ``--device cpu``, as
the tests do) gets the data-sheet size of one H100, :data:`HBM_PER_CHIP`.
A ``cuda`` call without a card raises: it never falls back to the
constant.

Usage:  PYTHONPATH=src python -m repro_torch.launch.fitsproof
            [--mesh single] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Optional

from repro_torch.configs import ARCH_IDS, cells, get_config
from repro_torch.launch.roofline import _cache_bytes, mesh_sizes, param_counts

HBM_PER_CHIP = 80e9        # bytes: one H100 SXM (data sheet), CPU callers


def capacity(device="cuda") -> float:
    """The memory of ``device``'s card in bytes, or :data:`HBM_PER_CHIP`
    for ``device="cpu"``.  Raises on ``cuda`` without a card."""
    import torch
    device = torch.device(device)
    if device.type == "cpu":
        return HBM_PER_CHIP
    if device.type != "cuda":
        raise ValueError(f"fits-proof capacity of device {device}: only "
                         f"cuda (the card's) or cpu (the data sheet's)")
    if not torch.cuda.is_available():
        raise RuntimeError("fits-proof on cuda: no CUDA device here; pass "
                           "device='cpu' for the data-sheet capacity")
    return float(torch.cuda.get_device_properties(device).total_memory)


def residents(cfg, shape, mesh_kind: str, grad_accum: int = 1,
              hbm: Optional[float] = None):
    """The reference's terms (``params``, ``opt``, ``grads``, ``carries``
    for a train cell; ``cache``, ``act`` to serve), their ``total``, and
    ``fits``: the total within 0.9 of ``hbm`` bytes (default: the card's,
    ``capacity("cuda")``)."""
    sizes = mesh_sizes(mesh_kind)
    n_dev = math.prod(sizes.values())
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    tp = sizes.get("model", 1)
    pc = param_counts(cfg)
    wd = dp * tp if cfg.sharding in ("fsdp_tp", "fsdp") else tp
    params = pc.total * 2 / wd
    out = {"params": params}
    if shape.kind == "train":
        big = pc.total >= 100e9
        m_bytes = 1 if big else 4            # int8 moments for giants
        v_bytes = 0.1 if big or pc.total >= 10e9 else 4  # factored v
        out["opt"] = pc.total * (m_bytes + v_bytes) / wd
        grad_b = 2 if big else 4
        out["grads"] = pc.total * grad_b / wd
        b_local = max(shape.global_batch // dp, 1)
        layers = cfg.num_layers + cfg.encoder_layers
        out["carries"] = (b_local * shape.seq_len * cfg.d_model * 2 *
                          layers / max(grad_accum, 1))
    else:
        cache_ways = n_dev  # cache_batch x cache_seq shard over the mesh
        out["cache"] = _cache_bytes(cfg, shape.global_batch,
                                    shape.seq_len) / cache_ways
        out["act"] = (shape.global_batch / dp) * \
            min(shape.seq_len, 4096) * cfg.d_model * 4 * 4
    out["total"] = sum(out.values())
    hbm = capacity("cuda") if hbm is None else hbm
    out["fits"] = out["total"] <= hbm * 0.9
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--device", default="cuda",
                    help="the card whose memory the cells must fit (cpu: "
                         "the H100 data sheet's 80 GB)")
    ap.add_argument("--dryrun-jsonl", default="results/dryrun_torch.jsonl")
    args = ap.parse_args()
    hbm = capacity(args.device)
    src = "data sheet" if args.device == "cpu" else \
        f"read from {args.device}"
    print(f"capacity {hbm / 1e9:.2f} GB ({src}); fits at 0.9 of it")
    accums = {}
    try:
        with open(args.dryrun_jsonl) as f:
            for line in f:
                r = json.loads(line)
                if r.get("grad_accum") and r["mesh"] == args.mesh:
                    accums[(r["arch"], r["shape"])] = r["grad_accum"]
    except FileNotFoundError:
        pass
    print(f"{'arch':22s} {'shape':12s} {'params':>8s} {'opt':>7s} "
          f"{'grads':>7s} {'carry':>7s} {'cache':>7s} {'total':>8s} fits")
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in cells(arch):
            ga = accums.get((arch, shape.name), 1)
            r = residents(cfg, shape, args.mesh, ga, hbm=hbm)
            gb = lambda k: f"{r.get(k, 0) / 1e9:7.2f}"  # noqa: E731
            print(f"{arch:22s} {shape.name:12s} {gb('params')} {gb('opt')} "
                  f"{gb('grads')} {gb('carries')} {gb('cache')} "
                  f"{r['total'] / 1e9:8.2f} {'Y' if r['fits'] else 'NO'}")


if __name__ == "__main__":
    main()
