"""Serving launcher (``repro.launch.serve``): batched generation with the
port's ServeEngine, on a CUDA device unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --batch 8 --prompt-len 2048 --gen 32

Pool-sweep mode (MCAL's machine-labeling pass through the serving
runtime):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke --device cpu --score-pool 32 --sweep-page 8 --sweep-async

``--arch`` takes the ported ids (``repro_torch.configs.ARCH_IDS``:
zamba2-2.7b and the dense qwen2-1.5b, gemma3-4b, qwen1.5-4b and
phi3-medium-14b); ``--smoke`` takes the reduced config.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--score-pool", type=int, default=0,
                    help="score a random N-row token pool through the "
                         "paged sweep runtime instead of generating")
    ap.add_argument("--sweep-page", type=int, default=0,
                    help="sweep page rows (default: --batch)")
    ap.add_argument("--sweep-async", action="store_true",
                    help="run the pool sweep through the async handle "
                         "(SweepFuture) instead of blocking")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    params = model.init(args.seed, device=args.device)
    print(f"[serve] {cfg.name}: init {model.init_seconds:.2f}s on "
          f"{args.device}")
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))}
    engine = ServeEngine(model, params,
                         max_seq=args.prompt_len + args.gen + 8,
                         batch_size=args.batch, device=args.device)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    if args.score_pool:
        # stream an N-row prompt pool through the scoring step as paged,
        # double-buffered sweep work
        pool = {"tokens": rng.integers(
            0, cfg.vocab_size,
            (args.score_pool, args.prompt_len)).astype(np.int32)}
        page = args.sweep_page or args.batch
        engine.score_pool({k: v[:page] for k, v in pool.items()},
                          page_rows=page)          # warm the page step
        sync()
        t0 = time.perf_counter()
        if args.sweep_async:
            stats = engine.score_pool_async(pool, page_rows=page).result()
        else:
            stats = engine.score_pool(pool, page_rows=page)
        sync()
        dt = time.perf_counter() - t0
        engine.close()
        mode = "async" if args.sweep_async else "sync"
        print(f"[serve] pool sweep ({mode}) scored {args.score_pool} rows "
              f"in {dt:.2f}s ({args.score_pool / dt:.1f} rows/s, "
              f"page={page})")
        print("mean margin:", float(stats.margin.float().mean()))
        return stats

    t0 = time.perf_counter()
    out = engine.generate(batch, args.gen)
    sync()
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out.cpu().numpy()[:2])
    return out


if __name__ == "__main__":
    main()
