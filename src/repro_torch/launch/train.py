"""Training launcher (``repro.launch.train``), on one device: a CUDA card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 30 --batch 8 --seq 128 --ckpt-dir ckpt

The reference's flags and schedule (``paper_steps`` over ``--steps``),
the ``Trainer`` (resume, checkpoints, straggler monitor), LM batches of
``make_lm_tokens`` through ``ShardedLoader``.  The full config trains on
one device: training over a mesh is the next slice of ROADMAP A.4.  Like the reference's launcher
it builds ``{"tokens", "labels"}`` batches only, which the audio and vlm
architectures cannot train on (the reference's launcher fails on them:
ROADMAP C.6), so it refuses those; ``Trainer`` itself takes their
``audio_frames`` / ``patch_embeds`` batches.  On a CUDA device every
token family trains on the kernels: attention's gradient is the
``flash_attention_bwd`` kernel, the SSD scan's the ``ssd_scan_bwd`` one
(``--arch mamba2-1.3b`` and ``zamba2-2.7b`` included).
"""
from __future__ import annotations

import argparse

# families whose batches carry a frontend input the launcher does not build
_FRONTEND_FAMILIES = ("audio", "vlm")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.synth import make_lm_tokens
    from repro_torch.models.registry import get_model
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in _FRONTEND_FAMILIES:
        raise NotImplementedError(
            f"the train launcher builds token batches only, and the "
            f"{cfg.family} family's loss needs "
            f"{'audio_frames' if cfg.family == 'audio' else 'patch_embeds'}"
            f" too (the reference's launcher fails on it: ROADMAP C.6); "
            f"train it through Trainer with such batches")
    model = get_model(cfg)
    print(f"[train] arch={args.arch} params={model.param_count():,} "
          f"device={args.device}")
    tc = TrainConfig(learning_rate=args.lr, schedule="paper_steps",
                     total_steps=args.steps)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         max_steps=args.steps, log_every=5)
    trainer = Trainer(model, tc, tcfg, seed=args.seed, device=args.device)

    toks = make_lm_tokens(args.batch * 64, args.seq + 1, cfg.vocab_size,
                          seed=args.seed)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loader = ShardedLoader(data, args.batch, seed=args.seed,
                           device=args.device)

    def batches():
        while True:
            yield from loader.epoch()

    metrics = trainer.fit(batches())
    print(f"[train] done at step {trainer.step}: {metrics}")
    return trainer, metrics


if __name__ == "__main__":
    main()
