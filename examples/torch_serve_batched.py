"""Batched serving + pool scoring with the margin head, on the PyTorch port
(the twin of ``examples/serve_batched.py``).

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cuda]

Serves a (reduced-config) qwen2-family LM with batched requests through the
ServeEngine (prefill -> KV-cache decode), then scores a token pool with the
fused margin/entropy head — the inference jobs MCAL runs at datacenter
scale when the classifier is an LLM.  ``--device`` is where the model runs
(default cuda: attention and the head launch the ``flash_attention`` and
``margin_head`` kernels); the tests run it with ``--device cpu``.  The
weights are the port's draws from seed 0, not ``jax.random``'s, so the
numbers differ from the reference example's; the lines are the same.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import ServeEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_smoke("qwen2-1.5b")
model = get_model(cfg)
params = model.init(0, device=args.device)
rng = np.random.default_rng(0)


def sync():
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize(args.device)


# --- batched generation ----------------------------------------------------
B, T, GEN = 8, 32, 16
batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                                   dtype=torch.int32, device=args.device)}
engine = ServeEngine(model, params, max_seq=T + GEN + 8, batch_size=B,
                     device=args.device)
t0 = time.perf_counter()
out = engine.generate(batch, GEN)
sync()
dt = time.perf_counter() - t0
print(f"generated {B}x{GEN} tokens in {dt:.2f}s "
      f"({B * GEN / dt:.0f} tok/s on {args.device.upper()})")

# --- pool scoring via the fused margin head ---------------------------------
hidden = model.forward(params, batch)
w = tf.lm_head_weight(cfg, params)
stats = ops.score_head(hidden.reshape(-1, cfg.d_model), w)
margin = stats.margin.float().cpu().numpy()
print(f"scored {margin.size} positions: "
      f"margin p5={float(np.percentile(margin, 5)):.3f} "
      f"p95={float(np.percentile(margin, 95)):.3f}, "
      f"mean entropy={float(stats.entropy.float().mean()):.3f} nats")
print("lowest-margin (most uncertain) positions would be routed to humans;"
      "\nhighest-margin positions are machine-labeled — MCAL's L(.)/M(.).")
