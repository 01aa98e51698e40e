"""PyTorch/CUDA port of the MCAL labeling system.

A sibling of the JAX package ``repro`` with the same module layout
(``repro_torch.core.scoring`` mirrors ``repro.core.scoring`` and so on).
It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``.  Entry points default to ``device="cuda"``; the tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

The reference contracts (exact fp32 ``top1``, exact k-center picks) need
IEEE fp32 products, so TF32 is switched off here, at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
