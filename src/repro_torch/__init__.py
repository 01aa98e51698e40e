"""PyTorch/CUDA port of the MCAL labeling system.

A sibling of the JAX package ``repro`` with the same module layout
(``repro_torch.core.scoring`` mirrors ``repro.core.scoring`` and so on).
It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``.  Entry points default to ``device="cuda"``; the tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

Importing the package itself loads no torch, so that a launcher's
``--help`` stays cheap; ``repro_torch.models``, which every module that
computes imports, switches TF32 off.
"""
