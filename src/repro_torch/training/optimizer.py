"""AdamW as the JAX package writes it (``repro.training.optimizer``).

Not ``torch.optim.AdamW``, which places eps and the decay differently, and
not ``clip_grad_norm_``, whose epsilon differs: per leaf,
``update = (m / bc1) / (sqrt(v / bc2) + eps)``, plus ``weight_decay * p``
for leaves of two or more dims only, then ``p - lr * update``.  Slots are
fp32 ``m`` and ``v``, leaf-aligned with the params' sorted-key order.

On a CUDA device PyTorch divides by a host scalar as a product with its
fp32 reciprocal; :func:`adamw_update` writes that product out there, so
that the retrain's CUDA graph, which reads the reciprocals from a device
table (``inv_bc``), computes the same bits as the eager step.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig


def _decayed(shape) -> bool:
    return len(shape) >= 2


def init_slots(params: Dict[str, torch.Tensor], tc: TrainConfig) -> List[Dict]:
    if tc.moment_dtype != "float32":
        raise NotImplementedError("only float32 optimizer slots are ported")
    return [{"m": torch.zeros_like(p, dtype=torch.float32),
             "v": torch.zeros_like(p, dtype=torch.float32)}
            for _, p in sorted(params.items())]


def bias_corrections(step: int, tc: TrainConfig) -> Tuple[float, float]:
    """Adam's ``(1 - b1^t, 1 - b2^t)`` in fp32 for the step after ``step``
    steps."""
    b1, b2 = np.float32(tc.beta1), np.float32(tc.beta2)
    t = np.float32(step + 1)
    return (float(np.float32(1.0) - b1 ** t), float(np.float32(1.0) - b2 ** t))


def reciprocal(x: float) -> float:
    """``1 / x`` in fp32, as PyTorch's CUDA division by a host scalar
    computes it."""
    return float(np.float32(1.0) / np.float32(x))


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], slots: List[Dict],
                 step: int, lr, tc: TrainConfig, inv_bc=None
                 ) -> Tuple[Dict[str, torch.Tensor], List[Dict]]:
    """One AdamW step.  ``step`` is the host step count before it.
    ``inv_bc``: the reciprocals of the bias corrections as 0-dim device
    tensors, in place of ``step`` (the captured retrain; ``lr`` is then a
    0-dim tensor too)."""
    assert len(params) == len(grads) == len(slots)
    bc1, bc2 = bias_corrections(step, tc)
    b1, b2 = float(np.float32(tc.beta1)), float(np.float32(tc.beta2))
    new_p, new_slots = {}, []
    for (name, p), slot in zip(sorted(params.items()), slots):
        gf = grads[name].float()
        m = b1 * slot["m"] + (1.0 - b1) * gf
        v = b2 * slot["v"] + (1.0 - b2) * (gf * gf)
        if inv_bc is not None:
            m_hat, v_hat = m * inv_bc[0], v * inv_bc[1]
        elif p.is_cuda:
            m_hat, v_hat = m * reciprocal(bc1), v * reciprocal(bc2)
        else:
            m_hat, v_hat = m / bc1, v / bc2
        update = m_hat / (torch.sqrt(v_hat) + tc.eps)
        if tc.weight_decay and _decayed(p.shape):
            update = update + tc.weight_decay * p.float()
        new_p[name] = (p.float() - lr * update).to(p.dtype)
        new_slots.append({"m": m, "v": v})
    return new_p, new_slots


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                           for _, g in sorted(grads.items())))
    if max_norm <= 0:
        return grads, gnorm
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gnorm
