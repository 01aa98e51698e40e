"""AdamW as the JAX package writes it (``repro.training.optimizer``), with
its memory levers.

Not ``torch.optim.AdamW``, which places eps and the decay differently, and
not ``clip_grad_norm_``, whose epsilon differs: per leaf,
``update = (m / bc1) / (sqrt(v / bc2) + eps)``, plus ``weight_decay * p``
for leaves of two or more dims only, then ``p - lr * update``.  Slots are a
list of dicts leaf-aligned with the params' sorted-key order, the leaf
order of the reference's pytrees (the dotted paths sort as the nested
dicts do):

* the first moment ``m`` in ``moment_dtype``: fp32 or bf16 ``m``, or int8
  ``m_q`` with its fp32 per-tensor ``m_scale`` (symmetric, requantized
  each step);
* the second moment ``v`` in fp32, or, with ``factored_second_moment``,
  Adafactor-style ``vr`` / ``vc`` over the last two axes of leaves whose
  last two dims are both at least 8 (leading stack axes stay batched).

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

# minimum size of each of the last two dims for factoring to pay off
_FACTOR_MIN = 8


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= _FACTOR_MIN and \
        shape[-2] >= _FACTOR_MIN


def _decayed(shape) -> bool:
    return len(shape) >= 2


def quantize_int8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-tensor int8: ``q = round(x / scale)`` clipped to
    +-127, ``scale = max|x| / 127 + 1e-30`` (fp32)."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def dequantize_int8(slot: Dict[str, torch.Tensor]) -> torch.Tensor:
    return slot["q"].float() * slot["scale"]


def slot_spec(shape, tc: TrainConfig) -> Dict[str, Tuple]:
    """{slot name: (shape, dtype)} for one parameter leaf."""
    out: Dict[str, Tuple] = {}
    if tc.moment_dtype == "int8":
        out["m_q"] = (tuple(shape), torch.int8)
        out["m_scale"] = ((), torch.float32)
    elif tc.moment_dtype in ("float32", "bfloat16"):
        out["m"] = (tuple(shape), torch.float32
                    if tc.moment_dtype == "float32" else torch.bfloat16)
    else:
        raise ValueError(f"unknown moment_dtype {tc.moment_dtype!r}")
    if tc.factored_second_moment and _factorable(shape):
        out["vr"] = (tuple(shape[:-1]), torch.float32)
        out["vc"] = (tuple(shape[:-2]) + tuple(shape[-1:]), torch.float32)
    else:
        out["v"] = (tuple(shape), torch.float32)
    return out


def init_slots(params: Dict[str, torch.Tensor], tc: TrainConfig) -> List[Dict]:
    return [{k: torch.zeros(sh, dtype=dt, device=p.device)
             for k, (sh, dt) in slot_spec(p.shape, tc).items()}
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


def _get_m(slot: Dict) -> torch.Tensor:
    if "m_q" in slot:
        return dequantize_int8({"q": slot["m_q"], "scale": slot["m_scale"]})
    return slot["m"].float()


def _put_m(slot: Dict, m: torch.Tensor, tc: TrainConfig) -> None:
    if tc.moment_dtype == "int8":
        q = quantize_int8(m)
        slot["m_q"], slot["m_scale"] = q["q"], q["scale"]
    elif tc.moment_dtype == "bfloat16":
        slot["m"] = m.to(torch.bfloat16)
    else:
        slot["m"] = m


def _second_moment(slot: Dict, g2: torch.Tensor, b2: float) -> torch.Tensor:
    """Update the second-moment slot; return the dense estimate."""
    if "v" in slot:
        slot["v"] = b2 * slot["v"] + (1.0 - b2) * g2
        return slot["v"]
    # Adafactor-style factored estimate over the last two axes
    vr = b2 * slot["vr"] + (1.0 - b2) * torch.mean(g2, dim=-1)
    vc = b2 * slot["vc"] + (1.0 - b2) * torch.mean(g2, dim=-2)
    slot["vr"], slot["vc"] = vr, vc
    denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
    return vr[..., None] * vc[..., None, :] / denom[..., None]


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
        slot = dict(slot)
        gf = grads[name].float()
        m = b1 * _get_m(slot) + (1.0 - b1) * gf
        _put_m(slot, m, tc)
        v = _second_moment(slot, gf * gf, b2)
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
        new_slots.append(slot)
    return new_p, new_slots


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                           for _, g in sorted(grads.items())))
    if max_norm <= 0:
        return grads, gnorm
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gnorm
