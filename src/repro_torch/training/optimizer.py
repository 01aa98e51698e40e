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

Sharded (``train_loop.make_sharded_train_step``), each leaf's update runs
on this rank's block of the leaf and of its slots, and the parts that
reduce over a leaf give the whole leaf's values (:class:`LeafLayout`):
the global norm sums each leaf's squares over its blocks, the int8
moment's per-tensor scale is the max over every block, and the factored
moments' means sum over the blocks of a sharded axis and divide by its
whole size.

On a CUDA device PyTorch divides by a host scalar as a product with its
fp32 reciprocal; :func:`adamw_update` writes that product out there, so
that the retrain's CUDA graph, which reads the reciprocals from a device
table (``inv_bc``), computes the same bits as the eager step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


def slot_logical(shape, logical: Sequence, tc: TrainConfig) -> Dict[str, Tuple]:
    """{slot name: logical axes} for one parameter leaf, the reference's:
    a moment takes its parameter's axes, ``vr`` all but the last, ``vc``
    all but the second to last, the int8 scale none."""
    logical = tuple(logical)
    axes = {"m_q": logical, "m_scale": (), "m": logical, "v": logical,
            "vr": logical[:-1], "vc": logical[:-2] + logical[-1:]}
    return {k: axes[k] for k in slot_spec(shape, tc)}


@dataclasses.dataclass
class LeafLayout:
    """How one parameter leaf and its slots are split over a mesh: the
    parameter's spec, its whole shape and each slot's spec (entries:
    None, an axis name, or a tuple of names, major first), and the mesh
    whose groups the reductions use."""
    mesh: Any
    spec: Tuple
    shape: Tuple[int, ...]
    slots: Dict[str, Tuple]

    def _axes(self, entry) -> Tuple[str, ...]:
        return (entry,) if isinstance(entry, str) else tuple(entry or ())

    def _reduce(self, x: torch.Tensor, entries, op: str) -> torch.Tensor:
        from repro_torch.distributed import collectives as C
        for e in entries:
            for a in self._axes(e):
                ax = C.Axis.of(self.mesh, a)
                x = C.all_reduce_max(x, ax) if op == "max" \
                    else C._all_reduce(x, ax)
        return x

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """max |x| over the whole leaf."""
        return self._reduce(torch.amax(torch.abs(x)), self.spec, "max")

    def mean(self, x: torch.Tensor, dim: int, entry, n: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the whole tensor whose block ``x`` is,
        ``dim`` split over ``entry``'s axes, ``n`` long."""
        return self._reduce(torch.sum(x, dim=dim, keepdim=keepdim),
                            [entry], "sum") / n

    def move(self, x: torch.Tensor, have, want) -> torch.Tensor:
        from repro_torch.distributed.sharding import relayout
        return relayout(x, have, want, self.mesh)


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


def _put_m(slot: Dict, m: torch.Tensor, tc: TrainConfig,
           lay: Optional[LeafLayout] = None) -> None:
    if tc.moment_dtype == "int8":
        if lay is None:
            q = quantize_int8(m)
        else:   # the per-tensor scale of the whole leaf
            scale = lay.amax(m) / 127.0 + 1e-30
            q = {"q": torch.clamp(torch.round(m / scale), -127, 127).to(
                torch.int8), "scale": scale.float()}
        slot["m_q"], slot["m_scale"] = q["q"], q["scale"]
    elif tc.moment_dtype == "bfloat16":
        slot["m"] = m.to(torch.bfloat16)
    else:
        slot["m"] = m


def _second_moment(slot: Dict, g2: torch.Tensor, b2: float,
                   lay: Optional[LeafLayout] = None) -> torch.Tensor:
    """Update the second-moment slot; return the dense estimate."""
    if "v" in slot:
        slot["v"] = b2 * slot["v"] + (1.0 - b2) * g2
        return slot["v"]
    if lay is not None:
        return _factored_sharded(slot, g2, b2, lay)
    # Adafactor-style factored estimate over the last two axes
    vr = b2 * slot["vr"] + (1.0 - b2) * torch.mean(g2, dim=-1)
    vc = b2 * slot["vc"] + (1.0 - b2) * torch.mean(g2, dim=-2)
    slot["vr"], slot["vc"] = vr, vc
    denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
    return vr[..., None] * vc[..., None, :] / denom[..., None]


def _factored_sharded(slot: Dict, g2: torch.Tensor, b2: float,
                      lay: LeafLayout) -> torch.Tensor:
    """The factored estimate on this rank's block of a sharded leaf: the
    means over a sharded axis sum its blocks, each result is moved into
    its slot's stored split, and the dense estimate comes back in the
    leaf's."""
    ps, n = tuple(lay.spec), lay.shape
    ps = ps + (None,) * (len(n) - len(ps))
    r_have, c_have = ps[:-1], ps[:-2] + ps[-1:]
    vr_sp, vc_sp = lay.slots["vr"], lay.slots["vc"]
    vr = b2 * slot["vr"] + (1.0 - b2) * lay.move(
        lay.mean(g2, -1, ps[-1], n[-1]), r_have, vr_sp)
    vc = b2 * slot["vc"] + (1.0 - b2) * lay.move(
        lay.mean(g2, -2, ps[-2], n[-2]), c_have, vc_sp)
    slot["vr"], slot["vc"] = vr, vc
    denom = torch.clamp(lay.mean(vr, -1, tuple(vr_sp)[-1], n[-2],
                                 keepdim=True), min=1e-30)
    denom = lay.move(denom, tuple(vr_sp)[:-1] + (None,), ps[:-2] + (None,))
    vr, vc = lay.move(vr, vr_sp, r_have), lay.move(vc, vc_sp, c_have)
    return vr[..., None] * vc[..., None, :] / denom[..., None]


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], slots: List[Dict],
                 step: int, lr, tc: TrainConfig, inv_bc=None,
                 layouts: Optional[Dict[str, LeafLayout]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], List[Dict]]:
    """One AdamW step.  ``step`` is the host step count before it.
    ``inv_bc``: the reciprocals of the bias corrections as 0-dim device
    tensors, in place of ``step`` (the captured retrain; ``lr`` is then a
    0-dim tensor too).  ``layouts``: for each sharded leaf (its params and
    slots this rank's blocks), how it is split."""
    layouts = layouts or {}
    assert len(params) == len(grads) == len(slots)
    bc1, bc2 = bias_corrections(step, tc)
    b1, b2 = float(np.float32(tc.beta1)), float(np.float32(tc.beta2))
    new_p, new_slots = {}, []
    for (name, p), slot in zip(sorted(params.items()), slots):
        slot = dict(slot)
        gf = grads[name].float()
        m = b1 * _get_m(slot) + (1.0 - b1) * gf
        lay = layouts.get(name)
        _put_m(slot, m, tc, lay)
        v = _second_moment(slot, gf * gf, b2, lay)
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


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        whole_sums: Optional[Callable] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale the gradients to a global norm of at most ``max_norm``.
    ``whole_sums`` maps the leaves' sums of squares (sorted-name order) to
    the whole leaves' where each rank holds blocks."""
    sums = [torch.sum(g.float() ** 2) for _, g in sorted(grads.items())]
    if whole_sums is not None:
        sums = whole_sums(sums)
    gnorm = torch.sqrt(sum(sums))
    if max_norm <= 0:
        return grads, gnorm
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gnorm
