"""Carry parameters between the JAX package and the port.

The port keeps the JAX names and layouts, so this is copies, not
transposes: the nested JAX tree (as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``) flattens to the port's dotted-path
dict and back.  bf16 leaves (numpy arrays of ``ml_dtypes.bfloat16``, which
torch cannot read) cross as their 16-bit patterns, so they arrive
bit-exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.param import nest


def _is_bf16(a: np.ndarray) -> bool:
    # ml_dtypes' bfloat16 is a 2-byte numpy dtype named "bfloat16"; its
    # class is not imported here, so the port needs no ml_dtypes
    return a.dtype.name == "bfloat16"


def _to_torch(a, device="cuda") -> torch.Tensor:
    """One numpy array (bf16 included) -> a tensor with the same bits."""
    a = np.array(a)
    if _is_bf16(a):
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; a bf16 tensor -> ``ml_dtypes.bfloat16`` with the
    same bits (the dtype JAX returns from ``np.asarray``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # ships with JAX; only a bf16 leaf needs it
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested ``{name: array | subtree}`` -> flat ``{"a.b": tensor}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k in sorted(node):
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(node[k], dict):
                walk(node[k], path)
            else:
                out[path] = _to_torch(node[k], device)

    walk(tree, "")
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """Flat port params -> the nested numpy tree the JAX package uses."""
    return nest({path: _to_numpy(v) for path, v in params.items()})
