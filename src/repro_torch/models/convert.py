"""Carry parameters between the JAX package and the port.

The port keeps the JAX names and layouts, so this is copies, not
transposes: the nested JAX tree (as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``) flattens to the port's dotted-path
dict and back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested ``{name: array | subtree}`` -> flat ``{"a.b": tensor}``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k in sorted(node):
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(node[k], dict):
                walk(node[k], path)
            else:
                out[path] = torch.as_tensor(np.array(node[k]), device=device)

    walk(tree, "")
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """Flat port params -> the nested numpy tree the JAX package uses."""
    tree: Dict = {}
    for path, value in params.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value.detach().cpu().numpy()
    return tree
