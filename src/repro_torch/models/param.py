"""Declarative parameter specs (``repro.models.param``).

Models declare their parameters as nested dicts of :class:`ParamSpec`;
:func:`init_params` materializes them into a FLAT dict keyed by the dotted
path (``"blocks.w"``), the naming ``nn.Module.named_parameters`` uses.
Initialization is deterministic per path: each leaf draws from its own
``torch.Generator`` seeded from (seed, crc32 of the leaf's path), on the
CPU, so the same seed gives the same weights on every device.  The draws
are not ``jax.random``'s — tests that compare the two frameworks carry the
JAX weights across (``models.convert``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones
    dtype: Any = torch.float32
    scale: Optional[float] = None  # stddev; None -> 1/sqrt(fan_in)


def _stddev(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    # fan_in is every dim but the last, as in the reference (a stacked
    # (L, d, d) leaf counts L * d)
    fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 \
        else spec.shape[0]
    return 1.0 / np.sqrt(max(fan_in, 1))


def iter_specs(specs: Dict, prefix: str = "") -> Iterator[Tuple[str, ParamSpec]]:
    """(dotted path, spec) in sorted-key order — the leaf order of the JAX
    package's pytrees, so per-leaf sums run in the same order."""
    for k in sorted(specs):
        v = specs[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, ParamSpec):
            yield path, v
        else:
            yield from iter_specs(v, path)


def derive_seed(*parts: int) -> int:
    """A well-mixed 32-bit generator seed from integer parts (a CPU
    ``torch.Generator`` keeps only 32 bits of its seed)."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1)[0])


def _keystr(path: str) -> str:
    """The JAX package's path string (``jax.tree_util.keystr``)."""
    return "".join(f"['{p}']" for p in path.split("."))


def init_params(specs: Dict, seed: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Materialize a spec tree into a flat ``{path: tensor}`` dict."""
    out = {}
    for path, spec in iter_specs(specs):
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=spec.dtype)
        elif spec.init == "ones":
            arr = torch.ones(spec.shape, dtype=spec.dtype)
        else:
            leaf = zlib.crc32(_keystr(path).encode()) % (2**31)
            g = torch.Generator().manual_seed(derive_seed(seed, leaf))
            # scaled in place: the same bits as ``randn(...) * std`` with
            # one fp32 copy fewer (a full-width leaf is tens of GB)
            arr = torch.randn(spec.shape, generator=g, dtype=torch.float32)
            arr = arr.mul_(_stddev(spec)).to(spec.dtype)
        out[path] = arr.to(device)
    return out


def nest(flat: Dict[str, Any]) -> Dict:
    """Flat ``{"a.b": v}`` -> nested ``{"a": {"b": v}}`` (the same values,
    no copies): the tree the model functions index as the reference does."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value
    return tree


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
