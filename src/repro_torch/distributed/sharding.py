"""Logical-axis sharding rules (``repro.distributed.sharding``;
MaxText-style, divisibility-aware).

Every parameter carries logical axis names (``models.param.ParamSpec``'s
``logical``); a policy maps logical axes to mesh axes.
:func:`logical_to_pspec` drops any assignment that does not divide evenly
into the mesh (e.g. qwen2's 12 query heads over a 16-way "model" axis fall
back to replication), with the reference's greedy rule, so the specs are
the reference's for any mesh.  The rule functions take a
``DeviceMesh``, a plain ``{axis: size}`` mapping, or anything with
``axis_names`` and a ``devices`` array (a JAX mesh's attributes), so a
(2, 16, 16) mesh can be reasoned about without 512 ranks.
:func:`to_placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

# Logical axis vocabulary ------------------------------------------------
#   embed   : d_model dim of weights
#   heads   : query-head dim
#   kv      : kv-head dim
#   mlp     : ffn hidden dim
#   vocab   : vocabulary dim
#   expert  : MoE expert dim
#   expert_mlp : per-expert ffn hidden dim (2nd shard axis for giant MoE)
#   layers  : stacked layer dim (never sharded)
#   conv    : ssm conv kernel dim (never sharded)
#   state   : ssm state dim (never sharded)
#   batch   : activation batch
#   seq     : activation sequence
#   act_embed : activation d_model

AxisAssign = Union[None, str, Tuple[str, ...]]

POLICIES: Dict[str, Dict[str, AxisAssign]] = {
    # Pure tensor parallel: weights replicated over "data"/"pod".
    "tp": {
        "embed": None,
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "data",
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": "model",
        "batch": ("pod", "data"),
        "seq": None,
        "act_embed": None,
        "act_seq_train": "model",
        "cache_seq": ("model", "data", "pod"),
        "cache_batch": ("pod", "data"),
    },
    # FSDP x TP: weights additionally sharded over "data" on the non-TP dim.
    "fsdp_tp": {
        "embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "data",
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": "model",
        "batch": ("pod", "data"),
        "seq": None,
        "act_embed": None,
        "act_seq_train": "model",
        "cache_seq": ("model", "data", "pod"),
        "cache_batch": ("pod", "data"),
    },
    # fsdp_tp with sequence-sharded activations: attention K/V gathers
    # over "model" and the MoE uses the a2a route.
    "fsdp_tp_seq": {
        "embed": "data",
        "heads": None,          # tokens are seq-sharded, not head-sharded
        "kv": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": "data",
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": None,
        "batch": ("pod", "data"),
        "seq": "model",
        "act_embed": None,
        "act_seq_train": "model",
        "cache_seq": ("model", "data", "pod"),
        "cache_batch": ("pod", "data"),
    },
    # Pure ZeRO-3 data parallelism over the whole mesh: batch sharded over
    # every axis, weights sharded over (data, model) jointly on one dim.
    "fsdp": {
        "embed": ("data", "model"),   # ragged vocabs shard on D instead
        "heads": None,
        "kv": None,
        "mlp": ("data", "model"),
        "vocab": ("data", "model"),
        "expert": ("data", "model"),
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": None,
        "batch": ("pod", "data", "model"),
        "seq": None,
        "act_embed": None,
        "act_seq_train": None,
        "cache_seq": ("model",),
        "cache_batch": ("pod", "data"),
    },
    # Serving with replicated weights and sequence-sharded activations:
    # the attention K/V gathers over "model" are the only collective
    # (sliding-window layers exchange a halo, serving.halo_attention).
    "seq_serve": {
        "embed": None,
        "heads": None,
        "kv": None,
        "mlp": None,
        "vocab": None,
        "expert": None,
        "expert_mlp": None,
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": None,
        "batch": ("pod", "data"),
        "seq": "model",
        "act_embed": None,
        "act_seq_train": None,
        "cache_seq": "model",
        "cache_batch": ("pod", "data"),
    },
}


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of names (major to minor) — the entries
    of the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a mapping, or an object with
    ``axis_names`` and a ``devices`` array."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    return dict(zip(mesh.axis_names, (int(n) for n in mesh.devices.shape)))


def _assign_size(assign: AxisAssign, sizes: Dict[str, int]) -> int:
    if assign is None:
        return 1
    if isinstance(assign, str):
        return sizes.get(assign, 1)
    return math.prod(sizes.get(a, 1) for a in assign)


def _filter_assign(assign: AxisAssign, sizes: Dict[str, int]) -> AxisAssign:
    """Drop mesh axes absent from the mesh (e.g. 'pod' on single-pod)."""
    if assign is None:
        return None
    if isinstance(assign, str):
        return assign if assign in sizes else None
    kept = tuple(a for a in assign if a in sizes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_pspec(shape: Sequence[int],
                     logical: Sequence[Optional[str]], mesh,
                     policy: str) -> P:
    """The spec for ``shape`` annotated with ``logical`` axes under
    ``policy``: each dim keeps, greedily in the rule's order, every mesh
    axis that exists, is larger than 1, is not used by an earlier dim, and
    keeps the dim divisible; a dim that keeps none is replicated."""
    rules = POLICIES[policy]
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, ax in zip(shape, logical):
        assign = rules.get(ax) if ax else None
        if assign is None:
            out.append(None)
            continue
        names = (assign,) if isinstance(assign, str) else tuple(assign)
        kept = []
        prod = 1
        for n in names:
            if (n in sizes and n not in used
                    and dim % (prod * sizes[n]) == 0 and sizes[n] > 1):
                kept.append(n)
                prod *= sizes[n]
        if not kept:
            out.append(None)
            continue
        used.update(kept)
        out.append(tuple(kept) if len(kept) > 1 else kept[0])
    return P(*out)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def tree_pspecs(shapes: Dict, logical: Dict, mesh, policy: str
                ) -> Dict[str, P]:
    """``{path: spec}`` for a flat ``{path: tensor | ParamSpec | shape}``
    tree and its ``{path: logical axes}`` (``param.logical_axes``)."""
    return {k: logical_to_pspec(_shape(v), logical[k], mesh, policy)
            for k, v in shapes.items()}


def tree_size_bytes(tree) -> int:
    """Bytes of every tensor in a flat or nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def to_placements(spec: Sequence[AxisAssign], mesh) -> tuple:
    """DTensor placements of ``spec`` over a ``DeviceMesh``: one per mesh
    dim, ``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis,
    ``Replicate()`` elsewhere.  A dim sharded over several axes is split
    in mesh-dim order: the spec's major-to-minor order where it lists the
    axes in mesh order, as every weight rule does (the cache rule
    ``cache_seq`` lists them the other way)."""
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:   # PyTorch before 2.4 kept them private
        from torch.distributed._tensor import Replicate, Shard
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for n in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[n] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def constrain(x, mesh, policy: str, *logical: str):
    """The reference pins activations to a sharding here
    (``with_sharding_constraint``), which never changes their values.  In
    the port each rank holds its own local tensors and the sharded
    islands move data explicitly, so there is nothing to pin: ``x`` is
    returned as it is."""
    return x
