"""Logical-axis sharding rules (``repro.distributed.sharding``;
MaxText-style, divisibility-aware), and the port's placement of a tree on
a mesh.

Every parameter carries logical axis names (``models.param.ParamSpec``'s
``logical``); a policy maps logical axes to mesh axes.
:func:`logical_to_pspec` drops any assignment that does not divide evenly
into the mesh (e.g. qwen2's 12 query heads over a 16-way "model" axis fall
back to replication), with the reference's greedy rule, so the specs are
the reference's for any mesh.  The rule functions take a
``DeviceMesh``, a plain ``{axis: size}`` mapping, or anything with
``axis_names`` and a ``devices`` array (a JAX mesh's attributes), so a
(2, 16, 16) mesh can be reasoned about without 512 ranks.

Placement (GSPMD's ``NamedSharding`` has no direct twin): a leaf stored as
a spec says is a ``DTensor`` of this rank's slice (:func:`distribute`,
:func:`slices`), its placements :func:`to_placements` of the spec, so that
``.placements`` records the sharding and ``.full_tensor()`` the whole.
Compute never runs on DTensors.  :func:`whole` all-gathers a leaf from
its shards over the axes its spec names (``collectives.all_gather``, whose
backward is a reduce-scatter) just before its one use.  :func:`block` and
:func:`layer` apply the policy's rule dim by dim instead: a dim split over
an axis that also splits the activation rows (the policy's ``batch``, and
its ``seq`` under ``fsdp_tp_seq``) is ZeRO-style storage and is gathered
at its use; a dim split over any other axis (``heads``, ``kv``, ``mlp``,
``vocab``, ``expert`` over "model" under ``tp`` and ``fsdp_tp``) is
tensor-parallel, and the layer computes on this rank's block of it, a
:class:`Local` (:func:`tp_dims` names those dims).  A consumer that
moves some axes itself takes the dims over them as stored too: the MoE's
``shard_map`` island gathers or sums its experts' F over "data" on its
own route.  :class:`MeshView` is the mesh as the sharded model code sees it: the policy, which axes split
the batch rows, whether collectives run over axes of one rank too, and
each thread's own copy of the groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

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
                     policy: str, keep_unit: bool = False) -> P:
    """The spec for ``shape`` annotated with ``logical`` axes under
    ``policy``: each dim keeps, greedily in the rule's order, every mesh
    axis that exists, is larger than 1, is not used by an earlier dim, and
    keeps the dim divisible; a dim that keeps none is replicated.
    ``keep_unit`` keeps axes of one rank too (a one-rank mesh that takes
    every collective of the policy; not the reference's specs)."""
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
                    and dim % (prod * sizes[n]) == 0
                    and (sizes[n] > 1 or keep_unit)):
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


def tree_pspecs(shapes: Dict, logical: Dict, mesh, policy: str,
                keep_unit: bool = False) -> Dict[str, P]:
    """``{path: spec}`` for a flat ``{path: tensor | ParamSpec | shape}``
    tree and its ``{path: logical axes}`` (``param.logical_axes``)."""
    return {k: logical_to_pspec(_shape(v), logical[k], mesh, policy,
                                keep_unit)
            for k, v in shapes.items()}


def tree_size_bytes(tree) -> int:
    """Bytes of every tensor in a flat or nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _axes(entry: AxisAssign) -> Tuple[str, ...]:
    """A spec entry's mesh axes, major first."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _placement_types():
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:   # PyTorch before 2.4 kept them private
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


def to_placements(spec: Sequence[AxisAssign], mesh) -> tuple:
    """DTensor placements of ``spec`` over a ``DeviceMesh``: one per mesh
    dim, ``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis,
    ``Replicate()`` elsewhere.  A dim sharded over several axes is split
    in mesh-dim order: the spec's major-to-minor order where it lists the
    axes in mesh order, as every weight rule does (the cache rule
    ``cache_seq`` lists them the other way, and no tree is stored under
    it: the serving engine's caches hold each rank's rows as plain
    tensors)."""
    Replicate, Shard = _placement_types()
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for n in _axes(entry):
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


# ---------------------------------------------------------------------------
# placement: a tree stored as its specs say, on this rank of a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The twin of ``jax.sharding.NamedSharding``: ``spec`` over ``mesh``
    (a ``DeviceMesh``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def named(mesh, spec: Sequence[AxisAssign]) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def tree_named(mesh, specs):
    """:func:`named` over every spec of a nested dict / list tree."""
    if isinstance(specs, P):
        return named(mesh, specs)
    if isinstance(specs, dict):
        return {k: tree_named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(tree_named(mesh, v) for v in specs)
    return specs


def coords(mesh) -> Dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def _entry_index(entry: AxisAssign, sizes: Dict[str, int],
                 at: Dict[str, int]) -> Tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a dim split over
    ``entry``'s axes, the first axis major."""
    idx, parts = 0, 1
    for a in _axes(entry):
        idx, parts = idx * sizes[a] + at[a], parts * sizes[a]
    return idx, parts


def slices(shape: Sequence[int], spec: Sequence[AxisAssign], mesh,
           at: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The index of this rank's block of a whole ``shape`` array under
    ``spec``; ``at`` (``{axis: index}``) stands for the rank's coordinates
    where ``mesh`` is a plain ``{axis: size}`` mapping."""
    sizes = mesh_axis_sizes(mesh)
    at = coords(mesh) if at is None else at
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        idx, parts = _entry_index(entry, sizes, at)
        n = dim // parts
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def local_slice(x, spec: Sequence[AxisAssign], mesh,
                at: Optional[Dict[str, int]] = None):
    """This rank's block of the whole tensor (or array) ``x``."""
    return x[slices(x.shape, spec, mesh, at)]


def _dtensor():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:   # PyTorch before 2.4 kept it private
        from torch.distributed._tensor import DTensor
    return DTensor


def is_placed(x) -> bool:
    """Whether ``x`` is a leaf stored as a spec says (a ``DTensor``)."""
    return type(x).__name__ == "DTensor" and isinstance(x, _dtensor())


def place(local, sharding: NamedSharding, shape: Sequence[int]):
    """A ``DTensor`` over ``sharding`` from this rank's block ``local`` of
    a whole tensor of ``shape`` (no collective, no check)."""
    import torch
    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return _dtensor().from_local(local, sharding.mesh, sharding.placements,
                                 run_check=False, shape=shape,
                                 stride=tuple(stride))


def distribute(x, sharding: NamedSharding):
    """The whole tensor ``x`` (the same on every rank) stored as
    ``sharding`` says: a ``DTensor`` of this rank's block (copied, so that
    ``x`` can be freed, unless the block is all of ``x``)."""
    import torch
    blk = local_slice(x, sharding.spec, sharding.mesh)
    if blk.numel() != x.numel():
        blk = blk.clone(memory_format=torch.contiguous_format)
    return place(blk, sharding, x.shape)


def spec_of(x) -> P:
    """The spec a ``DTensor``'s placements record (mesh-dim order is the
    major-to-minor order of a dim split over several axes)."""
    entries: list = [[] for _ in range(x.ndim)]
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


class Local(NamedTuple):
    """A rank's block of a leaf and the spec it was cut by: what a layer
    computes on in place of the whole weight along its tensor-parallel
    dims (the spec names only those)."""
    t: Any
    spec: P


def local(x):
    """The tensor a layer computes on: a :class:`Local`'s block, or ``x``."""
    return x.t if isinstance(x, Local) else x


def row_axes(policy: str) -> Tuple[str, ...]:
    """The mesh axes ``policy`` splits activation rows over: its ``batch``
    axes, and its ``seq`` axes (``fsdp_tp_seq``, ``seq_serve``)."""
    rules = POLICIES[policy]
    return tuple(dict.fromkeys(_axes(rules.get("batch"))
                               + _axes(rules.get("seq"))))


class MeshView:
    """A ``DeviceMesh`` as the sharded model code sees it, passed as the
    ``mesh`` of ``Model.forward`` / ``prefill`` / ``decode_step``.

    * ``rows``: the mesh axes the batch rows the model is given are split
      over (major first): each rank holds its own rows of the global
      batch, and ranks along the other axes hold the same rows;
    * ``force``: take every collective even over axes of one rank (a
      one-rank mesh that runs the sharded code, not the local one);
    * ``threads``: thread names that each get their own copy of every
      axis's group (``launch.mesh.thread_groups``, made here, on every
      rank in the same order), so that passes issued from several threads
      never interleave their collectives on one group;
    * ``policy``: the policy the params are stored under, whose rule
      (:func:`tp_dims`) says which dims a layer computes on as blocks and
      how a serving cache is split (:func:`cache_pspec`); without one
      every leaf is gathered whole and no cache is split.

    It answers ``mesh_dim_names``, ``size``, ``get_group`` (the calling
    thread's copy where it has one) and ``get_local_rank`` as the mesh
    does, so ``collectives.Axis.of`` and halo attention take it as a
    mesh."""

    def __init__(self, mesh, rows: Sequence[str] = (), force: bool = False,
                 threads: Sequence[str] = (), policy: Optional[str] = None):
        self.mesh = mesh.mesh if isinstance(mesh, MeshView) else mesh
        self.rows = tuple(rows)
        self.force = force
        self.policy = policy
        self.mesh_dim_names = tuple(self.mesh.mesh_dim_names)
        self._groups: Dict[str, Dict[str, Any]] = {}
        if threads:
            from repro_torch.launch.mesh import thread_groups
            self._groups = {a: thread_groups(self.mesh, a, threads)
                            for a in self.mesh_dim_names}

    def size(self, dim: Optional[int] = None) -> int:
        return self.mesh.size(dim)

    @property
    def shape(self):
        return self.mesh.shape

    def get_local_rank(self, name: str) -> int:
        return self.mesh.get_local_rank(name)

    def get_group(self, name: str):
        groups = self._groups.get(name)
        if groups:
            from repro_torch.launch.mesh import group_of_thread
            return group_of_thread(groups)
        return self.mesh.get_group(name)

    def sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def active(self, axis: str) -> bool:
        """Whether collectives run over ``axis``: it exists and has more
        than one rank, or the view is forced."""
        size = self.sizes().get(axis)
        return size is not None and (size > 1 or self.force)

    def with_rows(self, rows: Sequence[str]) -> "MeshView":
        """This view with its batch rows split over ``rows`` instead."""
        out = object.__new__(MeshView)
        out.__dict__.update(self.__dict__, rows=tuple(rows))
        return out


def _axis(mesh, name: str):
    from repro_torch.distributed.collectives import Axis
    return Axis.of(mesh, name)


def gather(local, spec: Sequence[AxisAssign], mesh):
    """The whole tensor from this rank's block cut by ``spec``: for each
    dim, an all-gather over each axis of its entry, the minor axis first.
    Differentiable: its backward reduce-scatters, the sum over ranks that
    ranks holding different rows need."""
    from repro_torch.distributed.collectives import all_gather
    x = local
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            x = all_gather(x, d, _axis(mesh, a))
    return x


def narrow(x, spec: Sequence[AxisAssign], mesh):
    """This rank's block of a tensor whole along ``spec``'s dims (a view;
    its gradient is zero outside the block)."""
    sizes = mesh_axis_sizes(mesh)
    at = {a: int(mesh.get_local_rank(a)) for a in sizes}
    for d, entry in enumerate(spec):
        idx, parts = _entry_index(entry, sizes, at)
        if parts > 1:
            n = x.shape[d] // parts
            x = x.narrow(d, idx * n, n)
    return x


def relayout(local, have: Sequence[AxisAssign], want: Sequence[AxisAssign],
             mesh):
    """A block cut by spec ``have`` as the block ``want`` cuts: the dims
    whose entries differ are gathered whole, then narrowed."""
    n = max(len(have), len(want))
    have = tuple(have) + (None,) * (n - len(have))
    want = tuple(want) + (None,) * (n - len(want))
    if have == want:
        return local
    differ = [d for d in range(n) if _axes(have[d]) != _axes(want[d])]
    x = gather(local, [have[d] if d in differ else None for d in range(n)],
               mesh)
    return narrow(x, [want[d] if d in differ else None for d in range(n)],
                  mesh)


def whole(x, mesh=None):
    """A leaf whole on this rank: a ``DTensor`` gathered from its blocks
    over ``mesh``'s groups (a :class:`MeshView`'s thread copies; the
    tensor's own mesh when None); a :class:`Local` likewise; a plain tensor
    as it is."""
    if isinstance(x, Local):
        return gather(x.t, x.spec, mesh)
    if is_placed(x):
        return gather(x.to_local(), spec_of(x), mesh if mesh is not None
                      else x.device_mesh)
    return x


def tp_dims(spec: Sequence[AxisAssign], policy: Optional[str],
            own: Sequence[str] = ()) -> Dict[int, Tuple[str, ...]]:
    """``{dim: axes}``: the dims of a leaf's ``spec`` that are
    tensor-parallel under ``policy``, those split over axes none of which
    splits the activation rows (:func:`row_axes`), leaving out the axes
    ``own`` that the leaf's consumer moves itself (the MoE's ``shard_map``
    island takes its experts as stored).  Empty without a policy: every
    dim is then storage."""
    if policy is None:
        return {}
    rows = set(row_axes(policy)) - set(own)
    return {d: _axes(e) for d, e in enumerate(spec)
            if _axes(e) and not rows & set(_axes(e))}


def _by_rule(blk, spec: Sequence[AxisAssign], mesh, own: Sequence[str] = ()):
    """A block cut by ``spec`` as the layer computes on it: gathered over
    the storage dims' axes; a :class:`Local` of the tensor-parallel dims
    where there are any, else the whole tensor."""
    tp = tp_dims(spec, getattr(mesh, "policy", None), own)
    x = gather(blk, [None if d in tp else e for d, e in enumerate(spec)],
               mesh)
    if not tp:
        return x
    return Local(x, P(*(e if d in tp else None for d, e in enumerate(spec))))


def block(x, mesh=None):
    """A leaf as a layer computes on it (:func:`tp_dims`'s rule): a
    ``DTensor``'s or :class:`Local`'s storage dims gathered, its
    tensor-parallel dims kept as this rank's block (a :class:`Local`); a
    plain tensor as it is."""
    if isinstance(x, Local):
        return _by_rule(x.t, x.spec, mesh)
    if is_placed(x):
        return _by_rule(x.to_local(), spec_of(x),
                        mesh if mesh is not None else x.device_mesh)
    return x


def layer(tree, i: Optional[int], mesh=None,
          keep: Optional[Mapping[str, Sequence[str]]] = None,
          prefix: str = ""):
    """Layer ``i`` of stacked block params (a nested dict; ``i`` None: an
    unstacked block): a plain leaf's slice ``i`` (a view), a ``DTensor``'s
    block of slice ``i`` gathered whole over the axes its spec names (the
    stacked ``layers`` dim is never sharded).  Leaves under a dotted path
    in ``keep`` take the rule instead (:func:`block`): their
    tensor-parallel dims stay this rank's block, with the longest such
    path's axes taken as their consumer's own (:func:`tp_dims`)."""
    if isinstance(tree, dict):
        return {k: layer(v, i, mesh, keep, f"{prefix}{k}.")
                for k, v in tree.items()}
    if not is_placed(tree):
        return tree if i is None else tree[i]
    spec = spec_of(tree)
    blk = tree.to_local()
    if i is not None:
        assert spec[0] is None, f"a stacked layers dim is sharded: {spec}"
        blk, spec = blk[i], P(*spec[1:])
    mesh = mesh if mesh is not None else tree.device_mesh
    path = prefix[:-1]
    under = [k for k in keep or () if path == k or path.startswith(k + ".")]
    if under:
        return _by_rule(blk, spec, mesh, keep[max(under, key=len)])
    return gather(blk, spec, mesh)


def cache_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a serving cache's sequence may split over on ``mesh``
    (a :class:`MeshView`): its policy's ``cache_seq`` axes that the view
    takes collectives over and that do not split its rows (the
    reference's ``cache_batch`` takes the batch axes first).  A sequence
    whose length every prefix of them divides takes them all (the
    engine's cache length is rounded so); :func:`cache_pspec` gives the
    split of any length.  Empty without a view or a policy."""
    policy = getattr(mesh, "policy", None)
    if policy is None:
        return ()
    return tuple(a for a in _axes(POLICIES[policy].get("cache_seq"))
                 if a not in mesh.rows and mesh.active(a))


def cache_pspec(mesh, shape: Sequence[int],
                logical: Sequence[Optional[str]]) -> P:
    """The spec of a serving cache leaf of ``shape`` with the reference's
    ``logical`` axes (its ``cache_specs``) on ``mesh`` (a
    :class:`MeshView`): its ``cache_batch`` dim over the view's rows, every
    other dim by :func:`logical_to_pspec`'s greedy rule over the axes the
    rows leave (so a sequence that does not divide "model" leaves it to
    the kv heads, or the SSM heads, as the reference's rule does).  All
    dims whole without a view or a policy."""
    policy = getattr(mesh, "policy", None)
    if policy is None:
        return P(*(None,) * len(shape))
    sizes = {a: n for a, n in mesh.sizes().items()
             if a not in mesh.rows and mesh.active(a)}
    spec = logical_to_pspec(
        shape, [None if ax == "cache_batch" else ax for ax in logical],
        sizes, policy, keep_unit=mesh.force)
    rows = (mesh.rows if len(mesh.rows) > 1 else mesh.rows[0]) \
        if mesh.rows else None
    return P(*(rows if ax == "cache_batch" else e
               for e, ax in zip(spec, logical)))


def block_start(entry: AxisAssign, n_local: int, mesh) -> int:
    """The first index of this rank's block of a dim cut by ``entry`` into
    blocks of ``n_local``."""
    sizes = mesh_axis_sizes(mesh)
    at = {a: int(mesh.get_local_rank(a)) for a in _axes(entry)}
    return _entry_index(entry, sizes, at)[0] * n_local


def whole_tree(tree, mesh=None):
    """:func:`whole` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: whole_tree(v, mesh) for k, v in tree.items()}
    return whole(tree, mesh)


def rows_to(x, have: Sequence[str], want: Sequence[str], mesh, dim: int = 0):
    """Rows split over the axes ``have`` (major first) as the split over
    ``want``: gathered over ``have``, then this rank's block of ``want``
    (differentiable)."""
    if tuple(have) == tuple(want):
        return x
    spec = [None] * x.ndim
    spec[dim] = tuple(have) or None
    x = gather(x, spec, mesh)
    spec[dim] = tuple(want) or None
    return narrow(x, spec, mesh)


def map_leaves(fn, tree):
    """``fn`` over the leaves of a nested dict / list tree (ints and
    tensors alike)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def zip_leaves(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: zip_leaves(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(zip_leaves(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def shard_tree(tree, shardings):
    """A tree of whole tensors (the same on every rank) stored as the
    matching tree of :class:`NamedSharding` says; int leaves and leaves
    whose sharding is None stay as they are."""
    def put(x, sh):
        if sh is None or not hasattr(x, "shape") or is_placed(x):
            return x
        return distribute(x, sh)
    return zip_leaves(put, tree, shardings)


def full_tree(tree):
    """Every ``DTensor`` leaf of a tree gathered whole (collective: every
    rank calls it), outside autograd; other leaves as they are."""
    import torch
    with torch.no_grad():
        return map_leaves(lambda x: whole(x) if is_placed(x) else x, tree)
