"""Atomic per-step checkpoints (``repro.distributed.checkpoint``), in the
reference's layout, so that either package restores the other's.

Layout: one ``step_<10 digits>`` directory per step; each leaf of the tree
becomes ``leaf_<5 digits>.npy``, numbered in the reference's leaf order,
plus a ``manifest.json`` mapping the reference's path strings
(``jax.tree_util.keystr``: ``['params']['decoder']['attn']['wq']``,
``['opt'][3]['m']``, ``['step']``) to file, shape and dtype, with the step
and an ``extra`` dict.  bf16 leaves are stored as their uint16 bits with
``"dtype": "bfloat16"`` (npy has no bf16).  Writes go to ``<dir>.tmp`` and
are published with one ``os.replace``, so a preempted writer never leaves
a torn checkpoint; ``latest_step`` reads only published directories.

Trees are nested dicts and lists whose leaves are tensors or Python ints
(the port's train state: ``{"params": {dotted path: tensor},
"opt": [slot dicts], "step": int}``).  A dict's keys are walked in sorted
order and a dotted key is split into its path (``"decoder.attn.wq"`` ->
``['decoder']['attn']['wq']``): the sorted dotted paths walk the leaves in
the order the reference's sorted nested dicts do.  A Python int leaf is
stored as an int32 0-dim array, as the reference's step.

A sharded tree (``DTensor`` leaves, the sharded train step's state) is
saved whole: every rank gathers each leaf (collective) and rank 0 alone
writes, so the layout, and either package's restore, is the same as for
an unsharded tree.  ``restore(..., shardings=)`` reads each rank's block of
every leaf only (``np.load`` with ``mmap_mode``) and returns it placed as
the matching ``sharding.NamedSharding`` says, onto any mesh.

``save_json`` / ``load_json`` persist a campaign's loop state.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


def _key(k) -> str:
    if isinstance(k, int):
        return f"[{k}]"
    return "".join(f"['{p}']" for p in str(k).split("."))


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(reference path string, leaf) in the reference's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + _key(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + _key(i))
    else:
        yield prefix, tree


def _rebuild(tree, values: Iterator):
    """``tree``'s structure with its leaves taken from ``values`` in
    :func:`leaves` order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], values) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A tensor or Python int leaf -> (the array stored, its dtype name)."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if shd.is_placed(leaf):
        leaf = shd.full_tree(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         write: bool = True) -> str:
    """Atomically write ``tree`` under ``ckpt_dir/step_<n>``.  Every rank
    of a sharded tree calls it (each ``DTensor`` leaf is gathered); only
    the caller with ``write`` set writes."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if write:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for i, (key, leaf) in enumerate(leaves(tree)):
        arr, dtype_name = _to_numpy(leaf)
        if not write:
            continue
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
    if not write:
        return final
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, meta: Dict, like, sharding=None):
    """One stored array as ``like``'s kind of leaf: a Python int, or a
    tensor of its dtype on its device; with a ``sharding``, a ``DTensor``
    of this rank's block, read from ``arr`` alone."""
    if isinstance(like, int):
        return int(arr)
    if sharding is not None:
        arr = arr[shd.slices(arr.shape, sharding.spec, sharding.mesh)]
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if shd.is_placed(like):
        like = like.to_local()
    t = t.to(device=like.device, dtype=like.dtype)
    if sharding is None:
        return t
    return shd.place(t, sharding, meta["shape"])


def restore(ckpt_dir: str, step: int, like_tree,
            shardings=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like_tree``; returns (tree,
    manifest).  Each leaf is found by its reference path string, so a
    checkpoint the reference wrote restores here, and takes the kind,
    dtype and device of ``like_tree``'s leaf.  ``shardings``: a matching
    tree of ``sharding.NamedSharding`` (None at int leaves): each leaf
    comes back a ``DTensor`` of this rank's block on that mesh (the
    reference's elastic re-mesh)."""
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = list(leaves(like_tree))
    shs = [None] * len(like) if shardings is None else \
        [sh for _, sh in leaves(shardings)]
    assert len(shs) == len(like), (len(shs), len(like))
    out: List = []
    for (key, leaf), sh in zip(like, shs):
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
        out.append(_from_numpy(arr, meta, leaf, sh))
    return _rebuild(like_tree, iter(out)), manifest


def save_json(path: str, obj: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def load_json(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
