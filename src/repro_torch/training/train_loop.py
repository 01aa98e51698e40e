"""Train step + train state (``repro.training.train_loop``): the LM loss
over tokens and labels for the token families, or the classification head
the live labeling campaigns train (``cfg.num_classes``).

State is ``{"params": {path: tensor}, "opt": [slots], "step": int}``; the
step count lives on the host, so the schedule and bias corrections need
no device round trip.  Gradients come from ``torch.autograd``.  A step
given ``consts`` (``lr`` and the bias corrections' reciprocals as 0-dim
device tensors) reads no host step count: the form a CUDA graph captures.
The step runs on the params' device.

:func:`make_sharded_train_step` is the reference's step sharded by policy
over a mesh of ranks (``training.compressed_dp`` holds the
replicated-parameter data-parallel one).  The state is stored as
:func:`state_pspecs` says: every parameter and slot a ``DTensor`` of this
rank's block.  The values are those of the unsharded step; the work is
split as the policy places it: each rank computes on its rows of the
batch (split over the batch spec's axes); a weight dim whose axis also
splits the rows is storage, gathered just before its use (inside the
layer's recomputed body, so that the backward gathers again; the
gather's backward reduce-scatters), and a dim split over another axis
("model" under ``tp`` and ``fsdp_tp``) is tensor-parallel: the ranks
along it compute the same rows on their own heads, MLP columns, experts
and vocabulary block, summed over the axis (``transformer``); under
``fsdp_tp_seq`` they compute their block of the rows' positions
(``transformer.seq_split``) and the loss sums the blocks' shares over the
axis.  Each rank's loss is its rows' mean over the number of ranks, so
that the ranks' losses sum to the global mean and every row counts once;
a leaf's gradient is then summed over the axes its spec leaves whole.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import DTYPES, TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import param as P
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule


def loss_fn(model, params: Dict, batch: Dict, mesh=None) -> torch.Tensor:
    """The reference's loss: the classification head's mean cross-entropy
    on the mean-pooled hidden state, or the LM's mean token cross-entropy
    against ``batch["labels"]`` through the tied or explicit head (a VLM's
    on its text positions only), vocab-chunked when ``cfg.logits_chunk``
    is set and over materialized fp32 logits otherwise.  Over a ``mesh``
    (a ``MeshView``), the mean over this rank's rows; where the head's
    vocabulary is tensor-parallel over axes of more than one rank, the
    reference's vocabulary-parallel branch (:func:`_vocab_parallel_ce`:
    this rank's fp32 logits, the softmax's statistics merged over the
    axes), else the head gathered whole.  Over a sequence split
    (``transformer.seq_split``, every token family: a decoder's positions,
    an SSM's or a hybrid's, whisper's decoder tokens) each rank takes the
    cross-entropy of its own positions (:func:`_split_ce`)."""
    cfg = model.cfg
    seq = None
    if not cfg.num_classes and "tokens" in batch:
        fe = batch.get("patch_embeds")
        T = batch["tokens"].shape[1] + (0 if fe is None else fe.shape[1])
        seq = tf.seq_split(cfg, mesh, T)
    hidden = model.forward(params, batch, mesh=mesh, whole=seq is None)
    if seq is not None:
        # the vocabulary is storage under the split's policies: the head
        # comes whole
        return _split_ce(cfg, hidden, tf.lm_head_block(cfg, params, mesh),
                         batch["labels"], seq)
    if cfg.num_classes:
        pooled = torch.mean(hidden.float(), dim=1)
        logits = pooled.to(hidden.dtype) @ shd.whole(params["cls_head"],
                                                     mesh)
        return L.cross_entropy(logits, batch["labels"])
    labels = batch["labels"]
    if cfg.family == "vlm" and cfg.frontend_tokens:
        hidden = hidden[:, cfg.frontend_tokens:, :]  # the text positions
    w = tf.lm_head_block(cfg, params, mesh)
    if isinstance(w, shd.Local):
        sizes = mesh.sizes()
        if math.prod(sizes[a] for a in shd._axes(w.spec[1])) > 1:
            return _vocab_parallel_ce(hidden, w, labels, mesh)
        w = shd.whole(w, mesh)
    return _ce(cfg, hidden, w, labels)


def _ce(cfg, hidden: torch.Tensor, w: torch.Tensor,
        labels: torch.Tensor) -> torch.Tensor:
    """The mean token cross-entropy through the whole head ``w`` (D, V):
    vocab-chunked where ``cfg.logits_chunk`` is set, over materialized
    fp32 logits otherwise."""
    if cfg.logits_chunk:
        return L.chunked_cross_entropy(hidden, w, labels,
                                       chunk=cfg.logits_chunk)
    logits = torch.einsum("btd,dv->btv", hidden.float(), w.float())
    return L.cross_entropy(logits, labels)


def _split_ce(cfg, hidden: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor, seq: "tf.SeqSplit") -> torch.Tensor:
    """The rows' mean token cross-entropy over a sequence split: this
    rank's positions' mean (of a VLM's, its text positions') weighted by
    their share of the sequence's text positions, summed over the split's
    axis (its transpose sums too, as the step's loss sums the ranks'), so
    that every rank of the axis returns the whole sequence's mean.  A rank
    whose block is all patches adds an empty product with the head, which
    keeps its gathers and the axis's sum in the graph on every rank.  On
    one forced rank the share is 1.0 and the sum runs over that rank: the
    unsplit loss to the bit."""
    from repro_torch.distributed import collectives as C
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    T_loc = hidden.shape[1]
    lo, hi = max(seq.start, P), seq.start + T_loc
    if hi > lo:
        part = _ce(cfg, hidden[:, lo - seq.start:], w,
                   labels[:, lo - P:hi - P]) * ((hi - lo) / (seq.total - P))
    else:
        part = (hidden[:, :0].float() @ w.float()).sum()
    return C.psum(part, seq.axis, varying=True)


def _vocab_parallel_ce(hidden: torch.Tensor, w: "shd.Local",
                       labels: torch.Tensor, mesh) -> torch.Tensor:
    """The mean token cross-entropy from this rank's vocabulary block of
    the head (D, V_loc): its (B, T, V_loc) fp32 logits (the reference's
    fp32-result product), the max over the vocabulary's axes (no
    gradient; it only steadies the exponentials), the sum of exponentials
    and the label's logit (from the rank whose block holds it) each summed
    over them."""
    from repro_torch.distributed import collectives as C
    axes = [C.Axis.of(mesh, a) for a in shd._axes(w.spec[1])]
    logits = torch.einsum("btd,dv->btv", hidden.float(), w.t.float())
    m = logits.detach().amax(dim=-1)
    for ax in axes:
        m = C.all_reduce_max(m, ax)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    V_loc = logits.shape[-1]
    idx = labels.long() - shd.block_start(w.spec[1], V_loc, mesh)
    mine = (idx >= 0) & (idx < V_loc)
    ll = torch.gather(logits, -1, idx.clamp(0, V_loc - 1)[..., None])[..., 0]
    ll = torch.where(mine, ll, torch.zeros_like(ll))
    for ax in axes:
        s = C.psum(s, ax, varying=True)
        ll = C.psum(ll, ax, varying=True)
    return torch.mean(m + torch.log(s) - ll)


def init_train_state(model, tc: TrainConfig, params: Dict) -> Dict:
    """Fresh optimizer state around ``params`` (from ``model.init`` or
    carried in)."""
    return {"params": dict(params), "opt": opt.init_slots(params, tc),
            "step": 0}


def abstract_train_state(model, tc: TrainConfig) -> Tuple[Dict, Dict]:
    """(abstract state, logical-axes state) without allocating anything:
    ``{"params": {path: (shape, dtype)}, "opt": [{slot: (shape, dtype)}],
    "step": ((), int32)}`` and the same tree of logical axes."""
    specs = list(P.iter_specs(model.specs))
    ab = {"params": {k: (sp.shape, sp.dtype) for k, sp in specs},
          "opt": [opt.slot_spec(sp.shape, tc) for _, sp in specs],
          "step": ((), torch.int32)}
    lg = {"params": {k: sp.logical for k, sp in specs},
          "opt": [opt.slot_logical(sp.shape, sp.logical, tc)
                  for _, sp in specs],
          "step": ()}
    return ab, lg


def state_pspecs(model, tc: TrainConfig, mesh, policy: str,
                 keep_unit: bool = False) -> Tuple[Dict, Dict]:
    """(abstract state, its specs under ``policy`` on ``mesh``): optimizer
    slots take their parameter's axes (ZeRO), as the reference's."""
    ab, lg = abstract_train_state(model, tc)

    def spec(shape_dtype, logical):
        return shd.logical_to_pspec(shape_dtype[0], logical, mesh, policy,
                                    keep_unit)
    return ab, {"params": {k: spec(v, lg["params"][k])
                           for k, v in ab["params"].items()},
                "opt": [{k: spec(v, lg_s[k]) for k, v in ab_s.items()}
                        for ab_s, lg_s in zip(ab["opt"], lg["opt"])],
                "step": shd.P()}


def _step_fn(model, tc: TrainConfig, grads_of, whole_sums=None,
             layouts=None, unwrap=None, wrap=None):
    """The step around ``grads_of(params, batch) -> (loss, grads)``:
    gradient accumulation, the global norm clip, the schedule and AdamW.
    ``unwrap`` / ``wrap`` take a state's leaves to the tensors the update
    runs on and back (a sharded state's DTensors)."""
    sched = make_schedule(tc)

    def step(state, batch, consts=None):
        params, slots = state["params"], state["opt"]
        if unwrap is not None:
            params, slots = unwrap(params, slots)
        params = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        if tc.grad_accum > 1:
            acc_dt = DTYPES[tc.accum_dtype]
            loss = 0.0
            grads = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            for i in range(tc.grad_accum):
                l_i, g_i = grads_of(params, {k: v[i]
                                             for k, v in batch.items()})
                loss = loss + l_i
                grads = {k: grads[k] + g_i[k].to(acc_dt) for k in grads}
            loss = loss / tc.grad_accum
            grads = {k: g / tc.grad_accum for k, g in grads.items()}
        else:
            loss, grads = grads_of(params, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, tc.grad_clip,
                                               whole_sums)
        if consts is None:
            lr, inv_bc = sched(state["step"]), None
        else:
            lr, inv_bc = consts["lr"], (consts["inv_bc1"], consts["inv_bc2"])
        with torch.no_grad():
            new_params, new_slots = opt.adamw_update(
                {k: p.detach() for k, p in params.items()}, grads,
                slots, state["step"], lr, tc, inv_bc, layouts)
        if wrap is not None:
            new_params, new_slots = wrap(new_params, new_slots)
        new_state = {"params": new_params, "opt": new_slots,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.float(), "grad_norm": gnorm,
                           "lr": lr}

    return step


def make_train_step(model, tc: TrainConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``(state, batch, consts=None) -> (state, metrics)``: loss and
    gradients, global norm clip, AdamW.  With ``tc.grad_accum`` > 1 every
    batch leaf arrives pre-split as (grad_accum, micro_batch, ...), as the
    reference's loader delivers it: the microbatches' gradients are summed
    in ``tc.accum_dtype`` in order, then the loss and the sum are divided
    by ``grad_accum``."""
    def grads_of(params, batch):
        with torch.enable_grad():
            loss = loss_fn(model, params, batch)
            names = sorted(params)
            gs = torch.autograd.grad(loss, [params[k] for k in names])
        return loss.detach(), dict(zip(names, gs))

    return _step_fn(model, tc, grads_of)


def batch_rows(batch_pspecs: Dict, grad_accum: int = 1) -> Tuple[str, ...]:
    """The mesh axes the batch rows are split over, major first: the
    tokens' spec at the batch dim (after the microbatch dim, when
    accumulating)."""
    spec = tuple(batch_pspecs["tokens"])
    dim = 1 if grad_accum > 1 else 0
    return shd._axes(spec[dim]) if len(spec) > dim else ()


def make_sharded_train_step(model, tc: TrainConfig, mesh, policy: str,
                            batch_pspecs: Dict, *, force: bool = False):
    """The train step over a mesh of ranks (a ``DeviceMesh`` over the
    initialized process group), the state stored as ``policy`` shards it.
    Returns ``(step, abstract_state, state_shardings)``: ``step(state,
    batch) -> (state, metrics)`` takes and returns a state whose tensor
    leaves are ``DTensor``s placed by ``state_shardings``
    (``shd.shard_tree`` places a whole state), and a batch whose leaves
    are ``DTensor``s (``data.loader.device_put_global``; moved to
    ``batch_pspecs``'s split where theirs differs) or this rank's rows of
    that split; ``loss``, ``grad_norm`` and ``lr`` are the same on every
    rank (``step.grads(state, batch)`` gives the loss and each leaf's
    gradient block without updating).  With ``tc.grad_accum > 1`` the
    leading microbatch dim stays whole.  ``force`` keeps the policy's axes
    of one rank in the specs and takes every collective over them (a
    one-rank mesh running the sharded program; its specs are then not the
    reference's)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    ab, pspecs = state_pspecs(model, tc, mesh, policy, keep_unit=force)
    state_sh = shd.tree_named(mesh, pspecs)
    sizes = shd.mesh_axis_sizes(mesh)
    world = math.prod(sizes.values())
    rows = batch_rows(batch_pspecs, tc.grad_accum)
    view = shd.MeshView(mesh, rows=rows, force=force, policy=policy)
    active = [a for a in mesh.mesh_dim_names if view.active(a)]
    p_specs, p_sh = pspecs["params"], state_sh["params"]
    names = sorted(p_specs)
    used = {k: {a for e in p_specs[k] for a in shd._axes(e)} for k in names}
    layouts = {}
    for i, k in enumerate(names):
        slots = pspecs["opt"][i]
        if used[k] or any(e is not None for sp in slots.values()
                          for e in sp):
            layouts[k] = opt.LeafLayout(mesh, tuple(p_specs[k]),
                                        tuple(ab["params"][k][0]),
                                        {s: tuple(v)
                                         for s, v in slots.items()})
    axis = {a: C.Axis.of(mesh, a) for a in mesh.mesh_dim_names}

    def sum_over(xs: Dict[str, torch.Tensor], a: str) -> None:
        """All-reduce (sum) the tensors of ``xs`` over axis ``a``, in
        place of each, one flat buffer per dtype."""
        by_dt: Dict = {}
        for k, x in xs.items():
            by_dt.setdefault(x.dtype, []).append(k)
        for keys in by_dt.values():
            flat = torch.cat([xs[k].reshape(-1) for k in keys])
            dist.all_reduce(flat, group=axis[a].group)
            for k, part in zip(keys, flat.split(
                    [xs[k].numel() for k in keys])):
                xs[k] = part.view(xs[k].shape)

    def grads_of(params, batch):
        with torch.enable_grad():
            placed = {k: shd.place(t, p_sh[k], ab["params"][k][0])
                      for k, t in params.items()}
            loss = loss_fn(model, placed, batch, mesh=view)
            part = loss / world if world > 1 else loss
            gs = torch.autograd.grad(part, [params[k] for k in names])
        grads = dict(zip(names, gs))
        for a in active:   # each leaf summed over the axes it is whole on
            rest = {k: grads[k] for k in names if a not in used[k]}
            if rest:
                sum_over(rest, a)
                grads.update(rest)
        total = {"loss": part.detach().float()}
        for a in active:
            sum_over(total, a)
        return total["loss"], grads

    def whole_sums(sums):
        """Each leaf's sum of squares summed over the axes that split it."""
        out = dict(zip(names, sums))
        for a in active:
            split = {k: out[k] for k in names if a in used[k]}
            if split:
                sum_over(split, a)
                out.update(split)
        return [out[k] for k in names]

    def unwrap(params, slots):
        return ({k: v.to_local() for k, v in params.items()},
                [{s: t.to_local() for s, t in slot.items()}
                 for slot in slots])

    def wrap(params, slots):
        return ({k: shd.place(v, p_sh[k], ab["params"][k][0])
                 for k, v in params.items()},
                [{s: shd.place(t, state_sh["opt"][i][s],
                               ab["opt"][i][s][0])
                  for s, t in slot.items()} for i, slot in enumerate(slots)])

    inner = _step_fn(model, tc, grads_of, whole_sums, layouts, unwrap, wrap)

    def step(state, batch):
        return inner(state, {k: _rows(v, batch_pspecs[k], mesh)
                             for k, v in batch.items()})

    def grads(state, batch):
        """(loss, {leaf: this rank's block of its gradient}): what the
        step clips and applies, from ``state``'s parameters."""
        params = {k: v.to_local().detach().requires_grad_(True)
                  for k, v in state["params"].items()}
        return grads_of(params, {k: _rows(v, batch_pspecs[k], mesh)
                                 for k, v in batch.items()})
    step.grads = grads
    return step, ab, state_sh


def _rows(v, spec, mesh):
    """A batch leaf as this rank's block of ``spec``'s split: a DTensor's
    block moved there, anything else taken as that block already."""
    if not shd.is_placed(v):
        return v
    with torch.no_grad():
        return shd.relayout(v.to_local(), shd.spec_of(v), tuple(spec), mesh)
