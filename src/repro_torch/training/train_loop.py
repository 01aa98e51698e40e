"""Train step + train state (``repro.training.train_loop``): the LM loss
over tokens and labels for the token families, or the classification head
the live labeling campaigns train (``cfg.num_classes``).

State is ``{"params": {path: tensor}, "opt": [slots], "step": int}``; the
step count lives on the host, so the schedule and bias corrections need
no device round trip.  Gradients come from ``torch.autograd``.  A step
given ``consts`` (``lr`` and the bias corrections' reciprocals as 0-dim
device tensors) reads no host step count: the form a CUDA graph captures.
There is no mesh (the reference's ``make_sharded_train_step`` waits for
ROADMAP A's mesh): the step runs on the params' device.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import DTYPES, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule


def loss_fn(model, params: Dict, batch: Dict) -> torch.Tensor:
    """The reference's loss: the classification head's mean cross-entropy
    on the mean-pooled hidden state, or the LM's mean token cross-entropy
    against ``batch["labels"]`` through the tied or explicit head (a VLM's
    on its text positions only), vocab-chunked when ``cfg.logits_chunk``
    is set and over materialized fp32 logits otherwise."""
    cfg = model.cfg
    hidden = model.forward(params, batch)
    if cfg.num_classes:
        pooled = torch.mean(hidden.float(), dim=1)
        logits = pooled.to(hidden.dtype) @ params["cls_head"]
        return L.cross_entropy(logits, batch["labels"])
    w = tf.lm_head_weight(cfg, params)
    labels = batch["labels"]
    if cfg.family == "vlm" and cfg.frontend_tokens:
        hidden = hidden[:, cfg.frontend_tokens:, :]  # the text positions
    if cfg.logits_chunk:
        return L.chunked_cross_entropy(hidden, w, labels,
                                       chunk=cfg.logits_chunk)
    logits = torch.einsum("btd,dv->btv", hidden.float(), w.float())
    return L.cross_entropy(logits, labels)


def init_train_state(model, tc: TrainConfig, params: Dict) -> Dict:
    """Fresh optimizer state around ``params`` (from ``model.init`` or
    carried in)."""
    return {"params": dict(params), "opt": opt.init_slots(params, tc),
            "step": 0}


def make_train_step(model, tc: TrainConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``(state, batch, consts=None) -> (state, metrics)``: loss and
    gradients, global norm clip, AdamW.  With ``tc.grad_accum`` > 1 every
    batch leaf arrives pre-split as (grad_accum, micro_batch, ...), as the
    reference's loader delivers it: the microbatches' gradients are summed
    in ``tc.accum_dtype`` in order, then the loss and the sum are divided
    by ``grad_accum``."""
    sched = make_schedule(tc)

    def grads_of(params, batch):
        with torch.enable_grad():
            loss = loss_fn(model, params, batch)
            names = sorted(params)
            gs = torch.autograd.grad(loss, [params[k] for k in names])
        return loss.detach(), dict(zip(names, gs))

    def step(state, batch, consts=None):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state["params"].items()}
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
        grads, gnorm = opt.clip_by_global_norm(grads, tc.grad_clip)
        if consts is None:
            lr, inv_bc = sched(state["step"]), None
        else:
            lr, inv_bc = consts["lr"], (consts["inv_bc1"], consts["inv_bc2"])
        with torch.no_grad():
            new_params, new_slots = opt.adamw_update(
                {k: p.detach() for k, p in params.items()}, grads,
                state["opt"], state["step"], lr, tc, inv_bc)
        new_state = {"params": new_params, "opt": new_slots,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.float(), "grad_norm": gnorm,
                           "lr": lr}

    return step
