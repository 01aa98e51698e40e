"""Train step + train state (``repro.training.train_loop``), for the
classification head the live labeling campaigns train.

State is ``{"params": {path: tensor}, "opt": [slots], "step": int}``; the
step count lives on the host, so the schedule and bias corrections need
no device round trip.  Gradients come from ``torch.autograd``.  A step
given ``consts`` (``lr`` and the bias corrections' reciprocals as 0-dim
device tensors) reads no host step count: the form a CUDA graph captures.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule


def loss_fn(model, params: Dict, batch: Dict) -> torch.Tensor:
    """Mean cross-entropy of the classification head on the mean-pooled
    hidden state."""
    if not model.cfg.num_classes:
        raise NotImplementedError("only the classification loss is ported")
    hidden = model.forward(params, batch)
    pooled = torch.mean(hidden.float(), dim=1)
    logits = pooled.to(hidden.dtype) @ params["cls_head"]
    return L.cross_entropy(logits, batch["labels"])


def init_train_state(model, tc: TrainConfig, params: Dict) -> Dict:
    """Fresh optimizer state around ``params`` (from ``model.init`` or
    carried in)."""
    return {"params": dict(params), "opt": opt.init_slots(params, tc),
            "step": 0}


def make_train_step(model, tc: TrainConfig
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``(state, batch, consts=None) -> (state, metrics)``: loss and
    gradients, global norm clip, AdamW."""
    sched = make_schedule(tc)

    def step(state, batch, consts=None):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state["params"].items()}
        with torch.enable_grad():
            loss = loss_fn(model, params, batch)
            names = sorted(params)
            gs = torch.autograd.grad(loss, [params[k] for k in names])
        grads = dict(zip(names, gs))
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
        return new_state, {"loss": loss.detach().float(), "grad_norm": gnorm,
                           "lr": lr}

    return step
