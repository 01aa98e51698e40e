"""Retrain engine (``repro.training.fit_device``) — MCAL's per-iteration
training pass: retrain from scratch on the labeled set for a fixed number
of epochs.

The schedule is the reference's: ``(steps_per_epoch, bs) =
pack_shape(n, batch_size)`` (:func:`fit_plan`), one epoch sweeps the padded
row count, and the ragged tail of each epoch wraps into the front of the
same epoch's order (``pos = (s*bs + arange(bs)) % n``), so padding rows are
never trained on.  Epoch orders are permutations of the padded row range
with the valid (< n) entries stably partitioned to the front
(:func:`epoch_orders`), drawn from a ``torch.Generator`` seeded per
(seed, n).

``fit`` gathers each batch on the device from the uploaded labeled set;
``fit_reference`` is the reference's per-step host loop (a numpy gather
and one upload per batch).  Both consume the identical orders and give
identical params and losses.  Each takes an optional injected
``(init_params, orders)`` — the seam the cross-framework tests use to feed
the JAX package's init and shuffles, which ``jax.random`` makes and a
torch generator cannot reproduce.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.scoring import pack_shape
from repro_torch.models.param import derive_seed
from repro_torch.training.train_loop import init_train_state, make_train_step


def fit_plan(n: int, batch_size: int) -> Tuple[int, int, int]:
    """``(steps_per_epoch, bs, n_pad)`` with ``n_pad = steps_per_epoch *
    bs`` — the :func:`scoring.pack_shape` pow2 bucketing."""
    spe, bs = pack_shape(n, batch_size)
    return spe, bs, spe * bs


def epoch_orders(seed: int, epochs: int, n_pad: int, n: int) -> torch.Tensor:
    """(epochs, n_pad) int64 row orders on the CPU: per epoch a random
    permutation of the padded row range with its valid (< n) entries
    stably partitioned to the front, so the first-n prefix is a uniform
    random permutation of the true rows."""
    g = torch.Generator().manual_seed(derive_seed(seed, n))
    out = []
    for _ in range(epochs):
        perm = torch.randperm(n_pad, generator=g)
        out.append(perm[torch.argsort((perm >= n).to(torch.int8),
                                      stable=True)])
    return torch.stack(out)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    epochs: int = 40
    batch_size: int = 256


class FitEngine:
    """Fixed-epoch retrain-from-scratch for one (model, TrainConfig).

    ``fit(seed, x, y) -> (params, losses)``; ``losses`` is the per-step
    training loss, ``(epochs * steps_per_epoch,)``, on the device."""

    def __init__(self, model, tc: TrainConfig, cfg: FitConfig = FitConfig(),
                 device="cuda"):
        self.model = model
        self.tc = tc
        self.cfg = cfg
        self.device = torch.device(device)
        self._step = make_train_step(model, tc)

    def _start(self, seed: int, n: int, init_params, orders):
        """Initial train state and (epochs, n_pad) orders on the device:
        the injected ones where given, else the port's own draws."""
        _, _, n_pad = fit_plan(n, self.cfg.batch_size)
        if init_params is None:
            init_params = self.model.init(seed, self.device)
        params = {k: torch.as_tensor(v, device=self.device).clone()
                  for k, v in init_params.items()}
        if orders is None:
            orders = epoch_orders(seed, self.cfg.epochs, n_pad, n)
        orders = torch.as_tensor(np.array(orders), dtype=torch.int64)
        if orders.shape != (self.cfg.epochs, n_pad):
            raise ValueError(f"orders must be (epochs, n_pad) = "
                             f"{(self.cfg.epochs, n_pad)}, got "
                             f"{tuple(orders.shape)}")
        return init_train_state(self.model, self.tc, params), orders

    def fit(self, seed: int, x, y, *, init_params: Optional[Dict] = None,
            orders=None) -> Tuple[Dict, torch.Tensor]:
        """One retrain from scratch over the labeled set ``(x, y)``, with
        every batch gathered on the device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, device=self.device).long()
        n = int(x.shape[0])
        spe, bs, _ = fit_plan(n, self.cfg.batch_size)
        state, orders = self._start(seed, n, init_params, orders)
        orders = orders.to(self.device)
        arange = torch.arange(bs, device=self.device)
        losses = []
        for e in range(self.cfg.epochs):
            for s in range(spe):
                rows = orders[e][(s * bs + arange) % n]
                state, metrics = self._step(
                    state, {"features": x[rows], "labels": y[rows]})
                losses.append(metrics["loss"])
        return state["params"], torch.stack(losses)

    def fit_reference(self, seed: int, x, y, *,
                      init_params: Optional[Dict] = None,
                      orders=None) -> Tuple[Dict, torch.Tensor]:
        """The reference's per-step host loop: one numpy batch gather and
        one upload per step, over the same orders as :meth:`fit`."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int64)
        n = int(x.shape[0])
        spe, bs, _ = fit_plan(n, self.cfg.batch_size)
        state, orders = self._start(seed, n, init_params, orders)
        orders = orders.numpy()
        arange = np.arange(bs)
        losses = []
        for e in range(self.cfg.epochs):
            for s in range(spe):
                sel = orders[e][(s * bs + arange) % n]
                batch = {"features": torch.as_tensor(x[sel],
                                                     device=self.device),
                         "labels": torch.as_tensor(y[sel],
                                                   device=self.device)}
                state, metrics = self._step(state, batch)
                losses.append(metrics["loss"])
        return state["params"], torch.stack(losses)
