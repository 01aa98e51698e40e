"""Labeling-task abstraction consumed by the MCAL campaign loop
(``repro.core.task``), synchronous subset.

:class:`LiveTask` is the real path: an MLP classifier retrained with the
port's fit engine, pool passes through the scoring engine (the
``margin_head`` kernel on a CUDA device) and k-center through the device
greedy engine (the ``pairwise_dist`` kernel for its anchor distances).
The pool's features are uploaded to the device once; every pass gathers
its rows there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.selection import uncertainty_scores


@dataclasses.dataclass
class LiveTask:
    """MCAL over a live classifier + feature dataset.

    ``features``: (N, d) float array; ``groundtruth``: (N,) int labels —
    human labels are simulated as groundtruth (the paper's assumption:
    human labels are perfect).
    """

    features: np.ndarray
    groundtruth: np.ndarray
    num_classes: int
    arch_name: str = "mlp"
    hidden: int = 64
    depth: int = 2
    epochs: int = 40
    batch_size: int = 256
    learning_rate: float = 1e-2
    seed: int = 0
    c_u_nominal: float = 1e-4        # $/sample-iteration: cost = c_u * |B|
    score_microbatch: int = 2048     # pool-scoring engine microbatch
    device: str = "cuda"
    fit_source: Optional[Callable[[int], Tuple[Dict, np.ndarray]]] = None
                                     # n -> (init params, epoch orders) for
                                     # an n-row retrain; None = the port's
                                     # own seeded draws

    def __post_init__(self):
        from repro_torch.configs.base import ModelConfig, TrainConfig
        from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
        from repro_torch.models.registry import get_model
        from repro_torch.training.fit_device import FitConfig, FitEngine
        self.pool_size = len(self.features)
        self.cfg = ModelConfig(
            name=f"{self.arch_name}-live", family="mlp",
            num_layers=self.depth, d_model=self.hidden,
            num_classes=self.num_classes, input_dim=self.features.shape[1],
            dtype="float32")
        self.model = get_model(self.cfg)
        self.tc = TrainConfig(learning_rate=self.learning_rate,
                              schedule="constant",
                              weight_decay=1e-4, grad_clip=1.0)
        self._params = None
        self._x = torch.as_tensor(np.asarray(self.features, np.float32),
                                  device=self.device)
        self._engine = PoolScoringEngine(
            self.model, ScoringConfig(microbatch=self.score_microbatch),
            device=self.device)
        self._fit = FitEngine(self.model, self.tc,
                              FitConfig(epochs=self.epochs,
                                        batch_size=self.batch_size),
                              device=self.device)

    # -- annotation ------------------------------------------------------
    def human_label(self, idx: np.ndarray) -> np.ndarray:
        """Purchased human labels: the paper's perfect-label assumption."""
        return self.groundtruth[np.asarray(idx, np.int64)]

    def oracle_labels(self, idx: np.ndarray) -> np.ndarray:
        """TRUE labels for evaluation only — never charged."""
        return self.groundtruth[np.asarray(idx, np.int64)]

    # -- training ----------------------------------------------------------
    def train(self, idx: np.ndarray, labels: np.ndarray) -> float:
        """Re-train from scratch on (idx, labels) for ``epochs`` epochs
        (fixed epochs => per-iteration cost proportional to |B|, Eqn. 4).
        The retrain runs on asynchronously; the next pass waits for it."""
        idx = np.asarray(idx, np.int64)
        n = len(idx)
        init_params = orders = None
        if self.fit_source is not None:
            init_params, orders = self.fit_source(n)
        self._params, _ = self._fit.fit(
            self.seed, self._rows(idx), np.asarray(labels, np.int64),
            init_params=init_params, orders=orders)
        return self.train_cost(n)

    def train_cost(self, n: int) -> float:
        """The $ cost :meth:`train` charges for an ``n``-row retrain."""
        return self.c_u_nominal * n

    # -- scoring -------------------------------------------------------------
    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        """The pool's rows ``idx``, gathered on the device."""
        return self._x[torch.as_tensor(np.asarray(idx, np.int64),
                                       device=self.device)]

    def _pool(self, idx: np.ndarray) -> torch.Tensor:
        assert self._params is not None, "train() before score()"
        return self._rows(idx)

    def score(self, idx: np.ndarray):
        return self._engine.score_host(self._params, self._pool(idx))

    def topk_candidates(self, metric: str, k: int,
                        candidates: np.ndarray) -> np.ndarray:
        """M(.) for the uncertainty metrics: the engine's device top-k —
        only the k chosen rows reach the host."""
        rows = self._engine.top_k(self._params, self._pool(candidates), k,
                                  metric)
        return np.asarray(candidates, np.int64)[rows]

    def kcenter_candidates(self, k: int, candidates: np.ndarray,
                           anchors: Optional[np.ndarray] = None):
        """M(.) k-center: features stay on the device, and so does the
        greedy loop; only the k chosen rows and their features return."""
        from repro_torch.core.selection_device import k_center_greedy_device
        feats = self._engine.pool_features(self._params,
                                           self._pool(candidates))
        rows = k_center_greedy_device(feats, k, anchors=anchors,
                                      device=self.device)
        picked = np.asarray(candidates, np.int64)[rows]
        sel = torch.as_tensor(rows, device=feats.device)
        return picked, feats[sel].cpu().numpy()

    def anchor_features(self, idx: np.ndarray) -> np.ndarray:
        """(len(idx), D) pooled features of ``idx`` under the CURRENT
        classifier — the campaign's k-center anchor set."""
        return self._engine.pool_features(self._params,
                                          self._pool(idx)).cpu().numpy()

    def machine_label_sweep(self, idx: np.ndarray, metric: str = "margin"):
        """L(.)/commit: one scoring pass over ``idx`` -> (rows
        most-confident-first, machine labels row-aligned with ``idx``).
        The rank is the stable host argsort over the metric's fp64 score,
        as the reference's rank sink computes it."""
        stats, _ = self._engine.score_host(self._params, self._pool(idx))
        order = np.argsort(uncertainty_scores(metric, stats), kind="stable")
        return order, np.asarray(stats.top1, np.int64)

    def predict(self, idx: np.ndarray) -> np.ndarray:
        stats, _ = self._engine.score_host(self._params, self._pool(idx))
        return np.asarray(stats.top1, np.int64)

    def eval_correct(self, idx: np.ndarray, labels: np.ndarray) -> np.ndarray:
        return self.predict(idx) == np.asarray(labels)
