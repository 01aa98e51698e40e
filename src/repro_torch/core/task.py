"""Labeling-task abstraction consumed by the MCAL campaign loop
(``repro.core.task``).

:class:`LiveTask` is the real path: an MLP classifier retrained with the
port's fit engine (one CUDA graph per retrain bucket on a card), pool-scale
passes — top-k M(.), k-center features, anchors, the L(.)/commit rank —
streamed through the paged sweep runtime (``serving.sweep``) over the
scoring engine (the ``margin_head`` kernel on a CUDA device), k-center
through the device greedy engine (the ``pairwise_dist`` kernel for its
anchor distances).  The pool stays on the host: each pass gathers its rows
there and pages them to the device.  Scoring the test set stays on the
engine's direct path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.selection import UNCERTAINTY_METRICS


@dataclasses.dataclass
class LiveTask:
    """MCAL over a live classifier + feature dataset.

    ``features``: (N, d) float array; ``groundtruth``: (N,) int labels —
    human labels are simulated as groundtruth (the paper's assumption:
    human labels are perfect), or bought from a noisy ``annotation``
    service.
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
    price_per_hour: float = 3.6      # the paper's 4xK80 VM price
    seed: int = 0
    measured_cost: bool = False      # False -> cost = c_u_nominal * |B|
    c_u_nominal: float = 1e-4        # $/sample-iteration when not measuring
    score_microbatch: int = 2048     # pool-scoring engine microbatch
    sweep_page: int = 8192           # pool-sweep runtime page rows
    fit_fused: bool = True           # the fit engine's retrain (False ->
                                     # the per-step host-loop oracle)
    fit_resident: bool = False       # keep the labeled set on the device,
                                     # upload only newly bought labels
    device: str = "cuda"
    fit_source: Optional[Callable[[int], Tuple[Dict, np.ndarray]]] = None
                                     # n -> (init params, epoch orders) for
                                     # an n-row retrain; None = the port's
                                     # own seeded draws
    annotation: Optional[object] = None  # AnnotationService (or a shared
                                     # service's AnnotationSession): route
                                     # human_label through a noisy multi-
                                     # annotator oracle (None = the
                                     # paper's perfect-label assumption)
    engines: Optional[object] = None  # launch.orchestrator.SharedEngines:
                                     # reuse a fleet's scoring/sweep/fit
                                     # engines (and their buckets and
                                     # graphs) instead of building per-task
                                     # ones.  Requires matching model/data
                                     # shapes and device; the fleet owns
                                     # the engines' lifecycle.
    mesh: Optional[object] = None    # DeviceMesh: every pool pass splits
                                     # its microbatches over the "data"
                                     # ranks; the retrain runs on each

    def __post_init__(self):
        from repro_torch.configs.base import ModelConfig, TrainConfig
        from repro_torch.core.scoring import PoolScoringEngine, ScoringConfig
        from repro_torch.models.registry import get_model
        from repro_torch.serving.sweep import (EngineSweepAdapter,
                                               PoolSweepRunner, SweepConfig)
        from repro_torch.training.fit_device import FitConfig, FitEngine
        self.pool_size = len(self.features)
        self.metrics = None  # runtime metrics registry (attach_metrics)
        if self.engines is not None:
            # shared-engine fleet mode: adopt the bundle's model + train
            # config so this task's params are exactly what the bundle's
            # engines were built for.  The engines are stateless per call
            # given params (each retrain starts from its own init), so
            # per-tenant results are bit-identical to owning private
            # engines — EXCEPT the fit engine's resident set, which is
            # per-engine state and must stay off.
            b = self.engines
            assert not self.fit_resident, \
                "fit_resident keeps per-engine state; unsupported with " \
                "shared engines"
            assert b.input_dim == self.features.shape[1] and \
                b.num_classes == self.num_classes, \
                "shared engines were built for a different data shape"
            assert b.fit.device == torch.device(self.device), \
                "shared engines were built for another device"
            self.cfg = b.cfg
            self.mesh = b.mesh
            self.model = b.model
            self.tc = b.tc
            self._engine = b.scoring
            self._sweep = b.sweep
            self._fit = b.fit
            self._params = None
            self._res_idx = np.zeros((0,), np.int64)
            return
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
        self._engine = PoolScoringEngine(
            self.model, ScoringConfig(microbatch=self.score_microbatch),
            device=self.device, mesh=self.mesh)
        self._sweep = PoolSweepRunner(
            EngineSweepAdapter(self._engine),
            SweepConfig(page_rows=self.sweep_page))
        self._fit = FitEngine(self.model, self.tc,
                              FitConfig(epochs=self.epochs,
                                        batch_size=self.batch_size),
                              device=self.device, mesh=self.mesh)
        self._res_idx = np.zeros((0,), np.int64)  # resident-set row ledger

    def attach_trace(self, trace) -> None:
        """Wire the campaign event bus into the sweep runner (page cursors,
        sink finalizations) and the fit engine (async submit/fold).
        SHARED engines are left unwired: their telemetry interleaves every
        tenant's jobs and belongs to the fleet's observability, not to one
        tenant's trace (all of it is OBSERVABILITY_KINDS, so tenant
        decision streams stay complete without it)."""
        if self.engines is not None:
            return
        self._sweep.trace = trace
        self._fit.trace = trace

    def attach_metrics(self, metrics) -> None:
        """Wire the runtime metrics registry (repro_torch.obs) through this
        task's engines: sweep page/fold timings, fit spans and bucket
        hit/miss counters, and the k-center span.  Unlike
        :meth:`attach_trace`, SHARED engines are wired too — the fleet
        hands every tenant the same registry and attributes per-tenant
        time through the orchestrator's bound ``tenant`` label."""
        self.metrics = metrics
        self._sweep.metrics = metrics
        self._fit.metrics = metrics
        self._engine.metrics = metrics

    def attach_faults(self, faults, retry=None) -> None:
        """Wire the chaos injector (and optional re-dispatch retry policy)
        into the OWNED engines' workers (fault sites ``worker.pool-sweep``
        / ``worker.fit-engine``).  Shared engines are left unwired, as in
        :meth:`attach_trace`: their jobs interleave every tenant's work,
        so injecting there would chaos the whole fleet, not this tenant."""
        if self.engines is not None:
            return
        self._sweep.attach_faults(faults, retry)
        self._fit.attach_faults(faults, retry)

    def close(self) -> None:
        """Join the OWNED engines' worker threads (shared engines belong
        to the fleet) and the annotation service's (idempotent; a
        session's close is a no-op)."""
        if self.engines is None:
            self._sweep.close()
            self._fit.close()
        if self.annotation is not None and hasattr(self.annotation, "close"):
            self.annotation.close()

    # -- annotation ------------------------------------------------------
    def human_label(self, idx: np.ndarray) -> np.ndarray:
        """Purchased human labels: aggregated noisy-annotator votes with an
        :attr:`annotation` service attached (charged per vote by the
        buyer, ``SharedPool.buy_labels``), else the paper's perfect-label
        assumption."""
        idx = np.asarray(idx, np.int64)
        gt = self.groundtruth[idx]
        if self.annotation is not None:
            return self.annotation.annotate(idx, gt)
        return gt

    def oracle_labels(self, idx: np.ndarray) -> np.ndarray:
        """TRUE labels for evaluation only — never charged."""
        return self.groundtruth[np.asarray(idx, np.int64)]

    # -- training ----------------------------------------------------------
    def train(self, idx: np.ndarray, labels: np.ndarray) -> float:
        """Re-train from scratch on (idx, labels) for ``epochs`` epochs
        (fixed epochs => per-iteration cost proportional to |B|, Eqn. 4):
        the fit engine's retrain (a replayed CUDA graph on a card), the
        per-step host loop with ``fit_fused=False``, and with
        ``fit_resident`` over the device-resident labeled set, extended by
        the newly bought rows only."""
        idx = np.asarray(idx, np.int64)
        labels = np.asarray(labels, np.int64)
        n = len(idx)
        kw = {}
        if self.fit_source is not None:
            kw["init_params"], kw["orders"] = self.fit_source(n)
        t0 = time.perf_counter()
        if not self.fit_fused:
            params, losses = self._fit.fit_reference(
                self.seed, self.features[idx].astype(np.float32), labels,
                **kw)
        elif self.fit_resident:
            prev = len(self._res_idx)
            if n < prev or not np.array_equal(idx[:prev], self._res_idx):
                # not an append-only extension of the resident set
                self._fit.reset_resident()
                prev = 0
            if n > prev:
                self._fit.extend_resident(
                    self.features[idx[prev:]].astype(np.float32),
                    labels[prev:])
            self._res_idx = idx.copy()
            params, losses = self._fit.fit_resident(self.seed, **kw)
        else:
            params, losses = self._fit.fit(
                self.seed, self.features[idx].astype(np.float32), labels,
                **kw)
        self._params = params
        if self.measured_cost:
            if losses.is_cuda:
                torch.cuda.synchronize(losses.device)
            return (time.perf_counter() - t0) / 3600.0 * self.price_per_hour
        return self.c_u_nominal * n

    def train_cost(self, n: int) -> Optional[float]:
        """The $ cost :meth:`train` charges for an ``n``-row retrain when it
        is known without training — None under ``measured_cost``.  The
        campaign's async-fit path pays it at submit."""
        return None if self.measured_cost else self.c_u_nominal * n

    def submit_train(self, idx: np.ndarray, labels: np.ndarray,
                     then: Optional[Callable] = None):
        """Async retrain on the fit engine's worker: a ``FitFuture`` of
        :meth:`train`'s cost, or of ``(cost, then())`` — the campaign
        chains its measurement there, so it reads the fresh params on the
        same worker."""
        idx = np.asarray(idx, np.int64).copy()
        labels = np.asarray(labels).copy()

        def job():
            c = self.train(idx, labels)
            return (c, then()) if then is not None else c

        return self._fit.submit_call(job)

    # -- scoring -------------------------------------------------------------
    def _pool(self, idx: np.ndarray) -> np.ndarray:
        """The pool's rows ``idx``, gathered on the host."""
        assert self._params is not None, "train() before score()"
        return self.features[np.asarray(idx, np.int64)].astype(np.float32)

    def score(self, idx: np.ndarray):
        return self._engine.score_host(self._params, self._pool(idx))

    def topk_candidates(self, metric: str, k: int,
                        candidates: np.ndarray) -> np.ndarray:
        """M(.) for the uncertainty metrics: a paged sweep folding a device
        top-k reservoir — only the k chosen rows reach the host."""
        from repro_torch.serving.sweep import TopKSink
        rows = self._sweep.run(self._params, self._pool(candidates),
                               TopKSink(k, metric))
        return np.asarray(candidates, np.int64)[rows]

    def kcenter_candidates(self, k: int, candidates: np.ndarray,
                           anchors: Optional[np.ndarray] = None):
        """M(.) k-center: the paged sweep leaves the features on the
        device, and so does the greedy loop; only the k chosen rows and
        their features return."""
        from repro_torch.core.selection_device import k_center_greedy_device
        from repro_torch.serving.sweep import FeatureSink
        feats = self._sweep.run(self._params, self._pool(candidates),
                                FeatureSink())
        rows = k_center_greedy_device(feats, k, anchors=anchors,
                                      device=self.device,
                                      metrics=self.metrics)
        picked = np.asarray(candidates, np.int64)[rows]
        sel = torch.as_tensor(rows, device=feats.device)
        return picked, feats[sel].cpu().numpy()

    def anchor_features(self, idx: np.ndarray) -> np.ndarray:
        """(len(idx), D) pooled features of ``idx`` under the CURRENT
        classifier (one paged feature sweep) — the campaign's k-center
        anchor set."""
        from repro_torch.serving.sweep import FeatureSink
        return self._sweep.run(self._params, self._pool(idx),
                               FeatureSink()).cpu().numpy()

    def machine_label_sweep(self, idx: np.ndarray, metric: str = "margin",
                            *, checkpoint=None, checkpoint_every: int = 0,
                            on_checkpoint=None):
        """L(.)/commit: one paged sweep over ``idx`` -> (rows
        most-confident-first, machine labels row-aligned with ``idx``).
        ``checkpoint`` resumes a cut cursor; ``checkpoint_every`` /
        ``on_checkpoint`` cut one every N pages for the launcher's state
        file."""
        from repro_torch.serving.sweep import RankTop1Sink
        return self._sweep.run(self._params, self._pool(idx),
                               RankTop1Sink(metric), checkpoint=checkpoint,
                               checkpoint_every=checkpoint_every,
                               on_checkpoint=on_checkpoint)

    def submit_candidates(self, metric: str, k: int, candidates: np.ndarray,
                          anchors: Optional[np.ndarray] = None):
        """Async M(.) on the sweep worker: a ``SweepFuture`` of the picked
        pool indices (uncertainty metrics) or of k-center's ``(picked,
        features)``."""
        from repro_torch.serving.sweep import TopKSink
        cand = np.asarray(candidates, np.int64)
        if metric in UNCERTAINTY_METRICS:
            return self._sweep.submit(
                self._params, self._pool(cand), TopKSink(k, metric),
                map_result=lambda rows: cand[rows])
        if metric == "kcenter":
            return self._sweep.submit_call(self.kcenter_candidates, k, cand,
                                           anchors)
        raise ValueError(f"no async sweep for metric {metric!r}")

    def predict(self, idx: np.ndarray) -> np.ndarray:
        stats, _ = self._engine.score_host(self._params, self._pool(idx))
        return np.asarray(stats.top1, np.int64)

    def eval_correct(self, idx: np.ndarray, labels: np.ndarray) -> np.ndarray:
        return self.predict(idx) == np.asarray(labels)

    # -- engine buckets in state files ---------------------------------------
    def pack_cache_keys(self) -> Dict:
        """The pow2 buckets both engines have run (scoring pages, retrain
        graphs), in the reference's JSON form for campaign state files."""
        return {"scoring": [list(k) for k in self._engine.cache_keys()],
                "fit": [list(k) for k in self._fit.cache_keys()]}

    def prewarm_caches(self, keys: Optional[Dict]) -> None:
        """Warm both engines from persisted bucket keys (the scoring side
        needs a trained model)."""
        if not keys:
            return
        self._fit.warm(keys.get("fit", ()))
        if self._params is not None:
            self._engine.warm(self._params, keys.get("scoring", ()))
