"""Learning-curve emulator (``repro.core.emulator``): paper-scale MCAL
replay without training a network or reading a dataset.

The campaign loop runs unchanged against an emulated task whose ground
truth follows the paper's modeling assumption — a truncated power law
(Eqn. 3) per machine-label fraction:

    per-sample error prob   p(u; B) = (q+1) * u^q * eps_full(B)
    =>  eps_theta(B) = eps_full(B) * theta^q        (error of top-theta slice)

where ``u`` in [0, 1] is the sample's latent confidence quantile (hardness),
``eps_full`` is the model's full-pool generalization-error power law, and
``q`` concentrates errors in the low-confidence tail.  The classifier's
margin is emulated as ``1 - u`` plus ranking noise, so MCAL's measurement
machinery (rank test set by margin, measure error of top-theta slice, fit
truncated power laws) runs unchanged.

Every draw is numpy, as the reference's: ``default_rng(seed)`` for ``u``
and the labels, counter-keyed Philox streams per (seed, training size)
for the correctness and ranking-noise draws, so ``score``, ``predict`` and
``eval_correct`` are the reference's bit for bit.  The pool sweeps page
through the port's sweep runtime on the host; k-center runs on
``device`` (the ``pairwise_dist`` kernel for its anchor distances on a
CUDA device).

Calibrations at the bottom map the paper's (dataset x architecture) grid to
(alpha, gamma, k, q, c_u) tuples chosen to match the paper's reported error
levels and training-cost magnitudes (Tbl. 1-2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.powerlaw import PowerLaw
from repro_torch.core.scoring import stats_from_confidence
from repro_torch.models.layers import ScoreStats


@dataclasses.dataclass
class EmulatedTask:
    pool_size: int
    num_classes: int
    law: PowerLaw                 # eps_full(B): full-pool generalization error
    q: float = 2.0                # confidence concentration (eps_theta ~ theta^q)
    c_u: float = 0.004            # $ per sample-iteration (fixed-epoch retrain)
    rank_noise: float = 0.02      # emulated margin-ranking imperfection
    arch_name: str = "emulated"
    seed: int = 0
    min_train: int = 8
    sweep_page: int = 65536       # pool-sweep page rows (L(.)/commit pass)
    annotation: Optional[object] = None  # AnnotationService: route
                                  # human_label through a noisy multi-
                                  # annotator oracle (None = perfect)
    device: str = "cuda"          # where k-center M(.) runs

    def __post_init__(self):
        root = np.random.default_rng(self.seed)
        # latent per-sample confidence quantile (hardness)
        self.u = root.permutation(self.pool_size) / max(self.pool_size - 1, 1)
        self.labels_gt = root.integers(0, self.num_classes, self.pool_size)
        self._B = 0
        self.trace = None   # campaign event bus (attach_trace)

    def attach_trace(self, trace) -> None:
        """Forward the campaign event bus to the per-call sweep runners
        (this task builds one per ``machine_label_sweep``)."""
        self.trace = trace

    # -- annotation service ------------------------------------------------
    def human_label(self, idx: np.ndarray) -> np.ndarray:
        """Purchased human labels — aggregated noisy-annotator votes when
        an :attr:`annotation` service is attached (the buyer charges per
        vote through ``CostLedger.pay_human``), perfect ground truth
        otherwise (the paper's assumption)."""
        idx = np.asarray(idx, np.int64)
        gt = self.labels_gt[idx]
        if self.annotation is not None:
            return self.annotation.annotate(idx, gt)
        return gt

    def oracle_labels(self, idx: np.ndarray) -> np.ndarray:
        """TRUE labels for evaluation only (never charged, never noisy)."""
        return self.labels_gt[np.asarray(idx, np.int64)]

    # -- training -----------------------------------------------------------
    def train(self, idx: np.ndarray, labels: np.ndarray) -> float:
        n = len(idx)
        self._B = n
        return self.c_u * n

    # -- the emulated classifier -------------------------------------------
    def _err_prob(self, u: np.ndarray) -> np.ndarray:
        B = max(self._B, self.min_train)
        eps = float(self.law.predict(B))
        return np.minimum((self.q + 1.0) * u ** self.q * eps, 1.0)

    def _wrong(self, idx: np.ndarray) -> np.ndarray:
        """Deterministic per (seed, sample, B) misclassification draw."""
        idx = np.asarray(idx, np.int64)
        rng = np.random.Generator(np.random.Philox(key=self.seed + 7919 * self._B))
        r = rng.random(self.pool_size)[idx]
        return r < self._err_prob(self.u[idx])

    def score(self, idx: np.ndarray) -> Tuple[ScoreStats, np.ndarray]:
        idx = np.asarray(idx, np.int64)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + 104729 + 7919 * self._B))
        noise = rng.normal(0.0, self.rank_noise, self.pool_size)[idx]
        conf = 1.0 - self.u[idx] + noise
        stats = stats_from_confidence(conf, self.num_classes,
                                      self.predict(idx))
        feats = np.stack([conf, self.u[idx]], axis=1)
        return stats, feats

    def machine_label_sweep(self, idx: np.ndarray, metric: str = "margin",
                            *, checkpoint=None, checkpoint_every: int = 0,
                            on_checkpoint=None):
        """L(.)/commit pass through the same paged sweep runtime the live
        path uses (host adapter, ``sweep_page`` rows per page), so paper-
        scale replays exercise the cursor/sink machinery without a device
        in the loop.  Per-sample draws are deterministic per global index,
        so the paged fold is exactly the full-pool ranking.  Cursor
        kwargs mirror ``LiveTask.machine_label_sweep`` (replay campaigns
        driven through the launcher's ``--state`` file resume a preempted
        commit sweep mid-pool)."""
        from repro_torch.serving.sweep import (HostTaskAdapter,
                                               PoolSweepRunner, RankTop1Sink,
                                               SweepConfig)
        runner = PoolSweepRunner(HostTaskAdapter(self.score),
                                 SweepConfig(page_rows=self.sweep_page))
        runner.trace = self.trace
        return runner.run(None, np.asarray(idx, np.int64),
                          RankTop1Sink(metric), checkpoint=checkpoint,
                          checkpoint_every=checkpoint_every,
                          on_checkpoint=on_checkpoint)

    def kcenter_candidates(self, k: int, candidates: np.ndarray,
                           anchors: Optional[np.ndarray] = None):
        """Device k-center M(.) over the emulated feature space — the same
        engine the live task takes, on ``device``, so paper-scale replay
        campaigns exercise ``core.selection_device`` at pool size."""
        from repro_torch.core.selection_device import k_center_greedy_device
        _, feats = self.score(candidates)
        rows = k_center_greedy_device(feats, k, anchors=anchors,
                                      device=self.device)
        picked = np.asarray(candidates, np.int64)[rows]
        return picked, np.asarray(feats, np.float32)[rows]

    def predict(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        wrong = self._wrong(idx)
        pred = self.labels_gt[idx].copy()
        pred[wrong] = (pred[wrong] + 1) % self.num_classes
        return pred

    def eval_correct(self, idx: np.ndarray, labels: np.ndarray) -> np.ndarray:
        return self.predict(idx) == np.asarray(labels)


# ---------------------------------------------------------------------------
# paper calibrations (dataset x architecture)
# ---------------------------------------------------------------------------
# eps_full laws calibrated to published learning-curve levels:
#   Fashion-MNIST/Res18:  ~8% err @ 4k,  ~5% @ 60k
#   CIFAR-10/Res18:       ~22% @ 4k, ~9% @ 20k, ~6% @ 50k
#   CIFAR-100/Res18:      ~60% @ 4k, ~30% @ 20k, ~22% @ 50k
# c_u from the paper's economics: Res18 CIFAR training spend ~\$90 at
# |B|=11k, delta=3.3k -> c_u ~ 0.004 $/sample-iteration.
# CNN18 trains ~3x cheaper but generalizes worse; Res50 ~3x costlier,
# slightly better.  EfficientNet-B0/ImageNet: 60-200x Res18's cost.

# ``pool`` is the train split MCAL labels; ``full`` (train + canonical test
# split) is what the paper's "Human Cost" rows price (70k x $0.04 = $2800
# for Fashion, 60k x $0.04 = $2400 for CIFAR), so savings are computed
# against ``full`` x price.
DATASETS: Dict[str, Dict] = {
    "fashion": {"pool": 60_000, "full": 70_000, "classes": 10},
    "cifar10": {"pool": 50_000, "full": 60_000, "classes": 10},
    "cifar100": {"pool": 50_000, "full": 60_000, "classes": 100},
    "imagenet": {"pool": 1_200_000, "full": 1_331_167, "classes": 1000},
}

# (alpha, gamma, k, q, c_u) — chosen so the analytic optimum of the
# emulated objective lands on the paper's Table 1/2 operating points:
#   cifar10/res18  -> B~22%, S~64%, cost ~$810 (paper: 22.2%, 65%, $792)
#   fashion/res18  -> B~4%,  S~84%, cost ~$404 (paper: 6.1%, 85%, $400)
#   cifar100/res18 -> cost ~$1729           (paper: $1698)
# cnn18 = cheaper-but-weaker, res50 = stronger-but-3x-costlier (Fig. 8-10).
CALIBRATIONS: Dict[Tuple[str, str], Tuple[float, float, float, float, float]] = {
    ("fashion", "cnn18"):    (3.30, 0.28, 4e5, 4.8, 0.0013),
    ("fashion", "resnet18"): (1.50, 0.35, 4e5, 6.0, 0.0040),
    ("fashion", "resnet50"): (1.40, 0.355, 4e5, 6.0, 0.0120),
    ("cifar10", "cnn18"):    (35.0, 0.44, 2e5, 1.0, 0.0013),
    ("cifar10", "resnet18"): (16.0, 0.55, 2e5, 1.2, 0.0040),
    ("cifar10", "resnet50"): (14.5, 0.56, 2e5, 1.2, 0.0120),
    ("cifar100", "cnn18"):   (198., 0.32, 2e5, 1.0, 0.0013),
    ("cifar100", "resnet18"): (90.0, 0.40, 2e5, 1.2, 0.0040),
    ("cifar100", "resnet50"): (82.0, 0.405, 2e5, 1.2, 0.0120),
    # ImageNet/EffNet-B0: 1000-class confidences are poorly concentrated
    # (q ~ 0.2) and training is ~20-200x Res18's cost, so machine labeling
    # never pays; MCAL must bail out to human-all after the exploration tax
    # (paper §5.1 — their run explored up to 454K images first).
    ("imagenet", "efficientnet-b0"): (5.2, 0.25, 1e7, 0.2, 0.08),
}


def make_emulated_task(dataset: str, arch: str, *, seed: int = 0,
                       pool_size: Optional[int] = None,
                       rank_noise: float = 0.02,
                       sweep_page: int = 65536,
                       device: str = "cuda") -> EmulatedTask:
    d = DATASETS[dataset]
    alpha, gamma, k, q, c_u = CALIBRATIONS[(dataset, arch)]
    return EmulatedTask(
        pool_size=pool_size or d["pool"], num_classes=d["classes"],
        law=PowerLaw(alpha=alpha, gamma=gamma, k=k), q=q, c_u=c_u,
        rank_noise=rank_noise, arch_name=arch, seed=seed,
        sweep_page=sweep_page, device=device)
