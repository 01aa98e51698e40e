"""Seeded noisy-annotator pools (``repro.annotation.oracle``): the human
side of the annotation service.  Numpy only, a copy of the reference's, so
the votes are the reference's bit for bit.

Each worker answers label requests through a per-worker (C, C)
row-stochastic confusion matrix ``P(vote = l | true = c)``, drawn from one
of three profiles:

* ``reliable``  — (1 - noise) on the diagonal, the rest spread uniformly;
  per-worker noise is jittered around the configured base rate so workers
  are statistically distinguishable (what Dawid-Skene EM estimates);
* ``spammer``   — answers uniformly at random, ignoring the item;
* ``biased``    — a reliable worker that additionally collapses a
  ``bias_strength`` share of its probability mass onto one preferred
  class (systematic class confusion).

Determinism contract: a worker's answer to an item is a fixed function of
``(pool seed, worker, item)`` (a consistent annotator — asking twice
returns the same vote), drawn through a counter-keyed integer hash.  This
is what makes preempted noisy-oracle campaigns resume bit-identically:
replaying a request after a restart reproduces the votes the lost process
saw.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

PROFILES = ("reliable", "spammer", "biased")


@dataclasses.dataclass(frozen=True)
class AnnotatorConfig:
    n_workers: int = 5
    num_classes: int = 10
    noise: float = 0.2          # base per-vote error rate of reliable workers
    noise_jitter: float = 0.5   # per-worker rate in noise * (1 +/- jitter)
    spammer_frac: float = 0.0   # share of workers answering uniformly
    biased_frac: float = 0.0    # share with a systematic class bias
    bias_strength: float = 0.5  # mass a biased worker moves onto its class
    seed: int = 0

    def __post_init__(self):
        assert self.n_workers >= 1 and self.num_classes >= 2
        assert 0.0 <= self.noise < 1.0
        assert self.spammer_frac + self.biased_frac <= 1.0 + 1e-9


class AnnotatorPool:
    """``n_workers`` seeded noisy annotators answering per-worker label
    requests.  ``confusion`` is the (W, C, C) ground-truth confusion
    stack (row-stochastic over votes) — the quantity Dawid-Skene EM
    estimates and the tests compare its estimates against."""

    def __init__(self, cfg: AnnotatorConfig, draw_salt: int = 0):
        # draw_salt shifts ONLY the per-vote randomness streams, keeping
        # the worker population (profiles, confusion matrices) identical
        # — calibration batches measure the REAL workers on vote
        # randomness disjoint from any campaign request
        self.cfg = cfg
        self.draw_salt = int(draw_salt)
        W, C = cfg.n_workers, cfg.num_classes
        rng = np.random.default_rng(cfg.seed)
        n_spam = int(round(cfg.spammer_frac * W))
        n_bias = int(round(cfg.biased_frac * W))
        profiles: List[str] = (["spammer"] * n_spam + ["biased"] * n_bias +
                               ["reliable"] * (W - n_spam - n_bias))
        # seeded shuffle so profile assignment is not position-correlated
        # with the round-robin worker schedule downstream
        rng.shuffle(profiles)
        self.profiles: Tuple[str, ...] = tuple(profiles)
        conf = np.zeros((W, C, C), np.float64)
        for w, prof in enumerate(self.profiles):
            if prof == "spammer":
                conf[w] = 1.0 / C
                continue
            lo = cfg.noise * (1.0 - cfg.noise_jitter)
            hi = cfg.noise * (1.0 + cfg.noise_jitter)
            err = float(np.clip(rng.uniform(lo, hi), 0.0, 0.95))
            row = np.full((C, C), err / max(C - 1, 1))
            np.fill_diagonal(row, 1.0 - err)
            if prof == "biased":
                b = int(rng.integers(0, C))
                onto = np.zeros((C, C))
                onto[:, b] = 1.0
                row = (1.0 - cfg.bias_strength) * row + \
                    cfg.bias_strength * onto
            conf[w] = row
        self.confusion = conf
        self._cdf = np.cumsum(conf, axis=2)        # (W, C, C) inverse-CDF
        self._cdf[:, :, -1] = 1.0                  # guard fp round-off

    @property
    def n_workers(self) -> int:
        return self.cfg.n_workers

    # -- the determinism primitive ----------------------------------------
    def _draws(self, worker: int, idx: np.ndarray) -> np.ndarray:
        """Uniform draws per (seed, worker, item): a splitmix64-style
        integer hash of the item id under a per-(seed, worker) key, so
        the same request always sees the same randomness at O(batch)
        cost.  (A Generator stream indexed by item would need O(pool)
        draws per request round — at ImageNet pool sizes that is ~10MB
        of wasted uniforms per (worker, round).)"""
        key = (self.cfg.seed * 1_000_003 + worker * 7919 + 1 +
               self.draw_salt * 0x51ED2701) & 0xFFFFFFFFFFFFFFFF
        z = idx.astype(np.uint64) + np.uint64(key)
        z = z * np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)

    def annotate(self, idx: np.ndarray, true_labels: np.ndarray,
                 worker: int) -> np.ndarray:
        """One worker's votes on ``idx`` (global item ids) given the true
        labels — the per-worker inverse-CDF draw through the worker's
        confusion row.  Deterministic per (pool seed, worker, item)."""
        idx = np.asarray(idx, np.int64)
        true = np.asarray(true_labels, np.int64)
        assert 0 <= worker < self.cfg.n_workers
        if len(idx) == 0:
            return np.zeros((0,), np.int64)
        r = self._draws(worker, idx)
        cdf = self._cdf[worker][true]              # (n, C)
        return np.argmax(r[:, None] < cdf, axis=1).astype(np.int64)

    def vote_matrix(self, idx: np.ndarray, true_labels: np.ndarray,
                    repeats: int, base: int = 0) -> np.ndarray:
        """A round-robin ``(len(idx), W)`` vote matrix (-1 = not asked):
        row ``i`` gets votes from workers ``(base + i + r) % W`` for
        ``r < repeats`` — the annotation service's worker schedule,
        shared by the oracle-grid tests and the aggregation benchmark so
        both exercise the exact matrices campaigns produce."""
        idx = np.asarray(idx, np.int64)
        true = np.asarray(true_labels, np.int64)
        N, W = len(idx), self.cfg.n_workers
        votes = np.full((N, W), -1, np.int32)
        rows = np.arange(N)
        for r in range(min(repeats, W)):
            w_of = (base + rows + r) % W
            for w in np.unique(w_of):
                sub = rows[w_of == w]
                votes[sub, w] = self.annotate(idx[sub], true[sub], int(w))
        return votes

    # -- analytic quality -------------------------------------------------
    def per_vote_error(self) -> float:
        """Expected single-vote error under a uniform class prior,
        averaged over workers — the analytic per-annotator quality."""
        diag = np.einsum("wcc->wc", self.confusion)
        return float(1.0 - diag.mean())

    def expected_majority_error(self, repeats: int) -> float:
        """Analytic error of an R-vote majority under the mean per-vote
        error (ties split evenly) — the residual-error estimate a campaign
        folds into its accuracy target (``LabelQuality``).  Exact for
        binary symmetric workers; a standard upper-ish bound otherwise."""
        p = self.per_vote_error()
        R = max(int(repeats), 1)
        ks = np.arange(R + 1)
        from math import comb
        pmf = np.asarray([comb(R, int(k)) for k in ks], np.float64) * \
            p ** ks * (1.0 - p) ** (R - ks)
        err = float(pmf[ks > R / 2].sum())
        if R % 2 == 0:
            err += 0.5 * float(pmf[ks == R // 2].sum())
        return min(err, 1.0)


def make_annotator_pool(n_workers: int = 5, num_classes: int = 10, *,
                        noise: float = 0.2, spammer_frac: float = 0.0,
                        biased_frac: float = 0.0, seed: int = 0,
                        **kw) -> AnnotatorPool:
    return AnnotatorPool(AnnotatorConfig(
        n_workers=n_workers, num_classes=num_classes, noise=noise,
        spammer_frac=spammer_frac, biased_frac=biased_frac, seed=seed, **kw))
