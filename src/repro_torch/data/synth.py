"""Synthetic datasets with controllable difficulty.

``make_classification`` builds the feature-vector pools MCAL's live
campaigns label: class centroids on a hypersphere + anisotropic Gaussian
noise; ``difficulty`` in [0, 1) scales the noise/margin ratio so the
achievable classifier error spans the paper's easy (Fashion-like) to hard
(CIFAR-100-like) regimes.  A fraction of samples is drawn with boosted
noise ("hard tail") so uncertainty ranking has real structure to find.

``make_lm_tokens`` builds deterministic pseudo-corpora for LM training
(Zipf-ish unigram draws + a copy task so the loss is learnable).  Both are
numpy, bit-equal to the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(
    n: int,
    num_classes: int = 10,
    dim: int = 32,
    difficulty: float = 0.3,
    hard_frac: float = 0.25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features (n, dim) f32, labels (n,) i64)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, num_classes, n)
    # per-dimension sigma scaled by sqrt(32/dim) so the noise-to-margin
    # ratio (and thus Bayes error) is dimension-independent
    base_sigma = (0.1 + 0.5 * difficulty) * np.sqrt(32.0 / dim)
    x = centers[labels] + rng.normal(size=(n, dim)) * base_sigma
    # the "hard tail" lies NEAR DECISION BOUNDARIES (between two class
    # centers) — hard but LEARNABLE, so uncertainty-ranked acquisition has
    # informative structure to exploit (pure-noise tails make active
    # learning lose to random: a classic AL failure mode)
    hard = rng.random(n) < hard_frac
    other = (labels + rng.integers(1, num_classes, n)) % num_classes
    lam = rng.uniform(0.25, 0.48, n)
    boundary = (1 - lam[:, None]) * centers[labels] + \
        lam[:, None] * centers[other] + \
        rng.normal(size=(n, dim)) * (base_sigma * 0.6)
    x[hard] = boundary[hard]
    return x.astype(np.float32), labels.astype(np.int64)



def make_lm_tokens(
    n_seq: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    copy_prefix: int = 8,
) -> np.ndarray:
    """(n_seq, seq_len) i32 token ids: Zipf unigrams with the first
    ``copy_prefix`` tokens repeated mid-sequence (learnable structure)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    p = 1.0 / ranks
    p /= p.sum()
    toks = rng.choice(vocab_size, size=(n_seq, seq_len), p=p)
    if seq_len >= 2 * copy_prefix + 2:
        mid = seq_len // 2
        toks[:, mid:mid + copy_prefix] = toks[:, :copy_prefix]
    return toks.astype(np.int32)
