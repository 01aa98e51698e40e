"""Pool-scoring engine (``repro.core.scoring``) — MCAL's per-iteration
scoring pass.

The pool is padded into ``(n_microbatches, microbatch, ...)`` with the
reference's pow2 bucketing (:func:`pack_shape`) and swept microbatch by
microbatch: model forward, then the head fused into :class:`ScoreStats`
(margin / entropy / max-logprob / top1).  Feature classifiers (``mlp``)
take ``(N, input_dim)`` float pools; token models (``dense``, ``hybrid``,
``ssm``, ``moe``, ``vlm``; a VLM's text alone, as in the reference) take
``(N, T)`` int32 token pools and are scored at the last position through
their (possibly tied) LM head, the serving convention.  On a CUDA
device the head goes through the hand-written ``margin_head`` kernel; on
the CPU it follows the reference's rule (dense logits when V <= 4096, else
vocab chunks).  The same sweep emits the pooled last-hidden features that
k-center consumes, left on the device.  The ``(n_mb, mb)`` pack buckets
swept so far are the engine's :meth:`~PoolScoringEngine.cache_keys` (the
keys the reference's compile cache holds, persisted in campaign state
files); :meth:`warm` runs one page of each, so the kernels are built and
cuBLAS has chosen its algorithms before a campaign's loop.

:func:`score_pool_reference` keeps the host loop the reference validates
its engine against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ScoreStats


def next_pow2(n: int) -> int:
    """The pow2 bucketing primitive shared by the scoring engine and
    ``selection_device.k_center_greedy_device``."""
    return 1 << max(n - 1, 0).bit_length()


def pack_shape(n: int, microbatch: int) -> Tuple[int, int]:
    """The pow2 microbatch bucketing for an ``n``-row pool: ``(n_mb, mb)``
    with ``n_mb * mb >= n``."""
    if n >= microbatch:
        mb = microbatch
        n_mb = next_pow2(math.ceil(n / mb))
    else:
        mb = max(next_pow2(n), 8)
        n_mb = 1
    return n_mb, mb


def resolve_head_weight(cfg, params) -> torch.Tensor:
    """The (D, V) scoring-head matrix for any model family: the explicit
    classifier head when present, otherwise the (possibly tied) LM head."""
    if "cls_head" in params:
        return params["cls_head"]
    from repro_torch.models.transformer import lm_head_weight
    return lm_head_weight(cfg, params)


def uncertainty_from_stats(stats: ScoreStats, metric: str) -> torch.Tensor:
    """Higher = more uncertain, on the stats' device (the twin of
    ``selection.uncertainty_scores``)."""
    if metric == "margin":
        return -stats.margin
    if metric == "entropy":
        return stats.entropy
    if metric == "least_confidence":
        return 1.0 - torch.exp(stats.max_logprob)
    raise ValueError(f"unknown uncertainty metric {metric!r}")


def stats_from_confidence(conf: np.ndarray, num_classes: int,
                          top1: np.ndarray) -> ScoreStats:
    """Pack a scalar confidence in [~0, 1] into a consistent ScoreStats of
    host float64 arrays (the emulator's scoring path; margin == confidence
    by convention)."""
    conf = np.asarray(conf, np.float64)
    return ScoreStats(
        margin=conf,
        entropy=np.maximum(1.0 - conf, 0.0) * np.log(num_classes),
        max_logprob=np.minimum(conf - 1.0, -1e-9),
        top1=np.asarray(top1))


def head_stats(hidden: torch.Tensor, w_head: torch.Tensor, *,
               mode: str = "auto", vocab_chunk: int = 8192) -> ScoreStats:
    """Vocab projection + ScoreStats for last-token hidden states.

    ``hidden``: (T, D); ``w_head``: (D, V).  ``mode``:
      dense    materialize (T, V) logits (exact reference; small V),
      chunked  online top-2/logsumexp over vocab chunks,
      kernel   the ``margin_head`` kernel (its plain version on the CPU),
      auto     the kernel on a CUDA device; on the CPU dense when V fits
               comfortably, else chunked.
    """
    V = w_head.shape[-1]
    if mode == "auto":
        if hidden.device.type != "cpu":
            mode = "kernel"
        else:
            mode = "dense" if V <= 4096 else "chunked"
    if mode == "dense":
        return L.score_stats_from_logits(hidden @ w_head)
    if mode == "chunked":
        return L.chunked_score_stats(hidden, w_head, chunk=vocab_chunk)
    if mode == "kernel":
        return ops.score_head(hidden, w_head)
    raise ValueError(f"unknown head mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    microbatch: int = 1024
    head_mode: str = "auto"        # auto | dense | chunked | kernel
    vocab_chunk: int = 8192


# the pool each ported family scores: its batch key and element dtype
_POOLS = {"mlp": ("features", torch.float32),
          **{family: ("tokens", torch.int32)
             for family in ("dense", "hybrid", "ssm", "moe", "vlm")}}


class PoolScoringEngine:
    """Microbatched pool scorer for one model: feature classifiers
    consume ``(N, input_dim)`` float pools, token families ``(N, T)`` int32
    pools (last-position statistics)."""

    def __init__(self, model, cfg: ScoringConfig = ScoringConfig(),
                 device="cuda"):
        if model.cfg.family == "audio":
            # the reference's engine passes {"tokens": x} alone, so its
            # encoder gets no audio_frames and fails (ROADMAP C.5)
            raise NotImplementedError(
                "PoolScoringEngine scores token and feature pools; an audio "
                "pool needs per-row audio_frames: its pool pass is "
                "ServeEngine.score_pool")
        if model.cfg.family not in _POOLS:
            raise NotImplementedError(
                f"scoring the {model.cfg.family!r} family is not ported")
        self._batch_key, self.pool_dtype = _POOLS[model.cfg.family]
        # the same dtype on the host, where the sweep stages its pages
        self.host_dtype = torch.empty(0, dtype=self.pool_dtype).numpy().dtype
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        # (n_mb, mb) pack buckets swept or warmed so far
        self.pack_keys: set = set()
        # runtime metrics (repro_torch.obs.MetricsRegistry); None = free
        # no-op
        self.metrics = None

    def _note_pack(self, key: Tuple[int, int]) -> None:
        """Record a pack-bucket touch: a cache hit when the bucket was
        already swept, a miss at its first use."""
        key = (int(key[0]), int(key[1]))
        if self.metrics is not None:
            if key in self.pack_keys:
                self.metrics.inc("pack_cache_hits_total", engine="scoring")
            else:
                self.metrics.inc("pack_cache_misses_total",
                                 engine="scoring")
        self.pack_keys.add(key)

    def _microbatch_stats(self, params, x) -> Tuple[ScoreStats, torch.Tensor]:
        hidden = self.model.forward(params, {self._batch_key: x})
        h = hidden[:, -1, :].float()
        w = resolve_head_weight(self.model.cfg, params)
        stats = head_stats(h, w.float(), mode=self.cfg.head_mode,
                           vocab_chunk=self.cfg.vocab_chunk)
        return stats, h

    def _pack(self, pool_x) -> Tuple[torch.Tensor, int]:
        """Pad the pool to a power-of-two microbatch count and fold it into
        (n_mb, mb, ...)."""
        x = torch.as_tensor(pool_x, dtype=self.pool_dtype,
                            device=self.device)
        n = x.shape[0]
        n_mb, mb = pack_shape(n, self.cfg.microbatch)
        pad = n_mb * mb - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        self._note_pack((n_mb, mb))
        return x.reshape((n_mb, mb) + tuple(x.shape[1:])), n

    @torch.no_grad()
    def score_pages(self, params, xs) -> Tuple[ScoreStats, torch.Tensor]:
        """Score a packed ``(n_mb, mb, ...)`` pool: PACKED statistics and
        features (padding rows included) — the sweep runtime's page step
        (``serving.sweep.EngineSweepAdapter``)."""
        self._note_pack(tuple(xs.shape[:2]))
        return self._score_packed(params, xs)

    @torch.no_grad()
    def _score_packed(self, params, xs) -> Tuple[ScoreStats, torch.Tensor]:
        stats, feats = [], []
        for x in xs:
            s, h = self._microbatch_stats(params, x)
            stats.append(s)
            feats.append(h)
        return (ScoreStats(*(torch.cat(f) for f in zip(*stats))),
                torch.cat(feats))

    def cache_keys(self):
        """Sorted (n_mb, mb) pack buckets this engine has swept."""
        return sorted(self.pack_keys)

    def warm(self, params, keys) -> int:
        """Score one zero page of each (n_mb, mb) bucket in ``keys`` (e.g.
        restored from a campaign state file) not swept yet, so the kernels
        are built and cuBLAS has chosen its algorithms before the loop;
        returns how many buckets were warmed.  Feature classifiers only,
        as in the reference: a token pool's sequence length is not part of
        the pack key."""
        if self._batch_key != "features":
            raise NotImplementedError(
                "warm() supports feature-classifier engines")
        count = 0
        for n_mb, mb in keys:
            key = (int(n_mb), int(mb))
            if key in self.pack_keys:
                continue
            self.score_pages(params, torch.zeros(
                key + (self.model.cfg.input_dim,), device=self.device))
            count += 1
        if count and self.metrics is not None:
            self.metrics.inc("warm_compiles_total", count, engine="scoring")
        return count

    def score(self, params, pool_x) -> Tuple[ScoreStats, torch.Tensor]:
        """Score the whole pool: ScoreStats and (N, D) last-hidden features
        on the device, trimmed to the true pool size."""
        xs, n = self._pack(pool_x)
        stats, feats = self._score_packed(params, xs)
        return L.map_stats(lambda a: a[:n], stats), feats[:n]

    def pool_features(self, params, pool_x) -> torch.Tensor:
        """(N, D) pooled last-hidden features on the device, from the same
        sweep as :meth:`score` — k-center consumes them there."""
        return self.score(params, pool_x)[1]

    def score_host(self, params, pool_x) -> Tuple[ScoreStats, np.ndarray]:
        """:meth:`score` fetched to host numpy (the task-facade boundary)."""
        stats, feats = self.score(params, pool_x)
        return (L.map_stats(lambda a: a.cpu().numpy(), stats),
                feats.cpu().numpy())

    def top_k(self, params, pool_x, k: int,
              metric: str = "margin") -> np.ndarray:
        """Indices (into ``pool_x`` rows) of the k most uncertain samples,
        most-uncertain-first; among equal scores the lower index first
        (the rule ``lax.top_k`` follows — a stable sort keeps it)."""
        xs, n = self._pack(pool_x)
        k = min(k, n)
        if k <= 0:
            return np.zeros((0,), np.int64)
        stats, _ = self._score_packed(params, xs)
        scores = uncertainty_from_stats(stats, metric)
        valid = torch.arange(scores.shape[0], device=scores.device) < n
        scores = torch.where(valid, scores, -torch.inf)
        order = torch.sort(scores, descending=True, stable=True).indices
        return order[:k].cpu().numpy().astype(np.int64)

    def rank_confident(self, params, pool_x,
                       metric: str = "margin") -> np.ndarray:
        """Full pool ordering most-confident-first (L(.)); scores from the
        device sweep, the stable argsort on the host."""
        stats, _ = self.score(params, pool_x)
        scores = uncertainty_from_stats(stats, metric).cpu().numpy()
        return np.argsort(scores, kind="stable")


def score_pool_reference(model, params, pool_x, chunk: int = 2048,
                         device="cuda") -> Tuple[ScoreStats, np.ndarray]:
    """The seed host loop: chunked forward, last-position logits to the
    host per chunk, statistics at the end.  Exact; the engine's oracle."""
    key = _POOLS[model.cfg.family][0]
    w = resolve_head_weight(model.cfg, params).float()
    outs, feats = [], []
    pool = np.asarray(pool_x)
    with torch.no_grad():
        for lo in range(0, pool.shape[0], chunk):
            x = torch.as_tensor(pool[lo:lo + chunk], device=device)
            hidden = model.forward(params, {key: x})
            outs.append((hidden[:, -1].float() @ w).cpu().numpy())
            feats.append(hidden[:, -1].float().cpu().numpy())
    stats = L.score_stats_from_logits(torch.as_tensor(np.concatenate(outs)))
    return (L.map_stats(lambda a: a.numpy(), stats), np.concatenate(feats))
