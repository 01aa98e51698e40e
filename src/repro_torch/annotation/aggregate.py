"""Device-resident vote aggregation: majority vote + Dawid-Skene EM
(``repro.annotation.aggregate``).

The annotation service answers every label request with a column of votes
per worker — an ``(items, workers)`` int matrix with ``-1`` where a worker
was not asked.  :class:`VoteAggregator` turns votes into labels on an
explicit device:

* majority vote: one-hot vote counts and a first-index ``argmax``
  (``torch.argmax`` returns the first maximal index on the CPU and on a
  CUDA device, as numpy's does);
* Dawid-Skene EM: ``em_iters`` fixed iterations with no host sync inside,
  each an M-step gemm ``pv.T @ onehot2`` and an E-step gemm
  ``onehot2 @ log(conf)^T`` against the flattened (N, W*C) vote indicator,
  in the reference's order of operations (smoothing, row-max shift, padded
  rows masked out of the prior and confusion sums).  The gemms run in
  IEEE fp32: :func:`_fp32_matmul` switches TF32 off around them;
* the item dimension is padded through ``scoring.pack_shape``'s pow2
  bucketing (``cache_keys()`` lists the buckets, as the other engines'
  do).

The host NumPy references (:func:`majority_vote_host`,
:func:`dawid_skene_host`) are copies of the reference's oracles.

Oracle contract: majority vote agrees EXACTLY with the host reference
(small integer counts, first-index tie-break); Dawid-Skene posteriors,
confusion and prior are atol-bounded (host float64 vs device fp32) with
identical argmax labels.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scoring import pack_shape


# ---------------------------------------------------------------------------
# host references (the oracles)
# ---------------------------------------------------------------------------


def vote_counts_host(votes: np.ndarray, num_classes: int) -> np.ndarray:
    """(N, C) per-class vote counts; ``votes`` is (N, W) with -1 = no vote."""
    votes = np.asarray(votes, np.int64)
    N, W = votes.shape
    counts = np.zeros((N, num_classes), np.int64)
    for w in range(W):
        col = votes[:, w]
        m = col >= 0
        np.add.at(counts, (np.nonzero(m)[0], col[m]), 1)
    return counts


def majority_vote_host(votes: np.ndarray, num_classes: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Majority vote with FIRST-class-index tie-break.  Returns
    ``(labels, confidence)`` where confidence = top count / total votes
    (0 for rows with no votes, labeled class 0)."""
    counts = vote_counts_host(votes, num_classes)
    labels = np.argmax(counts, axis=1).astype(np.int64)
    total = counts.sum(axis=1)
    top = counts[np.arange(len(counts)), labels]
    conf = np.divide(top, np.maximum(total, 1), dtype=np.float64)
    return labels, conf


@dataclasses.dataclass
class DSResult:
    """Dawid-Skene deliverable: per-item posteriors + aggregated labels +
    the estimated per-worker confusion stack and class prior."""

    posterior: np.ndarray    # (N, C)
    labels: np.ndarray       # (N,) argmax posterior
    confidence: np.ndarray   # (N,) max posterior
    confusion: np.ndarray    # (W, C, C) estimated P(vote=l | true=c)
    prior: np.ndarray        # (C,)


def dawid_skene_host(votes: np.ndarray, num_classes: int, *,
                     em_iters: int = 12, smoothing: float = 0.01
                     ) -> DSResult:
    """The NumPy reference EM (float64, per-worker loop).  Initialized from
    soft majority counts; each iteration runs the M-step (class prior +
    per-worker confusion from the current posteriors, Laplace-smoothed)
    then the E-step (log-posterior accumulation over workers)."""
    votes = np.asarray(votes, np.int64)
    N, W = votes.shape
    C = num_classes
    mask = votes >= 0
    v = np.where(mask, votes, 0)
    counts = vote_counts_host(votes, C).astype(np.float64)
    post = (counts + 1.0 / C) / (counts.sum(1, keepdims=True) + 1.0)
    onehot = np.zeros((N, W, C), np.float64)
    for w in range(W):
        onehot[np.arange(N), w, v[:, w]] = mask[:, w]
    for _ in range(max(em_iters, 1)):
        prior = post.mean(axis=0)
        conf = np.full((W, C, C), smoothing, np.float64)
        for w in range(W):
            conf[w] += post.T @ onehot[:, w, :]          # (C, C)
        conf /= conf.sum(axis=2, keepdims=True)
        logp = np.log(prior)[None, :]
        logp = np.repeat(logp, N, axis=0)
        for w in range(W):
            lw = np.log(conf[w][:, v[:, w]]).T            # (N, C)
            logp = logp + np.where(mask[:, w][:, None], lw, 0.0)
        logp -= logp.max(axis=1, keepdims=True)
        post = np.exp(logp)
        post /= post.sum(axis=1, keepdims=True)
    labels = np.argmax(post, axis=1).astype(np.int64)
    return DSResult(posterior=post, labels=labels,
                    confidence=post.max(axis=1),
                    confusion=conf, prior=prior)


# ---------------------------------------------------------------------------
# the device engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggregateConfig:
    em_iters: int = 12
    smoothing: float = 0.01
    microbatch: int = 1024   # pack_shape bucketing granularity for the
                             # item dimension


@contextlib.contextmanager
def _fp32_matmul():
    """IEEE fp32 products for the EM gemms whatever the caller's TF32
    setting, restored afterwards."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _majority_device(votes: torch.Tensor, num_classes: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Npad, W) -> (labels, confidence): one-hot counts + first-index
    argmax (exact small-integer counts)."""
    mask = votes >= 0
    v = torch.where(mask, votes, 0).long()
    counts = torch.zeros((votes.shape[0], num_classes), dtype=torch.int32,
                         device=votes.device)
    counts.scatter_add_(1, v, mask.int())
    labels = torch.argmax(counts, dim=1)
    total = torch.clamp(counts.sum(dim=1), min=1)
    top = torch.gather(counts, 1, labels[:, None])[:, 0]
    return labels, top.float() / total.float()


def _vote_indicator(votes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The flattened (Npad, W*C) fp32 vote indicator: 1 at column
    w*C + vote for each cast vote, 0 elsewhere (padding rows too)."""
    Npad, W = votes.shape
    mask = votes >= 0
    col = torch.where(mask, votes, 0).long() + torch.arange(
        W, device=votes.device)[None, :] * num_classes
    out = torch.zeros((Npad, W * num_classes), dtype=torch.float32,
                      device=votes.device)
    return out.scatter_(1, col, mask.float())


def _dawid_skene_device(votes: torch.Tensor, n: int, num_classes: int,
                        em_iters: int, smoothing: float):
    """The EM: the host oracle's M-then-E iteration, items padded (rows
    >= n carry no votes and are masked out of the prior), ``em_iters``
    fixed iterations queued without a host sync."""
    Npad, W = votes.shape
    C = num_classes
    onehot2 = _vote_indicator(votes, C)
    row_valid = (torch.arange(Npad, device=votes.device) < n).float()
    counts = onehot2.reshape(Npad, W, C).sum(dim=1)         # (Npad, C)
    post = (counts + 1.0 / C) / (counts.sum(1, keepdim=True) + 1.0)
    conf = torch.full((W, C, C), 1.0 / C, device=votes.device)
    prior = torch.full((C,), 1.0 / C, device=votes.device)
    with _fp32_matmul():
        for _ in range(max(em_iters, 1)):
            pv = post * row_valid[:, None]
            prior = pv.sum(dim=0) / max(n, 1)
            # M-step: conf[w, c, l] = smoothing + sum_i pv[i, c] onehot[i, w, l]
            num = pv.T @ onehot2                             # (C, W*C)
            conf = smoothing + num.reshape(C, W, C).permute(1, 0, 2)
            conf = conf / conf.sum(dim=2, keepdim=True)
            # E-step: sum_w log conf[w, c, v_iw] = <onehot2, log conf>
            flat = torch.log(conf).permute(0, 2, 1).reshape(W * C, C)
            logp = torch.log(prior)[None, :] + onehot2 @ flat
            logp = logp - logp.max(dim=1, keepdim=True).values
            post = torch.exp(logp)
            post = post / post.sum(dim=1, keepdim=True)
    return post, conf, prior


@dataclasses.dataclass
class ResidentVotes:
    """A request batch's padded vote matrix, resident on the device.

    ``upload`` pays the full (Npad, W) copy once per batch;
    :meth:`VoteAggregator.scatter` then writes only the rows an adaptive
    top-up round changed, in place."""

    dev: torch.Tensor   # (Npad, W) int32, -1 = no vote (padding rows too)
    n: int              # valid rows


class VoteAggregator:
    """Aggregation engine for one ``num_classes`` on ``device``.

    ``majority(votes)`` / ``dawid_skene(votes)`` consume a host (N, W) vote
    matrix, pad the item dimension through ``scoring.pack_shape``'s pow2
    bucketing (padding rows hold -1: no votes), run on the device and trim
    back to N.  The resident path (``upload``/``scatter``/
    ``aggregate_resident``) keeps one batch's padded matrix on the device
    across adaptive top-up rounds; it runs the same programs over the same
    values, so it agrees exactly with a fresh upload.
    """

    def __init__(self, num_classes: int,
                 cfg: AggregateConfig = AggregateConfig(),
                 device="cuda"):
        assert num_classes >= 2
        self.num_classes = num_classes
        self.cfg = cfg
        self.device = torch.device(device)
        self.pack_keys: set = set()
        # runtime metrics (repro_torch.obs.MetricsRegistry); None = free
        # no-op
        self.metrics = None

    # -- packing -----------------------------------------------------------
    def _pad(self, votes) -> Tuple[torch.Tensor, int]:
        votes = np.asarray(votes, np.int32)
        assert votes.ndim == 2, "votes must be (items, workers)"
        n = votes.shape[0]
        n_mb, mb = pack_shape(n, self.cfg.microbatch)
        if self.metrics is not None:
            self.metrics.inc(
                "pack_cache_hits_total" if (n_mb, mb) in self.pack_keys
                else "pack_cache_misses_total", engine="votes")
        self.pack_keys.add((n_mb, mb))
        pad = n_mb * mb - n
        if pad:
            votes = np.concatenate(
                [votes, np.full((pad, votes.shape[1]), -1, np.int32)])
        return torch.as_tensor(votes, device=self.device), n

    def cache_keys(self) -> List[Tuple[int, int]]:
        """Sorted (n_mb, mb) pack buckets aggregated so far."""
        return sorted(self.pack_keys)

    # -- the resident batch path -------------------------------------------
    def upload(self, votes) -> ResidentVotes:
        """Pad + upload one batch's host vote matrix (top-up rounds
        :meth:`scatter` into it instead of re-uploading)."""
        vd, n = self._pad(votes)
        return ResidentVotes(dev=vd, n=n)

    def scatter(self, res: ResidentVotes, rows, vals) -> ResidentVotes:
        """Write updated rows into the resident matrix, in place (the
        reference returns a new array; nothing reads the old one): ``rows``
        (k,) row indices, ``vals`` (k, W) their new vote rows."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return res
        vals = np.asarray(vals, np.int32)
        res.dev[torch.as_tensor(rows, device=self.device)] = \
            torch.as_tensor(vals, device=self.device)
        return res

    # -- the device programs (device in, host out) -------------------------
    def _majority_dev(self, vd: torch.Tensor, n: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        labels, conf = _majority_device(vd, self.num_classes)
        return (labels[:n].cpu().numpy().astype(np.int64),
                conf[:n].cpu().numpy().astype(np.float64))

    def _dawid_skene_dev(self, vd: torch.Tensor, n: int) -> DSResult:
        post, conf, prior = _dawid_skene_device(
            vd, n, self.num_classes, self.cfg.em_iters,
            float(self.cfg.smoothing))
        post = post[:n].cpu().numpy().astype(np.float64)
        return DSResult(
            posterior=post,
            labels=np.argmax(post, axis=1).astype(np.int64),
            confidence=post.max(axis=1) if n else np.zeros((0,)),
            confusion=conf.cpu().numpy().astype(np.float64),
            prior=prior.cpu().numpy().astype(np.float64))

    # -- public API --------------------------------------------------------
    def majority(self, votes) -> Tuple[np.ndarray, np.ndarray]:
        """Device majority vote -> host ``(labels, confidence)``; exact
        twin of :func:`majority_vote_host` including the tie-break."""
        vd, n = self._pad(votes)
        return self._majority_dev(vd, n)

    def dawid_skene(self, votes) -> DSResult:
        """Device Dawid-Skene EM -> host :class:`DSResult`; atol-twin of
        :func:`dawid_skene_host` with identical argmax labels."""
        vd, n = self._pad(votes)
        return self._dawid_skene_dev(vd, n)

    def aggregate(self, votes, method: str = "majority"
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[DSResult]]:
        """``(labels, confidence, ds_result-or-None)`` under either
        aggregation method."""
        return self.aggregate_resident(self.upload(votes), method)

    def aggregate_resident(self, res: ResidentVotes, method: str = "majority"
                           ) -> Tuple[np.ndarray, np.ndarray,
                                      Optional[DSResult]]:
        """:meth:`aggregate` over an already-resident batch."""
        if method == "majority":
            labels, conf = self._majority_dev(res.dev, res.n)
            return labels, conf, None
        if method == "ds":
            out = self._dawid_skene_dev(res.dev, res.n)
            return out.labels, out.confidence, out
        raise ValueError(f"unknown aggregation method {method!r}")
