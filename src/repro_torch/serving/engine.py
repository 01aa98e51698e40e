"""Batched serving engine (``repro.serving.engine``): prefill, scoring and
greedy decode over a fixed-size cache, on one device.

MCAL's machine-labeling pass is an inference job over the remaining pool;
:meth:`ServeEngine.score` is its per-batch step (the forward pass and the
vocab head fused into last-position :class:`ScoreStats`; on a CUDA device
the head is the ``margin_head`` kernel).  :meth:`ServeEngine.score_pool`
streams a token pool of any size through that step as paged,
double-buffered sweep work (``serving.sweep``, ``ServeSweepAdapter``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scoring import head_stats, resolve_head_weight
from repro_torch.models.layers import ScoreStats
from repro_torch.models.registry import Model


class ServeEngine:
    """Minimal batched generation / scoring loop over a fixed-size cache.

    ``params`` live on ``device``; batches (``{"tokens": (B, T) ints}``,
    with ``"patch_embeds"`` (B, P, D) fp32 for a VLM, ``"audio_frames"``
    (B, encoder_tokens, D) fp32 for audio) are moved there.
    Runs under ``torch.no_grad``; the decode step updates the cache in
    place.  A VLM's cache holds its P patch positions before the prompt's
    T, so ``max_seq`` must cover P + T + the tokens generated."""

    def __init__(self, model: Model, params: Dict, max_seq: int,
                 batch_size: int, device="cuda"):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._sweep_runners: Dict[int, Any] = {}

    def _batch(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict, int]:
        """-> (last-position logits (B, 1, V), the max_seq cache, the
        positions it holds: P + T, the patches and the prompt)."""
        batch = self._batch(batch)
        hidden, cache = self.model.prefill(self.params, batch)
        logits = self.model.logits(self.params, hidden[:, -1:, :])
        T = hidden.shape[1]
        full = self.model.init_cache(self.batch_size, self.max_seq,
                                     self.device)
        return logits, _load_cache(self.model.cfg, full, cache), T

    def score(self, batch: Dict) -> ScoreStats:
        """Last-position ScoreStats for one batch (the pass
        :meth:`score_pool` sweeps over the remaining pool)."""
        return self._score(self.params, self._batch(batch))

    @torch.no_grad()
    def _score(self, params: Dict, batch: Dict) -> ScoreStats:
        """The scoring step over a batch on the device, the head in fp32
        (the reference's ``make_scoring_step``)."""
        hidden = self.model.forward(params, batch)
        h = hidden[:, -1, :].float()
        w = resolve_head_weight(self.model.cfg, params)
        return head_stats(h, w.float())

    @torch.no_grad()
    def decode(self, cache: Dict, tokens: torch.Tensor,
               cache_len: int) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache)."""
        return self.model.decode_step(self.params, cache, tokens, cache_len)

    def _sweep_runner(self, page_rows: int):
        from repro_torch.serving.sweep import (PoolSweepRunner,
                                               ServeSweepAdapter, SweepConfig)
        runner = self._sweep_runners.get(page_rows)
        if runner is None:
            runner = PoolSweepRunner(
                ServeSweepAdapter(self._score, self.device),
                SweepConfig(page_rows=page_rows))
            self._sweep_runners[page_rows] = runner
        return runner

    def score_pool(self, pool_batch: Dict, *, page_rows: Optional[int] = None,
                   sink=None, checkpoint=None):
        """MCAL's machine-labeling pass at pool scale: stream a row-aligned
        token pool (``{"tokens": (N, T)}`` on the host) through the scoring
        step in pages of ``page_rows`` (default: the batch size).  The
        default deliverable is the packed last-position ScoreStats on the
        device; a sweep sink (``TopKSink``, ``RankTop1Sink``) folds the pool
        without pool-wide stats, and a ``SweepCheckpoint`` resumes a
        preempted sweep mid-pool."""
        from repro_torch.serving.sweep import StatsSink
        runner = self._sweep_runner(page_rows or self.batch_size)
        return runner.run(self.params, pool_batch, sink or StatsSink(),
                          checkpoint=checkpoint)

    def score_pool_async(self, pool_batch: Dict, *,
                         page_rows: Optional[int] = None, sink=None,
                         checkpoint=None):
        """:meth:`score_pool` as a ``SweepFuture`` on the runner's worker
        thread; ``result()`` is the synchronization point."""
        from repro_torch.serving.sweep import StatsSink
        runner = self._sweep_runner(page_rows or self.batch_size)
        return runner.submit(self.params, pool_batch, sink or StatsSink(),
                             checkpoint=checkpoint)

    def close(self) -> None:
        """Join the sweep runners' worker threads and drop the runners
        (idempotent; a later pool pass starts new ones).  Each runner's
        adapter holds this engine's scoring step, so a kept runner would
        keep the engine, and its params, alive past its last reference
        until the cyclic collector ran."""
        for runner in self._sweep_runners.values():
            runner.close()
        self._sweep_runners.clear()

    @torch.no_grad()
    def generate(self, batch: Dict, steps: int,
                 sampler: str = "greedy") -> torch.Tensor:
        """Greedy decode: (B, steps) int32 tokens, the first from the
        prefill's logits (``torch.argmax`` keeps the first maximal index,
        as ``jnp.argmax`` does)."""
        if sampler != "greedy":
            raise ValueError(f"only greedy sampling is ported, got {sampler!r}")
        logits, cache, pos = self.prefill(batch)
        toks = []
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        for i in range(steps):
            toks.append(tok)
            logits, cache = self.decode(cache, tok, pos + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
                torch.int32)
        return torch.cat(toks, dim=1)


def _load_cache(cfg: ModelConfig, full: Dict, prefix: Dict) -> Dict:
    """Copy a prefill cache into the zero-initialized max_seq cache: the
    K/V leaves are copied in at position 0 (SSM states are taken as they
    are: the ``ssm`` family's whole cache, the hybrid's ``ssm`` part; so
    is the audio family's cross-attention cache ``xk``/``xv``); the
    reference's ``dynamic_update_slice``."""
    if cfg.family == "ssm":
        return prefix
    if cfg.family == "hybrid":
        kv, out = full["attn"], {"attn": full["attn"], "ssm": prefix["ssm"]}
        prefix = prefix["attn"]
    elif cfg.family in ("dense", "moe", "vlm"):
        kv = out = full
    elif cfg.family == "audio":
        kv = full
        out = {"k": full["k"], "v": full["v"], "xk": prefix["xk"],
               "xv": prefix["xv"]}
    else:
        raise NotImplementedError(
            f"serving the {cfg.family!r} family is not ported yet")
    for k in ("k", "v"):
        src = prefix[k]
        if src.shape[2] > kv[k].shape[2]:
            raise ValueError(
                f"the prefill holds {src.shape[2]} positions (patches and "
                f"prompt), more than the cache's max_seq {kv[k].shape[2]}")
        kv[k][tuple(slice(0, n) for n in src.shape)] = src
    return out
