"""Batched serving engine (``repro.serving.engine``): prefill, scoring and
greedy decode over a fixed-size cache, on one device.

MCAL's machine-labeling pass is an inference job over the remaining pool;
:meth:`ServeEngine.score` is its per-batch step (the forward pass and the
vocab head fused into last-position :class:`ScoreStats`; on a CUDA device
the head is the ``margin_head`` kernel).  The pool-scale sweep
(``score_pool``) waits for the port of the paged sweep runtime.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scoring import head_stats, resolve_head_weight
from repro_torch.models.layers import ScoreStats
from repro_torch.models.registry import Model


class ServeEngine:
    """Minimal batched generation / scoring loop over a fixed-size cache.

    ``params`` live on ``device``; batches (``{"tokens": (B, T) ints}``) are
    moved there.  Runs under ``torch.no_grad``; the decode step updates the
    cache in place."""

    def __init__(self, model: Model, params: Dict, max_seq: int,
                 batch_size: int, device="cuda"):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.device = torch.device(device)

    def _batch(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict, int]:
        """-> (last-position logits (B, 1, V), the max_seq cache, T)."""
        batch = self._batch(batch)
        hidden, cache = self.model.prefill(self.params, batch)
        logits = self.model.logits(self.params, hidden[:, -1:, :])
        T = batch["tokens"].shape[1]
        full = self.model.init_cache(self.batch_size, self.max_seq,
                                     self.device)
        return logits, _load_cache(self.model.cfg, full, cache), T

    @torch.no_grad()
    def score(self, batch: Dict) -> ScoreStats:
        """Last-position ScoreStats for one batch, the head in fp32 (the
        reference's ``make_scoring_step``)."""
        batch = self._batch(batch)
        hidden = self.model.forward(self.params, batch)
        h = hidden[:, -1, :].float()
        w = resolve_head_weight(self.model.cfg, self.params)
        return head_stats(h, w.float())

    @torch.no_grad()
    def decode(self, cache: Dict, tokens: torch.Tensor,
               cache_len: int) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache)."""
        return self.model.decode_step(self.params, cache, tokens, cache_len)

    def score_pool(self, *args, **kwargs):
        raise NotImplementedError(
            "score_pool needs the paged sweep runtime, not ported yet "
            "(ROADMAP A.1)")

    def score_pool_async(self, *args, **kwargs):
        raise NotImplementedError(
            "score_pool_async needs the paged sweep runtime, not ported yet "
            "(ROADMAP A.1)")

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
    """Copy a prefill cache into the zero-initialized max_seq cache."""
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"serving the {cfg.family!r} family is not ported yet")
    for k in ("k", "v"):
        src = prefix["attn"][k]
        full["attn"][k][tuple(slice(0, n) for n in src.shape)] = src
    return {"attn": full["attn"], "ssm": prefix["ssm"]}
