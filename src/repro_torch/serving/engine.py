"""Batched serving engine (``repro.serving.engine``): prefill, scoring and
greedy decode over a fixed-size cache, on one device or over a mesh.

MCAL's machine-labeling pass is an inference job over the remaining pool;
:meth:`ServeEngine.score` is its per-batch step (the forward pass and the
vocab head fused into last-position :class:`ScoreStats`; on a CUDA device
the head is the ``margin_head`` kernel).  :meth:`ServeEngine.score_pool`
streams a token pool of any size through that step as paged,
double-buffered sweep work (``serving.sweep``, ``ServeSweepAdapter``).

Over a ``mesh`` (the reference's ``make_{prefill,scoring,decode}_step``
with ``mesh`` and ``policy``): the parameters are stored as ``policy``
shards them (``DTensor`` blocks; each layer computes on the blocks of its
tensor-parallel dims and gathers the rest, ``sharding.block``), a request
batch is split over the policy's batch axes where they divide it (each
rank computes its rows; ranks along the other axes the same rows, each
its heads, MLP columns and vocabulary block), the KV and SSM caches hold
each rank's rows and the KV cache each rank's block of positions (the
reference's ``cache_seq``: decode is flash-decode over the blocks; the
cache's length is ``max_seq`` rounded up to a multiple of the ranks it
splits over), and logits and stats are gathered in row order, so every
rank returns what the unmeshed engine does, up to the order of the sums
over "model".  Collectives run over the calling thread's own copy of each
group (``MeshView`` ``threads``: the caller's and the sweep worker's).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scoring import head_stats, resolve_head_weight
from repro_torch.distributed import sharding as shd
from repro_torch.models import param as P
from repro_torch.models.layers import ScoreStats
from repro_torch.models.registry import Model

# the threads that issue an engine's passes over a mesh: the caller's and
# the sweep runner's worker (``score_pool_async``)
THREADS = ("MainThread", "pool-sweep")


class ServeEngine:
    """Minimal batched generation / scoring loop over a fixed-size cache.

    ``params`` live on ``device``; batches (``{"tokens": (B, T) ints}``,
    with ``"patch_embeds"`` (B, P, D) fp32 for a VLM, ``"audio_frames"``
    (B, encoder_tokens, D) fp32 for audio) are moved there.
    Runs under ``torch.no_grad``; the decode step updates the cache in
    place.  A VLM's cache holds its P patch positions before the prompt's
    T, so ``max_seq`` must cover P + T + the tokens generated."""

    def __init__(self, model: Model, params: Dict, max_seq: int,
                 batch_size: int, device="cuda", mesh=None,
                 policy: str = "tp", force: bool = False):
        """``mesh``: a ``DeviceMesh`` of the process group; ``params``
        (whole, the same on every rank, or already placed) are then stored
        as ``policy`` shards them.  ``force`` keeps the policy's axes of
        one rank and takes every collective over them."""
        self.model = model
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.mesh = mesh
        self.policy = policy
        self._view = None
        if mesh is not None:
            self._view = shd.MeshView(mesh, force=force, threads=THREADS,
                                      policy=policy)
            sh = {k: shd.named(mesh, shd.logical_to_pspec(
                      sp.shape, sp.logical, mesh, policy, keep_unit=force))
                  for k, sp in P.iter_specs(model.specs)}
            params = {k: v if shd.is_placed(v) else shd.distribute(v, sh[k])
                      for k, v in params.items()}
        self.params = params
        self._sweep_runners: Dict[int, Any] = {}

    def _rows(self, n: int) -> Tuple[str, ...]:
        """The mesh axes ``n`` request rows split over: the policy's batch
        axes that divide ``n`` (none without a mesh)."""
        if self.mesh is None:
            return ()
        spec = shd.logical_to_pspec((n,), ("batch",), self.mesh, self.policy,
                                    keep_unit=self._view.force)
        return shd._axes(spec[0])

    def _local(self, x: torch.Tensor, rows: Tuple[str, ...]):
        """This rank's rows of ``x`` under the split over ``rows``."""
        return shd.narrow(x, (rows,), self._view) if rows else x

    def _gather(self, x: torch.Tensor, rows: Tuple[str, ...]):
        """Rows split over ``rows`` whole again, in row order."""
        return shd.gather(x, (rows,), self._view) if rows else x

    def _mesh_for(self, rows: Tuple[str, ...]):
        return None if self._view is None else self._view.with_rows(rows)

    def _cache_len(self, mesh) -> int:
        """``max_seq`` rounded up to a multiple of the ranks the cache's
        positions split over (the positions past ``max_seq`` are never
        attended)."""
        if mesh is None:
            return self.max_seq
        sizes = mesh.sizes()
        parts = math.prod(sizes[a] for a in shd.cache_axes(mesh))
        return -(-self.max_seq // parts) * parts

    def _batch(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict, int]:
        """-> (last-position logits (B, 1, V), the max_seq cache (this
        rank's rows and block of positions over a mesh), the positions it
        holds: P + T, the patches and the prompt)."""
        batch = self._batch(batch)
        rows = self._rows(int(batch["tokens"].shape[0]))
        batch = {k: self._local(v, rows) for k, v in batch.items()}
        mesh = self._mesh_for(rows)
        S = self._cache_len(mesh)
        hidden, cache = self.model.prefill(self.params, batch, mesh=mesh,
                                           max_seq=S)
        logits = self.model.logits(self.params, hidden[:, -1:, :], mesh)
        T = hidden.shape[1]
        sizes = shd.mesh_axis_sizes(self.mesh) if rows else {}
        full = self.model.init_cache(
            self.batch_size // math.prod(sizes[a] for a in rows), S,
            self.device, mesh=mesh)
        return (self._gather(logits, rows),
                _load_cache(self.model.cfg, full, cache), T)

    def score(self, batch: Dict) -> ScoreStats:
        """Last-position ScoreStats for one batch (the pass
        :meth:`score_pool` sweeps over the remaining pool)."""
        return self._score(self.params, self._batch(batch))

    @torch.no_grad()
    def _score(self, params: Dict, batch: Dict) -> ScoreStats:
        """The scoring step over a batch on the device, the head in fp32
        (the reference's ``make_scoring_step``); over a mesh on this
        rank's rows, the stats gathered whole."""
        rows = self._rows(int(batch["tokens"].shape[0]))
        batch = {k: self._local(v, rows) for k, v in batch.items()}
        mesh = self._mesh_for(rows)
        hidden = self.model.forward(params, batch, mesh=mesh)
        h = hidden[:, -1, :].float()
        if mesh is not None:   # the one leaf margin_head reads, whole
            cfg = self.model.cfg
            key = "cls_head" if "cls_head" in params else \
                "embed" if cfg.tie_embeddings else "lm_head"
            params = {key: shd.whole(params[key], mesh)}
        w = resolve_head_weight(self.model.cfg, params)
        stats = head_stats(h, w.float())
        return ScoreStats(*(self._gather(a, rows) for a in stats))

    @torch.no_grad()
    def decode(self, cache: Dict, tokens: torch.Tensor,
               cache_len: int) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache);
        over a mesh the cache is this rank's rows and the logits whole."""
        rows = self._rows(int(tokens.shape[0]))
        mesh = self._mesh_for(rows)
        logits, cache = self.model.decode_step(
            self.params, cache, self._local(tokens, rows), cache_len,
            mesh=mesh, max_seq=self._cache_len(mesh))
        return self._gather(logits, rows), cache

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
    K/V leaves are copied in at the cache's first position (a split
    cache's: the rank's block's, whose positions the prefill gave; SSM
    states are taken as they
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
