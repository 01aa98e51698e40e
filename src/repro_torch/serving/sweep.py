"""Streaming pool-sweep runtime (``repro.serving.sweep``): paged,
double-buffered scoring over the remaining pool with async overlap and
resumable cursors.

MCAL's commit step and every L(.)/M(.) pass are one inference job over the
whole remaining pool.  The pool stays on the host and streams through the
scoring step as **pages**:

* each page is padded and folded with the scoring engine's pow2 bucketing
  (``scoring.pack_shape``), so every row is computed inside a microbatch
  of the same shape as in an unpaged engine pass;
* on a CUDA device the page is written into a **pinned** host buffer and
  copied with ``non_blocking=True`` on a copy stream, ``prefetch`` pages
  in flight: the copy of page i+1 overlaps page i's compute.  The compute
  stream waits on the copy's event; each device page is marked as used by
  the compute stream (``record_stream``), so the allocator hands its memory
  to a later page only after that compute has finished, and a pinned buffer
  is refilled only after the copy that read it has finished.  Device memory
  stays O(page), not O(pool);
* each page folds into a **sink** that keeps its running state on the
  device, so pool-wide statistics never reach the host:
    - :class:`TopKSink`       M(.): top-k uncertainty reservoir,
    - :class:`RankTop1Sink`   L(.)/commit: one score field + the machine
                              label per row reach the host,
    - :class:`FeatureSink`    k-center: the (N, D) pooled features,
    - :class:`StatsSink`      packed ScoreStats (``ServeEngine.score_pool``);
* :meth:`PoolSweepRunner.run_until` stops mid-pool and returns a JSON
  :class:`SweepCheckpoint` (the reference's own schema, so a cursor cut by
  either package resumes in the other); :meth:`PoolSweepRunner.run`
  continues from it bit-identically to an uninterrupted sweep;
* :meth:`PoolSweepRunner.submit` runs the sweep on the runner's worker
  thread and returns a :class:`SweepFuture`;
* one runner serves many threads at once (the fleet's tenants share it):
  each calling thread stages its pages through its own ring of pinned
  buffers, so no sweep refills a buffer another sweep is still copying.

Oracle contract (``tests/test_torch_sweep.py``): every sink agrees exactly
with the engine's unpaged pass — ragged final pages, duplicate-row ties
and resumed cursors included.  Ties break by the first global index on
both sides: the reservoir goes ahead of the page in a stable descending
sort (``torch.topk`` promises no order among equal values), and the rank
sink's host fold is the oracle's own stable argsort.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import selection as sel
from repro_torch.core.scoring import (next_pow2, pack_shape,
                                      uncertainty_from_stats)
from repro_torch.core.worker import SerialWorker
from repro_torch.models import layers as L
from repro_torch.models.layers import ScoreStats

# score field each L(.)/M(.) metric consumes — the only per-row float the
# rank sink ships to the host
_METRIC_FIELD = {"margin": "margin", "entropy": "entropy",
                 "least_confidence": "max_logprob"}


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    page_rows: int = 8192   # rows per page (a pow2 multiple of the engine
                            # microbatch, so full pages share its shape)
    prefetch: int = 2       # pages in flight: 2 = double-buffered


@dataclasses.dataclass
class SweepCheckpoint:
    """Resumable sweep cursor: the next page to score + the folded sink
    state, JSON-serializable so campaign state files can embed it."""

    next_page: int
    n: int                  # pool rows the cursor was cut against
    page_rows: int
    sink_kind: str
    sink_state: Dict

    def to_json(self) -> str:
        # strict JSON: sinks encode non-finite sentinels themselves
        return json.dumps(dataclasses.asdict(self), allow_nan=False)

    @classmethod
    def from_json(cls, blob: str) -> "SweepCheckpoint":
        return cls(**json.loads(blob))


class SweepFuture:
    """Async handle of a worker job (:meth:`PoolSweepRunner.submit`, the
    fit engine's ``FitFuture`` and the annotation broker's
    ``AnnotationFuture``).  ``result()`` is the synchronization point: the
    job's host-side results, mapped once by ``map_result``."""

    def __init__(self, future, map_result: Optional[Callable] = None,
                 label: str = "", cancellable: bool = True):
        self._future = future
        self._cancellable = cancellable
        self._map = map_result
        self._label = label
        self._done_value: Any = None
        self._mapped = False

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> bool:
        """Cancel the job if it has not started.  A job whose passes run
        collectives over a mesh is never cancelled (False): one rank's
        cancel could land before the job starts and another's after, and
        the rank that ran it would wait on collectives the other never
        issues.  It runs to its end and its result is dropped."""
        return self._cancellable and self._future.cancel()

    def result(self, timeout: Optional[float] = None):
        """The fold.  With a ``timeout`` (seconds) the wait is a wall
        budget: a job still running when it expires raises
        :class:`~repro_torch.faults.errors.StragglerTimeout` (the campaign's
        ``sweep_timeout``/``fit_timeout``).  The job keeps running on its
        daemon worker; the future stays valid for a later, longer wait."""
        if not self._mapped:
            try:
                out = self._future.result(timeout)
            except FuturesTimeout:
                from repro_torch.faults.errors import StragglerTimeout
                raise StragglerTimeout(
                    f"{self._label or 'worker job'} still running after "
                    f"its {timeout:g}s wall budget") from None
            self._done_value = self._map(out) if self._map else out
            self._mapped = True
        return self._done_value


# ---------------------------------------------------------------------------
# sinks — page folds kept on the device
# ---------------------------------------------------------------------------
#
# Sink contract: ``init(n) -> state``; ``fold(state, stats, feats, offset,
# nvalid) -> state`` consumes one page's PACKED statistics (rows past
# ``nvalid`` are padding; ``offset`` is the page's global row offset)
# without a host sync; ``finalize(state, n)`` produces the deliverable;
# ``serialize``/``deserialize`` round-trip the folded state through JSON.
# Restored state lies on the CPU and joins the pages' device at the next
# fold or at finalize.


def _joined(parts: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate on the device of the last part (restored parts lie on
    the CPU)."""
    dev = parts[-1].device
    return torch.cat([p.to(dev) for p in parts])


class TopKSink:
    """M(.) sink: the top-k uncertainty reservoir.  Finalizes to the (k,)
    global row indices, most-uncertain-first — exactly
    ``PoolScoringEngine.top_k`` without pool-wide scores."""

    kind = "topk"

    def __init__(self, k: int, metric: str = "margin"):
        if metric not in _METRIC_FIELD:
            raise ValueError(f"unknown uncertainty metric {metric!r}")
        self.k = k
        self.metric = metric

    def init(self, n: int):
        k = max(min(self.k, n), 0)
        return (torch.full((k,), -torch.inf), torch.zeros((k,), dtype=torch.int64))

    def fold(self, state, stats, feats, offset: int, nvalid: int):
        page = uncertainty_from_stats(stats, self.metric).float()
        rows = torch.arange(page.shape[0], device=page.device)
        page = torch.where(rows < nvalid, page, -torch.inf)
        scores = torch.cat([state[0].to(page.device), page])
        idx = torch.cat([state[1].to(page.device), rows + offset])
        # the reservoir (lower global indices) first, and a stable sort:
        # equal scores keep the first index, as over the full pool
        pos = torch.sort(scores, descending=True, stable=True).indices
        pos = pos[:state[0].shape[0]]
        return scores[pos], idx[pos]

    def finalize(self, state, n: int) -> np.ndarray:
        return state[1].cpu().numpy().astype(np.int64)

    def serialize(self, state) -> Dict:
        # unfilled slots hold -inf: None keeps the cursor strict JSON
        scores = [None if not np.isfinite(v) else float(v)
                  for v in state[0].cpu().numpy().astype(np.float64)]
        return {"k": self.k, "metric": self.metric, "scores": scores,
                "idx": state[1].cpu().numpy().astype(np.int64).tolist()}

    def deserialize(self, blob: Dict):
        if blob["metric"] != self.metric or blob["k"] != self.k:
            raise ValueError(
                f"checkpoint folded TopKSink(k={blob['k']}, "
                f"metric={blob['metric']!r}); cannot resume into "
                f"TopKSink(k={self.k}, metric={self.metric!r})")
        scores = np.asarray([-np.inf if v is None else v
                             for v in blob["scores"]], np.float32)
        return (torch.from_numpy(scores),
                torch.as_tensor(np.asarray(blob["idx"], np.int64)))


class RankTop1Sink:
    """L(.)/commit sink: streaming confidence rank + top1.  Folds keep
    per-page device slices; finalize ships one score field and the top1
    label per row and runs the oracle's stable argsort."""

    kind = "rank"

    def __init__(self, metric: str = "margin"):
        if metric not in _METRIC_FIELD:
            raise ValueError(f"unknown uncertainty metric {metric!r}")
        self.metric = metric
        self._field = _METRIC_FIELD[metric]

    def init(self, n: int) -> List:
        return []

    def fold(self, state, stats, feats, offset: int, nvalid: int):
        state.append((getattr(stats, self._field)[:nvalid],
                      stats.top1[:nvalid]))
        return state

    def _host(self, state) -> Tuple[np.ndarray, np.ndarray]:
        if not state:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
        return (_joined([f for f, _ in state]).cpu().numpy(),
                _joined([t for _, t in state]).cpu().numpy().astype(np.int64))

    def finalize(self, state, n: int) -> Tuple[np.ndarray, np.ndarray]:
        field, top1 = self._host(state)
        scores = sel.uncertainty_scores(
            self.metric, SimpleNamespace(**{self._field: field}))
        return np.argsort(scores, kind="stable"), top1

    def serialize(self, state) -> Dict:
        field, top1 = self._host(state)
        return {"metric": self.metric,
                "field": field.astype(np.float64).tolist(),
                "dtype": str(field.dtype), "top1": top1.tolist()}

    def deserialize(self, blob: Dict) -> List:
        if blob["metric"] != self.metric:
            raise ValueError(
                f"checkpoint folded RankTop1Sink({blob['metric']!r}); "
                f"cannot resume into RankTop1Sink({self.metric!r})")
        return [(torch.as_tensor(np.asarray(blob["field"],
                                            np.dtype(blob["dtype"]))),
                 torch.as_tensor(np.asarray(blob["top1"], np.int64)))]


class FeatureSink:
    """k-center sink: the (N, D) pooled features on the device — the paged
    twin of ``PoolScoringEngine.pool_features``.  A serialized cursor holds
    every folded feature row (O(rows swept * D) host floats)."""

    kind = "features"

    def init(self, n: int) -> List:
        return []

    def fold(self, state, stats, feats, offset: int, nvalid: int):
        if feats is None or feats.shape[-1] == 0:
            raise ValueError("sweep adapter emits no features")
        state.append(feats[:nvalid])
        return state

    def finalize(self, state, n: int) -> torch.Tensor:
        if not state:
            return torch.zeros((0, 0))
        return _joined(state)

    def serialize(self, state) -> Dict:
        feats = (self.finalize(state, -1).cpu().numpy().astype(np.float64)
                 if state else np.zeros((0, 0)))
        return {"feats": feats.tolist()}

    def deserialize(self, blob: Dict) -> List:
        feats = np.asarray(blob["feats"], np.float32)
        return [torch.from_numpy(feats)] if feats.size else []


class StatsSink:
    """Generic sink: packed :class:`ScoreStats` for the whole pool, pages
    concatenated on the device and trimmed to the pool size
    (``ServeEngine.score_pool``'s default deliverable)."""

    kind = "stats"
    _FIELDS = ("margin", "entropy", "max_logprob", "top1")

    def init(self, n: int) -> List:
        return []

    def fold(self, state, stats, feats, offset: int, nvalid: int):
        state.append(L.map_stats(lambda a: a[:nvalid], stats))
        return state

    def finalize(self, state, n: int) -> ScoreStats:
        if not state:
            z = torch.zeros((0,))
            return ScoreStats(z, z, z, torch.zeros((0,), dtype=torch.int32))
        return ScoreStats(*(_joined([getattr(s, f) for s in state])
                            for f in self._FIELDS))

    def serialize(self, state) -> Dict:
        packed = self.finalize(state, -1)
        return {f: getattr(packed, f).cpu().numpy().astype(np.float64)
                .tolist() for f in self._FIELDS}

    def deserialize(self, blob: Dict) -> List:
        if not blob["margin"]:
            return []
        return [ScoreStats(*(
            torch.as_tensor(np.asarray(blob[f], np.int32 if f == "top1"
                                       else np.float32))
            for f in self._FIELDS))]


# ---------------------------------------------------------------------------
# host-to-device staging
# ---------------------------------------------------------------------------


class _Stager:
    """Builds padded pages in pinned host buffers and copies them to a CUDA
    device on a copy stream (on the CPU a page is a plain tensor).  A ring
    of pinned buffers, one more than the pages a double-buffered sweep
    keeps in flight; each is refilled only after the copy that last read it
    has finished (a deeper prefetch waits on that, and stays correct).  A
    ring serves one thread: :class:`_ThreadStagers` gives each its own."""

    DEPTH = SweepConfig.prefetch + 1

    def __init__(self, device):
        self.device = torch.device(device)
        self._ring: List = [None] * self.DEPTH
        self._next = 0
        self._stream = None

    def upload(self, rows: np.ndarray, total: int):
        """``rows`` padded with zero rows to ``total`` -> (tensor on the
        device, the copy's event or None)."""
        rows = np.asarray(rows)
        shape = (total,) + rows.shape[1:]
        if self.device.type != "cuda":
            out = torch.zeros(shape, dtype=torch.from_numpy(rows[:0]).dtype)
            out[:len(rows)] = torch.from_numpy(np.ascontiguousarray(rows))
            return out, None
        slot = self._next % self.DEPTH
        self._next += 1
        buf, done = self._ring[slot] or (None, None)
        if done is not None:
            done.synchronize()      # the copy that read this buffer is over
        dtype = torch.from_numpy(rows[:0]).dtype
        size = int(np.prod(shape))
        if buf is None or buf.dtype != dtype or buf.numel() < size:
            buf = torch.empty(size, dtype=dtype, pin_memory=True)
        host = buf[:size].view(shape)
        host[:len(rows)] = torch.from_numpy(np.ascontiguousarray(rows))
        host[len(rows):] = 0
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            page = torch.empty(shape, dtype=dtype, device=self.device)
            page.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._ring[slot] = (buf, done)
        return page, done


class _ThreadStagers:
    """One :class:`_Stager` per (calling thread, key): two threads sweeping
    through one adapter never share a ring slot or its counter."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._local = threading.local()

    def get(self, key: str = "") -> _Stager:
        stagers = getattr(self._local, "stagers", None)
        if stagers is None:
            stagers = self._local.stagers = {}
        stage = stagers.get(key)
        if stage is None:
            stage = stagers[key] = _Stager(self.device)
        return stage


def _ready(page: torch.Tensor, copied) -> torch.Tensor:
    """Order the current (compute) stream after the page's copy, and keep
    the allocator from reusing the page's memory before that compute is
    done."""
    if copied is not None:
        stream = torch.cuda.current_stream(page.device)
        stream.wait_event(copied)
        page.record_stream(stream)
    return page


# ---------------------------------------------------------------------------
# adapters — how a page becomes device work
# ---------------------------------------------------------------------------


class EngineSweepAdapter:
    """Feeds pages through a :class:`~repro_torch.core.scoring.
    PoolScoringEngine`'s packed scoring step; pages pad on the host with
    the engine's pow2 bucketing before the copy, so per-row statistics come
    from microbatches of the unpaged pass's shape."""

    def __init__(self, engine):
        self.engine = engine
        self.device = engine.device
        self._stages = _ThreadStagers(engine.device)

    def length(self, pool) -> int:
        return int(pool.shape[0])

    def put(self, pool, lo: int, hi: int):
        n = hi - lo
        n_mb, mb = pack_shape(n, self.engine.cfg.microbatch)
        # float32 features or int32 token ids, as the engine takes them
        # (the pinned ring keys its buffers on the dtype)
        page, copied = self._stages.get().upload(
            np.asarray(pool[lo:hi], self.engine.host_dtype), n_mb * mb)
        return (page.view((n_mb, mb) + tuple(page.shape[1:])), copied), n

    def score(self, params, page):
        return self.engine.score_pages(params, _ready(*page))


class ServeSweepAdapter:
    """Feeds pages of a row-aligned token-batch dict through a serving
    scoring step ``step(params, batch) -> ScoreStats`` on ``device``;
    ragged pages pad to the next pow2 batch (at least 8 rows)."""

    def __init__(self, score_step, device):
        self._step = score_step
        self._stages = _ThreadStagers(device)
        self.device = torch.device(device)

    def length(self, pool: Dict) -> int:
        return int(next(iter(pool.values())).shape[0])

    def put(self, pool: Dict, lo: int, hi: int):
        n = hi - lo
        b = max(next_pow2(n), 8)
        page = {}
        for key, v in pool.items():
            page[key] = self._stages.get(key).upload(np.asarray(v[lo:hi]), b)
        return page, n

    def score(self, params, page):
        return self._step(params, {k: _ready(*v) for k, v in page.items()}), \
            None


class HostTaskAdapter:
    """Pages a host ``score(idx_page) -> (stats, feats)`` callable through
    the same runtime; the "pool" is the global index array itself."""

    def __init__(self, score_fn: Callable):
        self._score = score_fn

    def length(self, pool) -> int:
        return int(len(pool))

    def put(self, pool, lo: int, hi: int):
        return pool[lo:hi], hi - lo

    def score(self, params, page):
        stats, feats = self._score(page)
        return (L.map_stats(torch.as_tensor, stats),
                None if feats is None else torch.as_tensor(feats))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


class PoolSweepRunner:
    """Streams a pool of any size through a scoring step as paged,
    double-buffered, sink-folded work.  One runner per (adapter, page
    size); reusable across parameter sets and pools."""

    def __init__(self, adapter, cfg: SweepConfig = SweepConfig()):
        assert cfg.page_rows > 0
        self.adapter = adapter
        self.cfg = cfg
        self._exec: Optional[SerialWorker] = None
        # campaign event bus (observability only: page cursors and sink
        # finalizations; emits may come from the worker thread)
        self.trace = None
        # runtime metrics (repro_torch.obs.MetricsRegistry); None = free
        # no-op
        self.metrics = None
        # resilience seam: chaos injector + broker re-dispatch policy,
        # handed to the lazy SerialWorker (site ``worker.pool-sweep``)
        self.faults = None
        self.retry = None

    def attach_faults(self, faults, retry=None) -> None:
        """Wire the fault injector (and optional re-dispatch policy)
        into the runner's broker: every submitted job ticks the
        ``worker.pool-sweep`` site, and transient crashes re-dispatch."""
        self.faults = faults
        if retry is not None:
            self.retry = retry
        if self._exec is not None:
            self._exec.attach_faults(faults, retry)

    def _emit(self, kind: str, **payload) -> None:
        if self.trace is not None:
            self.trace.emit(kind, **payload)

    def n_pages(self, n: int) -> int:
        return -(-n // self.cfg.page_rows)

    # -- synchronous sweeps -------------------------------------------------

    def run(self, params, pool, sink, *,
            checkpoint: Optional[SweepCheckpoint] = None,
            checkpoint_every: int = 0,
            on_checkpoint: Optional[Callable] = None):
        """Sweep the whole pool (resuming from ``checkpoint``) and return
        the sink's deliverable.  With ``checkpoint_every`` and
        ``on_checkpoint`` a cursor is cut every N pages and handed to the
        callback (never after the last page)."""
        if self.metrics is not None:
            with self.metrics.span("sweep", sink=sink.kind):
                return self._run_sync(params, pool, sink,
                                      checkpoint=checkpoint,
                                      checkpoint_every=checkpoint_every,
                                      on_checkpoint=on_checkpoint)
        return self._run_sync(params, pool, sink, checkpoint=checkpoint,
                              checkpoint_every=checkpoint_every,
                              on_checkpoint=on_checkpoint)

    def _run_sync(self, params, pool, sink, *,
                  checkpoint: Optional[SweepCheckpoint] = None,
                  checkpoint_every: int = 0,
                  on_checkpoint: Optional[Callable] = None):
        n = self.adapter.length(pool)
        n_pages = self.n_pages(n)
        start, state = self._restore(sink, n, checkpoint)
        if checkpoint_every and on_checkpoint is not None:
            page = start
            while page < n_pages:
                stop = min(page + checkpoint_every, n_pages)
                state = self._sweep(params, pool, sink, state, page, stop, n)
                page = stop
                if page < n_pages:
                    self._emit("sweep_cut", next_page=int(page), n=int(n),
                               sink=sink.kind)
                    on_checkpoint(SweepCheckpoint(
                        next_page=page, n=n, page_rows=self.cfg.page_rows,
                        sink_kind=sink.kind,
                        sink_state=sink.serialize(state)))
        else:
            state = self._sweep(params, pool, sink, state, start, n_pages, n)
        self._emit("sweep_done", n=int(n), pages=int(n_pages),
                   resumed_from=int(start), sink=sink.kind)
        return sink.finalize(state, n)

    def run_until(self, params, pool, sink, stop_page: int, *,
                  checkpoint: Optional[SweepCheckpoint] = None
                  ) -> SweepCheckpoint:
        """Sweep up to (not including) ``stop_page`` and cut a resumable
        cursor; :meth:`run` continues from it bit-identically."""
        n = self.adapter.length(pool)
        start, state = self._restore(sink, n, checkpoint)
        stop = min(stop_page, self.n_pages(n))
        state = self._sweep(params, pool, sink, state, start, stop, n)
        self._emit("sweep_cut", next_page=int(stop), n=int(n),
                   sink=sink.kind)
        return SweepCheckpoint(next_page=stop, n=n,
                               page_rows=self.cfg.page_rows,
                               sink_kind=sink.kind,
                               sink_state=sink.serialize(state))

    # -- async handle --------------------------------------------------------

    def submit(self, params, pool, sink, *,
               checkpoint: Optional[SweepCheckpoint] = None,
               map_result: Optional[Callable] = None) -> SweepFuture:
        """:meth:`run` on the runner's worker thread; the caller overlaps
        its own work and synchronizes at ``result()``."""
        return SweepFuture(
            self._executor().submit(self.run, params, pool, sink,
                                    checkpoint=checkpoint),
            map_result, label=f"sweep[{sink.kind}]",
            cancellable=self._cancellable())

    def submit_call(self, fn: Callable, *args, **kw) -> SweepFuture:
        """Run any callable on the sweep worker (composite jobs that end in
        a sweep, like features + device k-center)."""
        return SweepFuture(self._executor().submit(fn, *args, **kw),
                           label="sweep[call]",
                           cancellable=self._cancellable())

    def _cancellable(self) -> bool:
        """False when the engine's passes run collectives over a mesh."""
        engine = getattr(self.adapter, "engine", None)
        return getattr(engine, "mesh", None) is None

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Join the sweep worker (idempotent; a no-op if nothing was ever
        submitted).  ``submit`` afterwards raises; ``run`` stays valid."""
        if self._exec is not None:
            self._exec.close()

    def __enter__(self) -> "PoolSweepRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------------

    def _executor(self) -> SerialWorker:
        if self._exec is None:
            # the adapter's device is made current on the worker thread
            self._exec = SerialWorker("pool-sweep",
                                      getattr(self.adapter, "device", None),
                                      retry=self.retry, faults=self.faults)
            self._exec.metrics = self.metrics
        return self._exec

    def _restore(self, sink, n: int,
                 ckpt: Optional[SweepCheckpoint]) -> Tuple[int, Any]:
        if ckpt is None:
            return 0, sink.init(n)
        if ckpt.sink_kind != sink.kind:
            raise ValueError(f"checkpoint folded a {ckpt.sink_kind!r} sink; "
                             f"cannot resume into {sink.kind!r}")
        if ckpt.n != n or ckpt.page_rows != self.cfg.page_rows:
            raise ValueError(
                f"checkpoint cursor (n={ckpt.n}, page_rows={ckpt.page_rows})"
                f" does not match this sweep (n={n}, "
                f"page_rows={self.cfg.page_rows})")
        return ckpt.next_page, sink.deserialize(ckpt.sink_state)

    def _sweep(self, params, pool, sink, state, start: int, stop: int,
               n: int):
        P = self.cfg.page_rows
        m = self.metrics
        clock = time.perf_counter
        queue: List = []
        nxt = start
        depth = max(self.cfg.prefetch, 1)

        def put_page(i: int):
            # h2d submit latency (the copy itself overlaps compute)
            t0 = clock() if m is not None else 0.0
            out = self.adapter.put(pool, i * P, min((i + 1) * P, n))
            if m is not None:
                m.observe("sweep_put_seconds", clock() - t0)
            return out

        while nxt < stop and len(queue) < depth:
            queue.append(put_page(nxt))
            nxt += 1
        for p in range(start, stop):
            page, nvalid = queue.pop(0)
            t0 = clock() if m is not None else 0.0
            stats, feats = self.adapter.score(params, page)
            if m is not None:
                # launch-side latency only: the device work stays queued
                # and overlaps the next page's copy below
                m.observe("sweep_score_submit_seconds", clock() - t0)
            if nxt < stop:   # the next page's copy overlaps this compute
                queue.append(put_page(nxt))
                nxt += 1
            t0 = clock() if m is not None else 0.0
            state = sink.fold(state, stats, feats, p * P, nvalid)
            if m is not None:
                m.observe("sweep_fold_seconds", clock() - t0)
                m.inc("sweep_pages_total")
                m.inc("sweep_rows_total", float(nvalid))
        return state
