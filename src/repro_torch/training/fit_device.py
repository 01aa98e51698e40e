"""Retrain engine (``repro.training.fit_device``) — MCAL's per-iteration
training pass: retrain from scratch on the labeled set for a fixed number
of epochs.

The schedule is the reference's: ``(steps_per_epoch, bs) =
pack_shape(n, batch_size)`` (:func:`fit_plan`), one epoch sweeps the padded
row count, and the ragged tail of each epoch wraps into the front of the
same epoch's order (``pos = (s*bs + arange(bs)) % n``), so padding rows are
never trained on.  Epoch orders are permutations of the padded row range
with the valid (< n) entries stably partitioned to the front
(:func:`epoch_orders`), drawn from a ``torch.Generator`` seeded per
(seed, n).

On a CUDA device :meth:`FitEngine.fit` is the counterpart of the
reference's one fused program per ``fit_plan`` bucket: one train step is
captured as a CUDA graph per bucket ``(spe, bs, n_pad)``
(:class:`_RetrainGraph`) and replayed ``epochs * spe`` times for every
retrain in that bucket.  Static device buffers hold the padded ``(x, y)``,
the flattened ``(epochs, n_pad)`` orders, the train state, the step index
``t`` and ``n`` (device scalars); the step gathers
``orders[e][(s*bs + arange) % n]`` with ``e, s = divmod(t, spe)``, reads
``lr`` and the bias corrections' reciprocals from per-step tables, and
writes the new state back in place.  Every kernel the graph replays is one
the eager loop launches with the same operands, so its params and losses
are bit-identical to :meth:`FitEngine.fit_eager`.  :meth:`warm` captures
buckets ahead of use (the reference compiles them in ``warm``).  On the
CPU ``fit`` is the eager loop (a batch gathered on the device per step),
and ``fit_reference`` is the reference's per-step host loop (a numpy
gather and one upload per batch).  All three consume the identical orders.

Each takes an optional injected ``(init_params, orders)`` — the seam the
cross-framework tests use to feed the JAX package's init and shuffles,
which ``jax.random`` makes and a torch generator cannot reproduce.  The
labeled set can stay device-resident across MCAL iterations
(:meth:`extend_resident` / :meth:`fit_resident`, same bucket graphs), and
:meth:`submit_fit` / :meth:`submit_call` run on the engine's worker
thread.

One engine serves many threads (the fleet's tenants share it): a bucket's
graph is captured once, under the engine's lock, and each retrain loads
its inputs, replays and copies its params out under that lock, so every
caller gets the params it would get alone.  Several engines retrain at
once in architecture selection (one per candidate, each on its own fit
worker); their captures take :data:`CAPTURE_LOCK` in turn.
``torch.cuda.graph``'s entry synchronizes the device and empties the
allocator's caches, and while another thread captures, that fails on the
card ("operation not permitted when stream is capturing") and
invalidates the other capture.  Replays of captured graphs do not take
the lock.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.scoring import pack_shape
from repro_torch.core.worker import SerialWorker
from repro_torch.models.param import derive_seed
from repro_torch.serving.sweep import SweepFuture as FitFuture
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule
from repro_torch.training.train_loop import init_train_state, make_train_step

# one CUDA graph capture at a time in the process, whichever engine makes it
CAPTURE_LOCK = threading.Lock()


def fit_plan(n: int, batch_size: int) -> Tuple[int, int, int]:
    """``(steps_per_epoch, bs, n_pad)`` with ``n_pad = steps_per_epoch *
    bs`` — the :func:`scoring.pack_shape` pow2 bucketing."""
    spe, bs = pack_shape(n, batch_size)
    return spe, bs, spe * bs


def epoch_orders(seed: int, epochs: int, n_pad: int, n: int) -> torch.Tensor:
    """(epochs, n_pad) int64 row orders on the CPU: per epoch a random
    permutation of the padded row range with its valid (< n) entries
    stably partitioned to the front, so the first-n prefix is a uniform
    random permutation of the true rows."""
    g = torch.Generator().manual_seed(derive_seed(seed, n))
    out = []
    for _ in range(epochs):
        perm = torch.randperm(n_pad, generator=g)
        out.append(perm[torch.argsort((perm >= n).to(torch.int8),
                                      stable=True)])
    return torch.stack(out)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    epochs: int = 40
    batch_size: int = 256


class _RetrainGraph:
    """One train step of one ``fit_plan`` bucket, captured as a CUDA graph
    over static buffers (its own private memory pool); :meth:`run` is a
    whole retrain: load the inputs, replay ``epochs * spe`` times."""

    def __init__(self, engine: "FitEngine", key: Tuple[int, int, int],
                 state: Dict):
        spe, bs, n_pad = key
        dev = engine.device
        self.spe, self.bs, self.n_pad = spe, bs, n_pad
        self.steps = engine.cfg.epochs * spe
        self._step_fn = engine._step
        self.x = torch.zeros((n_pad, engine.model.cfg.input_dim),
                             device=dev)
        self.y = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
        self.orders = torch.zeros((engine.cfg.epochs * n_pad,),
                                  dtype=torch.int64, device=dev)
        self.n = torch.ones((), dtype=torch.int64, device=dev)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.losses = torch.zeros((self.steps,), device=dev)
        self.arange = torch.arange(bs, device=dev)
        # every retrain starts at step 0: the per-step constants are the
        # same for all of them, taken from the host step count
        sched = make_schedule(engine.tc)
        bcs = [opt.bias_corrections(t, engine.tc) for t in range(self.steps)]
        self.tables = {
            "lr": torch.tensor([sched(t) for t in range(self.steps)],
                               dtype=torch.float32, device=dev),
            "inv_bc1": torch.tensor([opt.reciprocal(b[0]) for b in bcs],
                                    dtype=torch.float32, device=dev),
            "inv_bc2": torch.tensor([opt.reciprocal(b[1]) for b in bcs],
                                    dtype=torch.float32, device=dev)}
        self.state = {"params": {k: v.clone() for k, v in
                                 state["params"].items()},
                      "opt": [{k: v.clone() for k, v in s.items()}
                              for s in state["opt"]], "step": 0}
        # the end of the last run's reads of the static buffers, for a run
        # queued on another stream to wait on
        self._done: Optional[torch.cuda.Event] = None
        # autograd's first use on a side stream, then the capture; the
        # warm-up steps only touch the static buffers every run reloads
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(min(3, self.steps)):
                self._train_step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self._train_step()

    def _train_step(self) -> None:
        t = self.t
        e, s = t // self.spe, t % self.spe
        pos = (s * self.bs + self.arange) % self.n
        rows = self.orders.index_select(0, e * self.n_pad + pos)
        batch = {"features": self.x.index_select(0, rows),
                 "labels": self.y.index_select(0, rows)}
        ti = t.view(1)
        consts = {k: v.index_select(0, ti).view(())
                  for k, v in self.tables.items()}
        new, metrics = self._step_fn(self.state, batch, consts)
        for k, p in self.state["params"].items():
            p.copy_(new["params"][k])
        for slot, fresh in zip(self.state["opt"], new["opt"]):
            for k, v in slot.items():
                v.copy_(fresh[k])
        self.losses.index_copy_(0, ti, metrics["loss"].view(1))
        t.add_(1)

    def run(self, state: Dict, orders: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor, n: int) -> Tuple[Dict, torch.Tensor]:
        """One retrain on the current stream; the caller holds the
        engine's lock, so no other run touches the static buffers until
        this one's are queued, and a run on another stream waits for
        this one's last read."""
        stream = torch.cuda.current_stream(self.x.device)
        if self._done is not None:
            stream.wait_event(self._done)
        for k, p in self.state["params"].items():
            p.copy_(state["params"][k])
        for slot, init in zip(self.state["opt"], state["opt"]):
            for k, v in slot.items():
                v.copy_(init[k])
        self.x[:n].copy_(x[:n])
        self.y[:n].copy_(y[:n])
        self.orders.copy_(orders.reshape(-1))
        self.n.fill_(n)
        self.t.zero_()
        for _ in range(self.steps):
            self.graph.replay()
        out = ({k: p.clone() for k, p in self.state["params"].items()},
               self.losses.clone())
        self._done = torch.cuda.Event()
        self._done.record(stream)
        return out


class FitEngine:
    """Fixed-epoch retrain-from-scratch for one (model, TrainConfig).

    ``fit(seed, x, y) -> (params, losses)``; ``losses`` is the per-step
    training loss, ``(epochs * steps_per_epoch,)``, on the device."""

    def __init__(self, model, tc: TrainConfig, cfg: FitConfig = FitConfig(),
                 device="cuda", mesh=None, policy: str = "tp"):
        self.model = model
        self.tc = tc
        self.cfg = cfg
        self.device = torch.device(device)
        # on a mesh every rank runs the same retrain (what GSPMD makes of
        # the reference's sharded program: equal to the unmeshed fit);
        # the policy's DTensor placements are kept for the sharded
        # layers of a later slice
        self.mesh = mesh
        self.policy = policy
        self.placements = None
        if mesh is not None:
            from repro_torch.distributed import sharding as shd
            from repro_torch.models.param import iter_specs, logical_axes
            specs = dict(iter_specs(model.specs))
            self.placements = {
                k: shd.to_placements(spec, mesh) for k, spec in
                shd.tree_pspecs(specs, logical_axes(model.specs), mesh,
                                policy).items()}
        self._step = make_train_step(model, tc)
        self._keys: set = set()          # fit_plan buckets run or warmed
        self._graphs: Dict[Tuple[int, int, int], _RetrainGraph] = {}
        self._lock = threading.Lock()    # capture + replay of the graphs
        self.captures = 0                # graphs captured (one per bucket)
        self._exec: Optional[SerialWorker] = None
        # campaign-resident labeled set: device buffers + valid row count
        self._res_x: Optional[torch.Tensor] = None
        self._res_y: Optional[torch.Tensor] = None
        self._res_n = 0
        # campaign event bus (observability only: submit/fold events of
        # async jobs; the fold emit runs on the worker thread)
        self.trace = None
        self._submit_seq = 0
        # runtime metrics (repro_torch.obs.MetricsRegistry); None = free
        # no-op
        self.metrics = None
        # resilience seam: chaos injector + broker re-dispatch policy,
        # handed to the lazy SerialWorker (site ``worker.fit-engine``)
        self.faults = None
        self.retry = None

    def attach_faults(self, faults, retry=None) -> None:
        """Wire the fault injector (and optional re-dispatch policy)
        into the engine's broker: every submitted job ticks the
        ``worker.fit-engine`` site, and transient crashes re-dispatch."""
        self.faults = faults
        if retry is not None:
            self.retry = retry
        if self._exec is not None:
            self._exec.attach_faults(faults, retry)

    def _start(self, seed: int, n: int, init_params, orders):
        """Initial train state and (epochs, n_pad) orders on the CPU: the
        injected ones where given, else the port's own draws."""
        _, _, n_pad = fit_plan(n, self.cfg.batch_size)
        if init_params is None:
            init_params = self.model.init(seed, self.device)
        params = {k: torch.as_tensor(v, device=self.device).clone()
                  for k, v in init_params.items()}
        if orders is None:
            orders = epoch_orders(seed, self.cfg.epochs, n_pad, n)
        orders = torch.as_tensor(np.array(orders), dtype=torch.int64)
        if orders.shape != (self.cfg.epochs, n_pad):
            raise ValueError(f"orders must be (epochs, n_pad) = "
                             f"{(self.cfg.epochs, n_pad)}, got "
                             f"{tuple(orders.shape)}")
        return init_train_state(self.model, self.tc, params), orders

    def _upload(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, device=self.device).long())

    # -- the retrain ---------------------------------------------------------

    def fit(self, seed: int, x, y, *, init_params: Optional[Dict] = None,
            orders=None) -> Tuple[Dict, torch.Tensor]:
        """One retrain from scratch over the labeled set ``(x, y)``: the
        bucket's CUDA graph on a CUDA device, the eager loop on the CPU."""
        x, y = self._upload(x, y)
        return self._run(seed, x, y, int(x.shape[0]), init_params, orders)

    def fit_eager(self, seed: int, x, y, *,
                  init_params: Optional[Dict] = None,
                  orders=None) -> Tuple[Dict, torch.Tensor]:
        """The eager loop on any device: one step launched per host
        iteration, every batch gathered on the device."""
        x, y = self._upload(x, y)
        n = int(x.shape[0])
        state, orders = self._start(seed, n, init_params, orders)
        return self._eager(state, orders, x, y, n)

    def _run(self, seed, x, y, n: int, init_params,
             orders) -> Tuple[Dict, torch.Tensor]:
        if self.metrics is not None:
            # fence on losses: the span covers the device retrain, not
            # just the launches; labeled by the fit_plan bucket, not the
            # raw n — O(log N) series
            n_pad = fit_plan(n, self.cfg.batch_size)[2]
            with self.metrics.span("fit", n_pad=n_pad) as sp:
                params, losses = self._run_impl(seed, x, y, n, init_params,
                                                orders)
                sp.fence(losses)
            return params, losses
        return self._run_impl(seed, x, y, n, init_params, orders)

    def _note_bucket(self, key: Tuple[int, int, int]) -> None:
        """Record a bucket touch: a cache hit when the bucket was run or
        warmed before, a miss when this is its first (capturing) use."""
        if self.metrics is not None:
            self.metrics.inc("pack_cache_hits_total" if key in self._keys
                             else "pack_cache_misses_total", engine="fit")
        self._keys.add(key)

    def _run_impl(self, seed, x, y, n: int, init_params,
                  orders) -> Tuple[Dict, torch.Tensor]:
        key = fit_plan(n, self.cfg.batch_size)
        self._note_bucket(key)
        state, orders = self._start(seed, n, init_params, orders)
        if self.device.type != "cuda":
            return self._eager(state, orders, x, y, n)
        orders = orders.to(self.device)
        with self._lock:
            return self._graph(key, state).run(state, orders, x, y, n)

    def _graph(self, key: Tuple[int, int, int], state: Dict
               ) -> _RetrainGraph:
        """The bucket's graph, captured at its first use (the caller holds
        the engine's lock; the capture takes :data:`CAPTURE_LOCK`)."""
        graph = self._graphs.get(key)
        if graph is None:
            with CAPTURE_LOCK:
                graph = self._graphs[key] = _RetrainGraph(self, key, state)
            self.captures += 1
        return graph

    def _eager(self, state, orders, x, y, n: int):
        spe, bs, _ = fit_plan(n, self.cfg.batch_size)
        orders = orders.to(self.device)
        arange = torch.arange(bs, device=self.device)
        losses = []
        for e in range(self.cfg.epochs):
            for s in range(spe):
                rows = orders[e][(s * bs + arange) % n]
                state, metrics = self._step(
                    state, {"features": x[rows], "labels": y[rows]})
                losses.append(metrics["loss"])
        return state["params"], torch.stack(losses)

    def fit_reference(self, seed: int, x, y, *,
                      init_params: Optional[Dict] = None,
                      orders=None) -> Tuple[Dict, torch.Tensor]:
        """The reference's per-step host loop: one numpy batch gather and
        one upload per step, over the same orders as :meth:`fit`."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int64)
        n = int(x.shape[0])
        spe, bs, _ = fit_plan(n, self.cfg.batch_size)
        state, orders = self._start(seed, n, init_params, orders)
        orders = orders.numpy()
        arange = np.arange(bs)
        losses = []
        for e in range(self.cfg.epochs):
            for s in range(spe):
                sel = orders[e][(s * bs + arange) % n]
                batch = {"features": torch.as_tensor(x[sel],
                                                     device=self.device),
                         "labels": torch.as_tensor(y[sel],
                                                   device=self.device)}
                state, metrics = self._step(state, batch)
                losses.append(metrics["loss"])
        return state["params"], torch.stack(losses)

    # -- campaign-resident labeled set --------------------------------------

    @property
    def resident_size(self) -> int:
        return self._res_n

    def reset_resident(self) -> None:
        self._res_x = self._res_y = None
        self._res_n = 0

    def extend_resident(self, new_x, new_y) -> int:
        """Append newly bought labels to the device-resident set (growing
        its buffers to the next ``fit_plan`` bucket when needed); returns
        the new row count.  Each MCAL iteration uploads only these rows."""
        new_x, new_y = self._upload(new_x, new_y)
        d = int(new_x.shape[0])
        if d == 0:
            return self._res_n
        n = self._res_n + d
        n_pad = fit_plan(n, self.cfg.batch_size)[2]
        if self._res_x is None:
            self._res_x = new_x.new_zeros((n_pad,) + tuple(new_x.shape[1:]))
            self._res_y = new_y.new_zeros((n_pad,))
        elif n_pad > self._res_x.shape[0]:
            grow = n_pad - self._res_x.shape[0]
            self._res_x = torch.cat([self._res_x, self._res_x.new_zeros(
                (grow,) + tuple(self._res_x.shape[1:]))])
            self._res_y = torch.cat([self._res_y,
                                     self._res_y.new_zeros((grow,))])
        self._res_x[self._res_n:n] = new_x
        self._res_y[self._res_n:n] = new_y
        self._res_n = n
        return n

    def fit_resident(self, seed: int, *, init_params: Optional[Dict] = None,
                     orders=None) -> Tuple[Dict, torch.Tensor]:
        """:meth:`fit` over the resident set, with no upload of its rows
        (the same bucket graph as :meth:`fit`)."""
        if self._res_n == 0:
            raise ValueError("resident set is empty; extend_resident first")
        n = self._res_n
        return self._run(seed, self._res_x[:n], self._res_y[:n], n,
                         init_params, orders)

    # -- async handle --------------------------------------------------------

    def _executor(self) -> SerialWorker:
        if self._exec is None:
            self._exec = SerialWorker("fit-engine", device=self.device,
                                      retry=self.retry, faults=self.faults)
            self._exec.metrics = self.metrics
        return self._exec

    def close(self) -> None:
        """Join the fit worker (idempotent; a no-op if nothing was ever
        submitted).  ``submit_fit``/``submit_call`` afterwards raise;
        ``fit`` stays valid."""
        if self._exec is not None:
            self._exec.close()

    def __enter__(self) -> "FitEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _traced(self, fn: Callable, label: str) -> Callable:
        """Bracket a worker job with fit_submit/fit_done trace events,
        paired by a per-engine job counter."""
        if self.trace is None:
            return fn
        job, self._submit_seq = self._submit_seq, self._submit_seq + 1
        self.trace.emit("fit_submit", job=int(job), what=label)
        trace = self.trace

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            trace.emit("fit_done", job=int(job), what=label)
            return out
        return wrapped

    def submit_fit(self, seed: int, x, y, **kw) -> FitFuture:
        """:meth:`fit` on the engine's worker thread; the caller overlaps
        its own work and synchronizes at ``result()``."""
        return FitFuture(self._executor().submit(
            self._traced(self.fit, "fit"), seed, x, y, **kw),
            label="fit", cancellable=self.mesh is None)

    def submit_call(self, fn: Callable, *args, **kw) -> FitFuture:
        """Run any callable on the fit worker (composite jobs such as a
        retrain and its measurement)."""
        return FitFuture(self._executor().submit(
            self._traced(fn, "call"), *args, **kw), label="fit[call]",
            cancellable=self.mesh is None)

    # -- bucket bookkeeping --------------------------------------------------

    def cache_keys(self) -> List[Tuple[int, int, int]]:
        """The (steps_per_epoch, bs, n_pad) buckets run or warmed so far —
        the reference's compile-cache keys, persisted in campaign state
        files."""
        return sorted(self._keys)

    def warm(self, keys) -> int:
        """Capture the graphs of ``keys`` (bucket tuples or raw row counts)
        not captured yet, without training; returns how many were built
        (on the CPU, where there is nothing to build, 0)."""
        if self.metrics is None:
            return self._warm_impl(keys)
        with self.metrics.span("warm", engine="fit"):
            count = self._warm_impl(keys)
        if count:
            self.metrics.inc("warm_compiles_total", count, engine="fit")
        return count

    def _warm_impl(self, keys) -> int:
        count = 0
        for k in keys:
            n_pad = int(k[2]) if isinstance(k, (tuple, list)) else \
                fit_plan(int(k), self.cfg.batch_size)[2]
            key = fit_plan(n_pad, self.cfg.batch_size)
            self._keys.add(key)
            if self.device.type != "cuda" or key in self._graphs:
                continue
            state = init_train_state(self.model, self.tc,
                                     self.model.init(0, self.device))
            with self._lock:
                if key not in self._graphs:
                    self._graph(key, state)
                    count += 1
        return count
