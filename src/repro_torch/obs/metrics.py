# Low-overhead runtime metrics: counters, gauges, log-bucket histograms,
# nested spans.  torch-free by construction (the device fence reaches torch
# only for a value that is a torch tensor) so report tooling imports it
# anywhere.
"""Runtime metrics & profiling registry (``repro.obs.metrics``, the
port's own copy; the obs/ half of observability).

Division of labor with ``repro_torch.trace``: the trace store records the
campaign's *decision* stream — what was bought, measured, and chosen —
and must replay bit-identically.  This module records where the
*runtime* went: wall-clock per engine hot path, compile-cache hits vs
misses, queue depths, per-tenant attribution.  Metric events ride the
same JSONL transport as the trace (kinds ``metric_span`` /
``metric_snapshot``) but are classified ``OBSERVABILITY_KINDS``, so
``replay.diff()`` between an instrumented and an uninstrumented campaign
stays clean.

Design constraints:

* **Bounded memory.**  Histograms keep fixed log-spaced bucket counts
  plus sum/count/min/max — never raw samples.  A week-long campaign
  holds the same few KB per metric as a smoke test.
* **One lock.**  All mutation goes through a single registry lock;
  critical sections are a dict lookup + float add, so contention from
  concurrent tenant rounds stays negligible.
* **Disabled mode is free.**  Every instrumented call site guards on
  ``metrics is None`` (mirroring the ``trace is None`` convention), so
  an un-instrumented run executes byte-identical code.

Spans nest per thread::

    with registry.span("iteration"):
        with registry.span("sweep", sink="stats") as sp:
            out = adapter.score(params, page)
            sp.fence(out)        # wait for out's device work at exit

and a :class:`Span` doubles as a decorator.  ``registry.bind(tenant=t)``
pushes thread-local labels onto everything recorded by that thread —
the orchestrator wraps each tenant round in a bind so shared-engine
spans attribute per tenant without threading ids through every call.
"""
from __future__ import annotations

import bisect
import functools
import math
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_BUCKETS", "MetricsRegistry", "Span", "log_buckets",
    "get_registry", "set_registry",
]


def log_buckets(lo: float = 1e-6, hi: float = 100.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per factor of 10; the implicit +Inf overflow
    bucket is always present, so the bucket count is ``len(bounds)+1``
    regardless of what gets observed."""
    if not (lo > 0.0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (k / per_decade) for k in range(n + 1))


# seconds-scale default: 1us .. 100s at 4 buckets/decade (33 bounds)
DEFAULT_BUCKETS = log_buckets(1e-6, 100.0, per_decade=4)

_LabelKey = Tuple[Tuple[str, str], ...]
_Key = Tuple[str, _LabelKey]


class _Hist:
    """Streaming histogram: per-bucket counts + sum/count/min/max.

    Bounds are upper edges (``value <= bounds[i]`` lands in bucket i);
    values above the last bound land in the overflow slot.  No samples
    are retained."""

    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def to_dict(self) -> Dict:
        return {
            "buckets": list(self.bounds), "counts": list(self.counts),
            "sum": self.sum, "count": self.count,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
        }


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _cuda_tensor(value: object):
    """The first CUDA tensor in ``value`` (a tensor, or a tuple, list or
    dict holding them), else None."""
    torch = sys.modules.get("torch")    # no torch loaded: no tensor here
    if torch is None:
        return None
    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            t = _cuda_tensor(v)
            if t is not None:
                return t
    return None


def _fence_event(value: object):
    """A CUDA event recorded now on the current stream of ``value``'s
    device (None where ``value`` holds no CUDA tensor)."""
    t = _cuda_tensor(value)
    if t is None:
        return None
    import torch

    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


class Span:
    """One timed region: context manager AND decorator.

    Entering pushes onto the thread's span stack (giving a nested
    ``path`` like ``round/iteration/sweep``), exiting records the
    wall-clock into the ``span_seconds`` histogram and — when the
    registry has a trace attached — emits a ``metric_span`` event.
    ``fence(x)`` records a CUDA event on the current stream of ``x``'s
    device, and the span's exit waits for that event: the recorded time
    covers the device work queued before ``x`` was fenced, not just the
    host-side submit, and not the work other threads queue meanwhile (a
    device-wide synchronize would charge one tenant's span with every
    tenant's kernels).  An exception unwinds
    the stack normally and stamps the span ``status="error"`` (and is
    re-raised — spans never swallow)."""

    __slots__ = ("registry", "name", "labels", "path", "_t0", "_fences")

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: Dict[str, object]):
        self.registry = registry
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.path = name
        self._t0 = 0.0
        self._fences: List[object] = []

    def fence(self, value: object) -> None:
        """Mark where ``value``'s device work ends, for span exit to wait
        on (a value with no CUDA tensor in it needs no wait)."""
        if value is not None:
            self._fences.append(_fence_event(value))

    def __enter__(self) -> "Span":
        stack = self.registry._span_stack()
        if stack:
            self.path = stack[-1].path + "/" + self.name
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        fenced = False
        if self._fences and etype is None:
            for event in self._fences:
                if event is not None:
                    event.synchronize()
            fenced = True
        seconds = time.perf_counter() - self._t0
        stack = self.registry._span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        status = "ok" if etype is None else "error"
        self.registry._record_span(self, seconds, status, fenced)
        return False  # never swallow

    def __call__(self, fn):
        """Decorator form: each call runs inside a fresh span."""
        registry, name, labels = self.registry, self.name, self.labels

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with registry.span(name, **labels):
                return fn(*args, **kwargs)

        return wrapper


class MetricsRegistry:
    """Thread-safe process metrics: counters, gauges, histograms, spans.

    Keys are ``(name, sorted-label-items)``; thread-locally *bound*
    labels (see :meth:`bind`) merge under every metric the thread
    records, losing to explicit labels on collision.  ``attach_trace``
    tees span events into a :class:`repro_torch.trace.TraceStore` so the
    metrics stream interleaves with (or sits beside) the campaign
    trace; ``snapshot()`` returns a JSON-ready structure and
    ``write_prometheus`` renders the textfile exposition format."""

    def __init__(self, *, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 trace: Optional[object] = None):
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, _Hist] = {}
        self._buckets = tuple(float(b) for b in buckets)
        self._local = threading.local()
        self.trace = trace

    # -- thread-local state ------------------------------------------------
    def _span_stack(self) -> List[Span]:
        try:
            return self._local.spans
        except AttributeError:
            self._local.spans = []
            return self._local.spans

    def _bound(self) -> Dict[str, str]:
        try:
            return self._local.bound
        except AttributeError:
            self._local.bound = {}
            return self._local.bound

    def bind(self, **labels):
        """Context manager: merge ``labels`` under every metric this
        thread records while inside (explicit labels win)."""
        return _Bind(self, {str(k): str(v) for k, v in labels.items()})

    def _key(self, name: str, labels: Dict[str, object]) -> _Key:
        bound = self._bound()
        if bound:
            merged = dict(bound)
            merged.update(labels)
            labels = merged
        return (name, _label_key(labels))

    # -- counters / gauges / histograms ------------------------------------
    def inc(self, name: str, value: float = 1.0, /, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, /, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def add_gauge(self, name: str, delta: float, /, **labels) -> float:
        """Relative gauge move (queue depths); returns the new value."""
        key = self._key(name, labels)
        with self._lock:
            v = self._gauges.get(key, 0.0) + float(delta)
            self._gauges[key] = v
            return v

    def observe(self, name: str, value: float, /, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(self._buckets)
            h.observe(value)

    # -- spans -------------------------------------------------------------
    def span(self, name: str, /, **labels) -> Span:
        return Span(self, name, labels)

    def _record_span(self, sp: Span, seconds: float, status: str,
                     fenced: bool) -> None:
        labels = dict(sp.labels)
        labels["name"] = sp.name
        self.observe("span_seconds", seconds, **labels)
        if status != "ok":
            self.inc("span_errors_total", name=sp.name)
        trace = self.trace
        if trace is not None:
            bound = self._bound()
            out = dict(bound, **sp.labels) if bound else sp.labels
            trace.emit("metric_span", name=sp.name, path=sp.path,
                       seconds=float(seconds), status=status,
                       fenced=fenced, labels=out)

    # -- export ------------------------------------------------------------
    def attach_trace(self, trace: object) -> None:
        """Tee metric events into a TraceStore (same file as the
        campaign trace, or a standalone metrics.jsonl — both replay-
        clean, the kinds are observability-only)."""
        self.trace = trace

    def snapshot(self) -> Dict:
        """Point-in-time JSON-ready dump of every metric."""
        with self._lock:
            counters = [{"name": n, "labels": dict(lk), "value": v}
                        for (n, lk), v in sorted(self._counters.items())]
            gauges = [{"name": n, "labels": dict(lk), "value": v}
                      for (n, lk), v in sorted(self._gauges.items())]
            hists = [dict({"name": n, "labels": dict(lk)}, **h.to_dict())
                     for (n, lk), h in sorted(self._hists.items())]
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def emit_snapshot(self, **extra) -> None:
        """Emit the full registry state as one ``metric_snapshot``
        event (observability kind — replay/diff ignore it)."""
        if self.trace is not None:
            self.trace.emit("metric_snapshot", snapshot=self.snapshot(),
                            **extra)

    def write_prometheus(self, path: str) -> None:
        from repro_torch.obs.export import write_prometheus

        write_prometheus(self.snapshot(), path)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


class _Bind:
    __slots__ = ("registry", "labels", "_saved")

    def __init__(self, registry: MetricsRegistry, labels: Dict[str, str]):
        self.registry = registry
        self.labels = labels
        self._saved: Dict[str, str] = {}

    def __enter__(self):
        bound = self.registry._bound()
        self._saved = dict(bound)
        bound.update(self.labels)
        return self

    def __exit__(self, *exc):
        self.registry._local.bound = self._saved
        return False


# -- process-wide default registry ----------------------------------------
_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use).  Launchers and
    benchmarks share it so one snapshot covers the whole run; tests
    build private registries instead."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    global _default
    with _default_lock:
        _default = registry
