"""Append-only campaign trace store (``repro.trace.store``, the port's own
copy): the event log every decision site emits through.  The file format
is the reference's, so each package reads the other's traces and resumes
the other's cursors.

One :class:`TraceStore` is one campaign's audit trail — an append-only
JSONL file where every event carries a monotone sequence number and the
campaign id::

    {"seq": 17, "campaign": "cifar10-resnet18-s0", "kind": "iteration",
     "ts": 1754650000.123, "payload": {...}}

Design contract (what makes replay/diff sound):

* **append-only, monotone seq** — events are never rewritten; ``seq``
  increases by exactly 1 per event, so a gap or duplicate is corruption
  by definition (``replay`` validates this);
* **buffered off the hot path** — ``emit`` appends to an in-memory
  buffer under a lock (safe for the async sweep/fit worker threads) and
  only touches the file every ``flush_every`` events or on an explicit
  :meth:`flush` (campaign checkpoints flush BEFORE the state file is
  written, so a persisted trace cursor always points inside the file);
* **wall-clock ``ts`` is observability metadata only** — replay and diff
  ignore it, so sibling runs of a deterministic campaign produce
  byte-comparable *decision* streams even though their timestamps differ;
* **strict JSON** — payloads must be finite (``allow_nan=False``);
  emitters encode non-finite sentinels themselves (the same convention
  as ``SweepCheckpoint``), so a NaN reaching the store is an emitter bug;
* **resume truncates, never forks** — a preempted campaign restarts from
  a state checkpoint whose embedded trace cursor (``next_seq``) marks the
  last event the checkpoint knew about; :meth:`TraceStore.resume` drops
  any events written after that cut (work the resumed campaign will
  redo and re-emit) and continues appending at ``next_seq`` — the
  resumed trace has no gaps and no duplicate sequence numbers.

Readers (:func:`read_trace`) tolerate a truncated FINAL line — the
normal state of a trace that is being written right now (the live report
renders from exactly such files) or that lost its tail in a crash.
Garbage anywhere else is real corruption and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import numpy as np


class TraceError(RuntimeError):
    """A structurally corrupt trace (mid-file garbage, seq regression,
    or a resume cursor pointing past the end of the file)."""


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One decision/charge/measurement event.  ``payload`` is the
    kind-specific dict; ``ts`` is wall-clock metadata that replay and
    diff ignore."""

    seq: int
    campaign: str
    kind: str
    ts: float
    payload: Dict

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), allow_nan=False,
                          default=_np_default)

    @classmethod
    def from_dict(cls, d: Dict) -> "TraceEvent":
        return cls(seq=int(d["seq"]), campaign=str(d["campaign"]),
                   kind=str(d["kind"]), ts=float(d["ts"]),
                   payload=dict(d["payload"]))


def _np_default(o):
    """json fallback: numpy scalars/arrays emitted by decision sites."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"trace payload value {o!r} is not JSON-serializable")


class TraceStore:
    """Append-only JSONL event writer for one campaign.

    ``TraceStore(path, campaign=...)`` starts a FRESH trace (truncating
    any existing file — a new campaign is a new trail);
    :meth:`TraceStore.resume` reopens a preempted campaign's trace at
    its checkpointed cursor.  ``emit`` is thread-safe: the async sweep,
    fit-engine, and annotation workers all emit through the campaign's
    one store and sequence numbers stay monotone.
    """

    def __init__(self, path: str, campaign: str = "campaign", *,
                 flush_every: int = 256, _next_seq: int = 0,
                 _append: bool = False):
        self.path = str(path)
        self.campaign = str(campaign)
        self.flush_every = max(int(flush_every), 1)
        self._seq = int(_next_seq)
        self._buf: List[str] = []
        self._lock = threading.Lock()
        self._f = open(self.path, "a" if _append else "w")
        # -- torn-write tolerance -------------------------------------------
        # byte offset of the last DURABLE event boundary: a flush that
        # dies mid-write (OSError) may leave a torn tail past it; the
        # next flush truncates back to this offset and rewrites the kept
        # buffer, so the file never carries duplicate or gapped seqs
        self._end_pos = os.path.getsize(self.path) if _append else 0
        self._torn: Optional[int] = None
        self.write_errors = 0          # flushes that hit an OSError
        self._faults = None            # chaos injector (attach_faults)

    def attach_faults(self, faults) -> None:
        """Wire the chaos seam: every buffer flush ticks the
        ``trace.flush`` fault site (an injected fault emulates a torn
        write: half the payload reaches the file, then OSError)."""
        self._faults = faults

    # -- writing -----------------------------------------------------------
    @property
    def next_seq(self) -> int:
        """The sequence number the NEXT event will carry — the trace
        cursor campaign checkpoints embed (flush first: a persisted
        cursor must point inside the file, not inside the buffer)."""
        with self._lock:
            return self._seq

    def emit(self, kind: str, **payload) -> None:
        """Append one event (buffered; flushed every ``flush_every``
        events).  Payload values must be JSON-finite."""
        with self._lock:
            e = TraceEvent(seq=self._seq, campaign=self.campaign,
                           kind=kind, ts=time.time(), payload=payload)
            self._buf.append(e.to_json())
            self._seq += 1
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        """One buffer flush, torn-write tolerant: an OSError mid-write
        (a full disk, a flaky volume, an injected fault) KEEPS the
        buffer and remembers the last durable byte offset; the next
        flush truncates the torn tail and rewrites the whole kept buffer
        — readers never see duplicate or gapped sequence numbers, only
        (at worst) one truncated final line, which ``read_trace``
        already tolerates.  Write faults are recorded in
        ``write_errors``; they are deliberately NOT raised into the
        emitting decision site (losing a campaign to its own audit log
        would invert the dependency)."""
        if self._f.closed:
            return
        try:
            if self._torn is not None:
                # the torn write left the position past the durable
                # boundary: rewind (append-mode writes re-seek to EOF,
                # which the truncate puts exactly at the boundary)
                self._f.seek(self._torn)
                self._f.truncate(self._torn)
                self._torn = None
            if self._buf:
                payload = "\n".join(self._buf) + "\n"
                if self._faults is not None and \
                        self._faults.tick("trace.flush",
                                          emit=False) is not None:
                    # emulate the torn write (emit=False: we hold the
                    # store lock — a fault_injected emit would deadlock)
                    self._f.write(payload[:max(len(payload) // 2, 1)])
                    self._f.flush()
                    raise OSError("injected trace-write fault")
                self._f.write(payload)
                self._f.flush()
                # ensure_ascii JSON + "\n" joins: byte length == length
                self._end_pos += len(payload)
                self._buf.clear()
            else:
                self._f.flush()
        except OSError:
            self.write_errors += 1
            self._torn = self._end_pos

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._buf or self._torn is not None:
                # one recovery attempt for a store that went down dirty
                self._flush_locked()
            if self._buf or self._torn is not None:
                warnings.warn(
                    f"trace {self.path}: closed with {len(self._buf)} "
                    f"unflushed events after {self.write_errors} write "
                    f"errors — the tail of this trace is lost",
                    RuntimeWarning, stacklevel=2)
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "TraceStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resume ------------------------------------------------------------
    @classmethod
    def resume(cls, path: str, next_seq: int, *,
               campaign: Optional[str] = None,
               flush_every: int = 256) -> "TraceStore":
        """Reopen a preempted campaign's trace at its checkpointed
        cursor: keep events with ``seq < next_seq`` (the prefix the state
        checkpoint was cut against), truncate anything written after the
        cut (work the resumed campaign redoes and re-emits), and continue
        appending at ``next_seq`` — no gaps, no duplicate sequence
        numbers.  The campaign id is recovered from the kept prefix
        unless overridden."""
        next_seq = int(next_seq)
        keep_bytes, last_seq, seen_campaign = 0, -1, campaign
        with open(path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    keep_bytes += len(raw)
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    break   # truncated tail from the crash: drop it
                if int(d["seq"]) >= next_seq:
                    break
                last_seq = int(d["seq"])
                if seen_campaign is None:
                    seen_campaign = str(d["campaign"])
                keep_bytes += len(raw)
        if last_seq != next_seq - 1:
            raise TraceError(
                f"trace {path} ends at seq {last_seq} but the checkpoint "
                f"cursor expects events through seq {next_seq - 1} — the "
                f"trace was not flushed before the state file was written")
        with open(path, "r+b") as f:
            f.truncate(keep_bytes)
        return cls(path, campaign=seen_campaign or "campaign",
                   flush_every=flush_every, _next_seq=next_seq,
                   _append=True)


def sanitize(obj):
    """Deep-copy ``obj`` with non-finite floats replaced by ``None`` —
    the strict-JSON escape hatch for emitters whose numeric fields may
    legitimately be +/-inf (unfitted power laws, infeasible searches).
    Also normalizes numpy scalars so sanitized payloads compare equal
    across live and replayed streams."""
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        return f if np.isfinite(f) else None
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return sanitize(obj.tolist())
    return obj


def read_trace(path: str, *, campaign: Optional[str] = None
               ) -> List[TraceEvent]:
    """Read a trace file into events.  A truncated FINAL line (the file
    is mid-write, or a crash cut the tail) is tolerated and dropped;
    garbage anywhere else raises :class:`TraceError`.  ``campaign``
    filters to one campaign id (traces are single-campaign today, but a
    reader should not have to assume that)."""
    events: List[TraceEvent] = []
    with open(path) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            if any(l.strip() for l in lines[i + 1:]):
                raise TraceError(
                    f"{path}:{i + 1}: corrupt mid-file event line")
            break   # truncated final line: the mid-write tail
        events.append(TraceEvent.from_dict(d))
    if campaign is not None:
        events = [e for e in events if e.campaign == campaign]
    return events


def iter_trace(path: str) -> Iterator[TraceEvent]:
    """Iterator form of :func:`read_trace` (same tolerance rules)."""
    yield from read_trace(path)
