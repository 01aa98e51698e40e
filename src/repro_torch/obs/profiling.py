# Opt-in deep-dive profiling: bracket one chosen campaign iteration
# with torch.profiler.  Everything here degrades to a no-op when the
# profiler is unavailable — an opt-in dump must never kill a campaign
# that already spent real annotation budget.
"""``--profile DIR`` support: one iteration under ``torch.profiler``
(``repro.obs.profiling``, the port's own copy).

The metrics registry answers "where did the time go" at span
granularity; this answers "why" at kernel granularity, for exactly one
iteration (profiles are huge — bracketing the whole campaign would
drown the trace viewer and the disk).  Usage::

    with profile_block("prof_dir", enabled=(it == args.profile_iter)):
        camp.iteration()

The block records host activity and, where a CUDA device is available,
the device's kernels, then writes one Chrome trace to
``DIR/trace.<pid>.json``; view it with perfetto or chrome://tracing.
"""
from __future__ import annotations

import os
import sys
from contextlib import contextmanager

__all__ = ["profile_block", "trace_path"]


def trace_path(outdir: str) -> str:
    """Where :func:`profile_block` writes this process's Chrome trace."""
    return os.path.join(outdir, f"trace.{os.getpid()}.json")


@contextmanager
def profile_block(outdir: str, enabled: bool = True):
    if not enabled or not outdir:
        yield False
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(outdir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # profiler backend missing / refused to start
        print(f"# profile: torch.profiler unavailable ({type(e).__name__}: "
              f"{e}) — continuing without", file=sys.stderr)
        yield False
        return
    try:
        yield True
    finally:
        # a broken profiler teardown must not lose the iteration's work
        # (and must never mask an exception from the profiled body)
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace_path(outdir))
        except Exception as e:
            print(f"# profile: trace teardown failed "
                  f"({type(e).__name__}: {e})", file=sys.stderr)
