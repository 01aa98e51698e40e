"""Campaign event bus + append-only trace store (``repro.trace``).

    TraceStore / TraceEvent / read_trace   append-only JSONL event log
    replay(path) -> ReplayedCampaign       full trajectory, zero recompute
    diff(a, b) -> TraceDiff | None         first-divergence analysis
    REPLAY_KINDS / OBSERVABILITY_KINDS     the emit-site contract
"""
from repro_torch.trace.replay import (ALL_KINDS, OBSERVABILITY_KINDS,  # noqa: F401
                                      REPLAY_KINDS, ReplayedCampaign,
                                      TraceDiff, diff, replay)
from repro_torch.trace.store import (TraceError, TraceEvent, TraceStore,  # noqa: F401
                                     iter_trace, read_trace, sanitize)
