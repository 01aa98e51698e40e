"""repro_torch.obs — runtime metrics & profiling (the telemetry half of
observability; ``repro_torch.trace`` owns the replayable decision stream) plus
the health layer that judges both (``obs.health`` / ``obs.slo``)."""
from repro_torch.obs.export import (cache_hit_rates, prometheus_lines,
                              queue_stats, snapshot_counter, span_rollup,
                              write_prometheus)
from repro_torch.obs.health import (ALERT_KINDS, HealthConfig, HealthEngine,
                              alert_sequence, hist_quantile)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, MetricsRegistry, Span,
                               get_registry, log_buckets, set_registry)
from repro_torch.obs.profiling import profile_block
from repro_torch.obs.slo import SLO_CLAUSES, SLOSpec, evaluate_slo

__all__ = [
    "DEFAULT_BUCKETS", "MetricsRegistry", "Span", "log_buckets",
    "get_registry", "set_registry", "profile_block",
    "write_prometheus", "prometheus_lines", "span_rollup",
    "cache_hit_rates", "queue_stats", "snapshot_counter",
    "ALERT_KINDS", "HealthConfig", "HealthEngine", "alert_sequence",
    "hist_quantile", "SLO_CLAUSES", "SLOSpec", "evaluate_slo",
]
