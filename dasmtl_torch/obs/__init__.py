"""dasmtl_torch.obs — the port's telemetry layer (``dasmtl/obs/``).

- :mod:`dasmtl_torch.obs.registry` — thread-safe metrics registry
  (counters, gauges, histograms with explicit buckets) rendered in
  Prometheus text exposition format, and its parser; ``GET /metrics`` on
  the serve and stream front ends is a view of it, ``/stats`` the JSON
  view of the same numbers.
- :mod:`dasmtl_torch.obs.trace` — request tracing: a trace ID minted at
  submit (or adopted from ``X-Dasmtl-Trace``) and threaded through batch
  formation -> dispatch -> collect -> resolve, span records in a bounded
  ring dumped as JSONL (``GET /trace``).
- :mod:`dasmtl_torch.obs.heartbeat` — the train heartbeat.
- :mod:`dasmtl_torch.obs.profiler` — on-demand and SLO-triggered
  ``torch.profiler`` capture (``POST /profile``, SIGUSR2, or a serve p99
  breach), rate-limited.
- :mod:`dasmtl_torch.obs.history` — a bounded time-series ring over
  scrape snapshots, served as ``GET /query?family=&since=``.

The JAX package's catalog (``docs/OBSERVABILITY.md``) holds for the port
with two differences: a capture is a Chrome trace (``trace.json``), not
an xplane; and ``dasmtl_serve_warmup_compiles_total`` and
``dasmtl_serve_post_warmup_recompiles_total`` count a pool member's CUDA
graph captures, not XLA compilations.
"""

from dasmtl_torch.obs.alerts import (AlertEngine, AlertRule, HeartbeatWatch,
                                     JsonlSink, StderrSink, WebhookSink,
                                     default_heartbeat_rules)
from dasmtl_torch.obs.history import (HistorySampler, MetricsHistory,
                                      handle_query)
from dasmtl_torch.obs.registry import (MetricsRegistry, default_registry,
                                       parse_exposition, render_prometheus)
from dasmtl_torch.obs.trace import (ALL_SPAN_STAGES, ROUTER_SPAN_STAGES,
                                    SPAN_STAGES, TraceRing, join_chains,
                                    mint_trace_id)

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "parse_exposition",
    "render_prometheus",
    "TraceRing",
    "SPAN_STAGES",
    "ROUTER_SPAN_STAGES",
    "ALL_SPAN_STAGES",
    "join_chains",
    "mint_trace_id",
    "AlertEngine",
    "AlertRule",
    "HeartbeatWatch",
    "JsonlSink",
    "StderrSink",
    "WebhookSink",
    "default_heartbeat_rules",
    "MetricsHistory",
    "HistorySampler",
    "handle_query",
]
