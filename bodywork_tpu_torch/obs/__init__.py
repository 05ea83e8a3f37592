"""Observability for the port (the port of ``bodywork_tpu.obs``):

- :mod:`~bodywork_tpu_torch.obs.registry` — a dependency-free metrics
  registry with the JAX package's metric names and Prometheus text
  exposition;
- :mod:`~bodywork_tpu_torch.obs.spans` — stage spans for the pipeline
  runner: per-day JSON run reports and Chrome trace-event files;
- :mod:`~bodywork_tpu_torch.obs.tracing` — request-scoped tracing through
  the serving hot path: W3C-compatible trace ids with deterministic head
  sampling, the flight recorder and its store documents, and the latency
  histogram's exemplars.

The multi-process snapshot files (``obs/multiproc.py``) are a later
slice. Everything here is stdlib-only.
"""
from bodywork_tpu_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    METRIC_NAME_RE,
    UNIT_SUFFIXES,
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    merge_snapshots,
    render_snapshot,
    validate_metric_name,
)
from bodywork_tpu_torch.obs.spans import (
    Span,
    SpanRecorder,
    chrome_trace,
    day_report,
    write_chrome_trace,
    write_day_report,
)
from bodywork_tpu_torch.obs.tracing import (
    TRACE_ID_HEADER,
    FlightRecorder,
    RequestTrace,
    Tracer,
    configure_tracing,
    configured_tracing,
    get_tracer,
)

__all__ = [
    "TRACE_ID_HEADER",
    "FlightRecorder",
    "RequestTrace",
    "Tracer",
    "configure_tracing",
    "configured_tracing",
    "get_tracer",
    "DEFAULT_LATENCY_BUCKETS",
    "METRIC_NAME_RE",
    "UNIT_SUFFIXES",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "SpanRecorder",
    "chrome_trace",
    "day_report",
    "get_registry",
    "merge_snapshots",
    "render_snapshot",
    "validate_metric_name",
    "write_chrome_trace",
    "write_day_report",
]
