"""Observability for the port (the port of the metrics half of
``bodywork_tpu.obs``): a dependency-free metrics registry with the JAX
package's metric names and Prometheus text exposition.

Request tracing, stage spans and the day report, and the multi-process
snapshot files (``obs/multiproc.py``) are later slices.
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

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "METRIC_NAME_RE",
    "UNIT_SUFFIXES",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "merge_snapshots",
    "render_snapshot",
    "validate_metric_name",
]
