"""Trace collector: observed serving behaviour -> one observation table
(the port of ``bodywork_tpu.tune.collect``, its tables, sources, metric
names and texts).

The tuner's inputs already exist, scattered across three subsystems the
earlier PRs built: the obs registry records per-phase hot-path
histograms and flush accounting, the day-report spans carry per-stage
and per-op timings, and the traffic harness's JSONL logs are a full
seeded record of what was offered (arrival times, per-request row
shapes) and what came back (status, latency, send lag). This module
normalises all of them into one :class:`ObservationTable` — the only
shape the cost model (``tune/model.py``) reads — so a fit is a pure
function of the table regardless of which sources fed it.

Sources (each ingestor is additive; call any subset):

- :func:`ingest_request_log` — a ``traffic run`` request log (the
  SCHEDULE: scheduled arrival times + per-request row counts). Yields
  the offered arrival process (inter-arrival samples) and the offered
  row-shape distribution.
- :func:`ingest_results_log` — a ``traffic run --results-out`` log (the
  OUTCOME: status, latency from scheduled arrival, send lag, rows).
  Yields observed goodput — the measured service rate when the drive
  was saturated — and completes the row-shape picture for replayed logs.
- :func:`ingest_obs_snapshot` — an obs registry snapshot (the dict
  ``Registry.snapshot()`` returns, or a JSON file of it, e.g. a
  multiproc worker snapshot): coalescer flush occupancy + flush
  reasons, device-dispatch and scoring-latency histogram moments,
  per-op store costs.
- :func:`ingest_day_report` — a ``run-day --report-out`` document:
  span durations per stage/category (the cold-path costs: snapshot
  refresh cadence inputs, per-op store spans).
- :func:`probe_dispatch_costs` — the one ACTIVE source: time the
  serving checkpoint's padded dispatch at each candidate bucket
  (median of ``reps`` calls, first call untimed). This is the measured
  per-bucket cost curve the bucket-ladder and window decisions need —
  the "learned from measured executions" half of the hybrid, à la the
  TPU learned-cost-model paper (PAPERS.md).

Everything here is numpy + stdlib; torch is only touched inside
:func:`probe_dispatch_costs`, which times the port's ``PaddedPredictor``
(the ``torch`` engine: one CUDA graph of cuBLAS products a bucket) on
the card unless asked for the CPU, as the JAX probe times its ``xla``
engine. ``auto`` serves the 1024-wide MLP through the fused kernel, so
the probe prices the plain engine, not the one serving (a recorded
deviation of both packages, ROADMAP "Not faults").
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tune.collect")

__all__ = [
    "IngestCursor",
    "ObservationTable",
    "ingest_day_report",
    "ingest_obs_snapshot",
    "ingest_request_log",
    "ingest_request_log_incremental",
    "ingest_results_log",
    "ingest_results_log_incremental",
    "probe_dispatch_costs",
]


@dataclasses.dataclass
class ObservationTable:
    """Everything the cost model may condition on, normalised. Empty
    fields mean "never observed" — each knob's model degrades to the
    hand-set default when its evidence is missing (and says so in the
    decision trace)."""

    #: seconds between consecutive scheduled arrivals (request logs)
    interarrival_s: list = dataclasses.field(default_factory=list)
    #: per-request row counts (request/results logs)
    row_counts: list = dataclasses.field(default_factory=list)
    #: bucket -> measured seconds per padded dispatch (the probe)
    dispatch_cost_s: dict = dataclasses.field(default_factory=dict)
    #: coalescer flush occupancy (rows flushed / max_rows): histogram
    #: moments from the obs snapshot
    occupancy_sum: float = 0.0
    occupancy_count: int = 0
    #: flush-reason counts (window | max_rows | saturation)
    flush_reasons: dict = dataclasses.field(default_factory=dict)
    #: device-dispatch histogram moments (obs snapshot)
    dispatch_sum_s: float = 0.0
    dispatch_count: int = 0
    #: scoring-latency histogram moments (obs snapshot)
    scoring_sum_s: float = 0.0
    scoring_count: int = 0
    #: admission queue-delay EWMA samples (obs snapshot / healthz docs)
    queue_delay_s: list = dataclasses.field(default_factory=list)
    #: OK responses per second observed by a results log whose offered
    #: rate exceeded it — the measured service rate under saturation
    saturated_goodput_rps: float | None = None
    #: results-log latency samples (from scheduled arrival), seconds
    latency_s: list = dataclasses.field(default_factory=list)
    #: per-op store costs: op -> mean seconds (obs snapshot / day report)
    store_op_cost_s: dict = dataclasses.field(default_factory=dict)
    #: day-report span seconds by span name (cold-path cadence evidence)
    span_seconds: dict = dataclasses.field(default_factory=dict)
    #: where each piece of evidence came from (the fit's audit trail)
    sources: list = dataclasses.field(default_factory=list)

    # -- derived views the cost model reads ---------------------------------
    def arrival_rate_rps(self) -> float | None:
        """Mean offered arrival rate from the inter-arrival samples."""
        if not self.interarrival_s:
            return None
        mean = float(np.mean(self.interarrival_s))
        return 1.0 / mean if mean > 0 else None

    def row_quantiles(self) -> dict | None:
        """The offered row-shape distribution, summarised."""
        if not self.row_counts:
            return None
        rows = np.asarray(self.row_counts)
        return {
            "p50": int(np.percentile(rows, 50)),
            "p90": int(np.percentile(rows, 90)),
            "p99": int(np.percentile(rows, 99)),
            "max": int(rows.max()),
            "n": int(rows.size),
        }

    def mean_occupancy(self) -> float | None:
        if self.occupancy_count == 0:
            return None
        return self.occupancy_sum / self.occupancy_count

    def mean_dispatch_s(self) -> float | None:
        if self.dispatch_count == 0:
            return None
        return self.dispatch_sum_s / self.dispatch_count

    def service_rate_rps(self) -> float | None:
        """The measured single-service rate: a saturated drive's
        goodput when one was observed (the direct measurement), else
        the inverse mean scoring latency (the closed-loop proxy)."""
        if self.saturated_goodput_rps is not None:
            return self.saturated_goodput_rps
        if self.scoring_count and self.scoring_sum_s > 0:
            return self.scoring_count / self.scoring_sum_s
        return None

    def summary(self) -> dict:
        """The in-document observation summary (what the tuned config
        records as its evidence — replaying the same table reproduces
        the same fit, byte-identically)."""
        rate = self.arrival_rate_rps()
        service = self.service_rate_rps()
        return {
            "arrival_rate_rps": round(rate, 3) if rate else None,
            "interarrival_samples": len(self.interarrival_s),
            "row_shape": self.row_quantiles(),
            "dispatch_cost_s": {
                str(b): round(c, 6)
                for b, c in sorted(self.dispatch_cost_s.items())
            } or None,
            "mean_flush_occupancy": (
                round(self.mean_occupancy(), 4)
                if self.mean_occupancy() is not None else None
            ),
            "flush_reasons": dict(self.flush_reasons) or None,
            "service_rate_rps": round(service, 3) if service else None,
            "queue_delay_samples": len(self.queue_delay_s),
            "store_op_cost_s": {
                k: round(v, 6)
                for k, v in sorted(self.store_op_cost_s.items())
            } or None,
            # day-report span evidence rides the record even though no
            # CURRENT knob model conditions on it: the cold-path knobs
            # (compaction cadence, get_many concurrency) will, and a tune's evidence must be auditable from its
            # document alone either way
            "span_seconds": {
                k: round(v, 6)
                for k, v in sorted(
                    self.span_seconds.items(), key=lambda kv: -kv[1]
                )[:12]
            } or None,
            "sources": list(self.sources),
        }


def _request_rows(entry: dict) -> int:
    """Rows one logged request carries: the explicit ``rows`` field
    (written since this PR) or the payload length for older logs."""
    rows = entry.get("rows")
    if isinstance(rows, int) and rows >= 1:
        return rows
    x = entry.get("x")
    if isinstance(x, list) and x:
        return len(x) if entry.get("route", "").endswith("/batch") else 1
    return 1


def ingest_request_log(table: ObservationTable, path: str | Path) -> int:
    """Fold one ``traffic run`` request log (JSONL, schema
    ``bodywork_tpu.request_log/1``) into the table: scheduled
    inter-arrival gaps + per-request row counts. Returns the number of
    requests ingested."""
    path = Path(path)
    with path.open() as f:
        header = json.loads(f.readline())
        if header.get("schema") != "bodywork_tpu.request_log/1":
            raise ValueError(
                f"{path}: not a request log "
                f"(schema {header.get('schema')!r})"
            )
        prev_t = None
        n = 0
        for line in f:
            if not line.strip():
                continue
            entry = json.loads(line)
            t = float(entry["t_s"])
            if prev_t is not None and t >= prev_t:
                table.interarrival_s.append(t - prev_t)
            prev_t = t
            table.row_counts.append(_request_rows(entry))
            n += 1
    table.sources.append(f"request_log:{path.name}")
    return n


def ingest_results_log(table: ObservationTable, path: str | Path) -> int:
    """Fold one ``traffic run --results-out`` log into the table:
    per-request outcome (latency, status, rows, scheduled-vs-actual
    send). When the drive was SATURATED (offered clearly exceeded
    goodput), the OK rate is the measured service rate — the admission
    budget's denominator."""
    path = Path(path)
    ok = 0
    shed = 0
    n = 0
    last_t = 0.0
    prev_t = None
    with path.open() as f:
        for line in f:
            if not line.strip():
                continue
            entry = json.loads(line)
            t = float(entry["t_s"])
            n += 1
            last_t = max(last_t, t)
            if prev_t is not None and t >= prev_t:
                table.interarrival_s.append(t - prev_t)
            prev_t = t
            if "rows" in entry:
                table.row_counts.append(_request_rows(entry))
            status = entry.get("status")
            if status == 200:
                ok += 1
                if entry.get("latency_s") is not None:
                    table.latency_s.append(float(entry["latency_s"]))
            elif status == 429:
                shed += 1
            if entry.get("retry_after_s") is not None:
                table.queue_delay_s.append(float(entry["retry_after_s"]))
    if n == 0:
        raise ValueError(f"{path}: empty results log")
    span = max(last_t, 1e-6)
    offered = n / span
    goodput = ok / span
    # saturated when the server visibly shed (sheds ARE the at-budget
    # signal — a 2% shed fraction never happens off saturation) or the
    # offered rate clearly outran the answered rate: the OK rate then
    # IS the measured service rate for this traffic shape
    if ok and (shed / n > 0.02 or offered > 1.3 * goodput):
        table.saturated_goodput_rps = max(
            table.saturated_goodput_rps or 0.0, goodput
        )
    table.sources.append(f"results_log:{path.name}")
    return n


# -- incremental ingestion (the online controller's O(new entries) path) ---


@dataclasses.dataclass
class IngestCursor:
    """Byte-offset resume state for ONE growing log file.

    The offline ``cli tune`` flow reads each file once, so the whole-
    file ingestors above are fine there — but the online controller
    (``tune/online.py``) re-ingests its watch files EVERY poll, and a
    whole-file re-read per poll makes a long-lived controller O(file)
    instead of O(new entries). The cursor carries everything a resumed
    parse needs: the byte offset of the first unconsumed line, the last
    scheduled arrival (inter-arrival gaps must bridge poll boundaries),
    and the running outcome counts the results-log saturation heuristic
    is defined over (it is a whole-drive rate, not a tail rate).

    Only COMPLETE lines are ever consumed — a partially-written tail
    line (the live writer mid-append) stays un-offset for the next
    poll, so a torn JSON line can never poison the table."""

    offset: int = 0
    last_t: float | None = None
    entries: int = 0
    ok: int = 0
    shed: int = 0
    span_t: float = 0.0


def _count_ingest(kind: str, entries: int, n_bytes: int) -> None:
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "bodywork_tpu_tune_ingest_entries_total",
        "Log entries folded into tuning observation tables by the "
        "incremental ingestors, by log kind",
    ).inc(entries, kind=kind)
    reg.counter(
        "bodywork_tpu_tune_ingest_bytes_total",
        "Bytes consumed by the incremental tuning-log ingestors, by "
        "log kind — per-poll deltas prove the controller stays "
        "O(new entries), not O(file)",
    ).inc(n_bytes, kind=kind)


def _new_complete_lines(path: Path, offset: int):
    """``(lines, new_offset, bytes_consumed)`` for every complete line
    appended since ``offset``."""
    with path.open("rb") as f:
        f.seek(offset)
        chunk = f.read()
    end = chunk.rfind(b"\n")
    if end < 0:
        return [], offset, 0
    consumed = end + 1
    return (
        chunk[:consumed].decode("utf-8").splitlines(),
        offset + consumed,
        consumed,
    )


def ingest_request_log_incremental(
    table: ObservationTable, path: str | Path,
    cursor: IngestCursor | None = None,
) -> IngestCursor:
    """Fold every request-log entry appended since ``cursor`` into the
    table and return the advanced cursor (a fresh one reads from the
    top, validating the header exactly like :func:`ingest_request_log`).
    Entry semantics are identical to the whole-file ingestor; only the
    I/O pattern differs."""
    path = Path(path)
    cursor = cursor or IngestCursor()
    lines, new_offset, n_bytes = _new_complete_lines(path, cursor.offset)
    start = 0
    if cursor.offset == 0 and lines:
        header = json.loads(lines[0])
        if header.get("schema") != "bodywork_tpu.request_log/1":
            raise ValueError(
                f"{path}: not a request log "
                f"(schema {header.get('schema')!r})"
            )
        start = 1
    n = 0
    for line in lines[start:]:
        if not line.strip():
            continue
        entry = json.loads(line)
        t = float(entry["t_s"])
        if cursor.last_t is not None and t >= cursor.last_t:
            table.interarrival_s.append(t - cursor.last_t)
        cursor.last_t = t
        table.row_counts.append(_request_rows(entry))
        n += 1
    cursor.offset = new_offset
    cursor.entries += n
    if n:
        table.sources.append(f"request_log:{path.name}[+{n}]")
    _count_ingest("request_log", n, n_bytes)
    return cursor


def ingest_results_log_incremental(
    table: ObservationTable, path: str | Path,
    cursor: IngestCursor | None = None,
) -> IngestCursor:
    """Incremental sibling of :func:`ingest_results_log`. The
    saturation heuristic runs over the cursor's RUNNING totals (ok /
    shed / span) — saturation is a whole-drive property, and judging it
    from one poll's tail alone would flap."""
    path = Path(path)
    cursor = cursor or IngestCursor()
    lines, new_offset, n_bytes = _new_complete_lines(path, cursor.offset)
    n = 0
    for line in lines:
        if not line.strip():
            continue
        entry = json.loads(line)
        t = float(entry["t_s"])
        cursor.span_t = max(cursor.span_t, t)
        if cursor.last_t is not None and t >= cursor.last_t:
            table.interarrival_s.append(t - cursor.last_t)
        cursor.last_t = t
        if "rows" in entry:
            table.row_counts.append(_request_rows(entry))
        status = entry.get("status")
        if status == 200:
            cursor.ok += 1
            if entry.get("latency_s") is not None:
                table.latency_s.append(float(entry["latency_s"]))
        elif status == 429:
            cursor.shed += 1
        if entry.get("retry_after_s") is not None:
            table.queue_delay_s.append(float(entry["retry_after_s"]))
        n += 1
    cursor.offset = new_offset
    cursor.entries += n
    if cursor.entries and cursor.ok:
        span = max(cursor.span_t, 1e-6)
        offered = cursor.entries / span
        goodput = cursor.ok / span
        if cursor.shed / cursor.entries > 0.02 or offered > 1.3 * goodput:
            table.saturated_goodput_rps = max(
                table.saturated_goodput_rps or 0.0, goodput
            )
    if n:
        table.sources.append(f"results_log:{path.name}[+{n}]")
    _count_ingest("results_log", n, n_bytes)
    return cursor


def _histogram_moments(entry: dict) -> tuple[float, int]:
    total = 0.0
    count = 0
    for sample in entry.get("samples", []):
        total += float(sample.get("sum", 0.0))
        count += int(sample.get("count", 0))
    return total, count


def ingest_obs_snapshot(table: ObservationTable,
                        snapshot: dict | str | Path) -> None:
    """Fold one obs registry snapshot (``Registry.snapshot()`` dict, or
    a JSON file holding one — e.g. a multiproc worker's flushed
    snapshot) into the table: coalescer occupancy + flush reasons,
    dispatch/scoring histogram moments, per-op store costs."""
    label = "obs_snapshot:dict"
    if not isinstance(snapshot, dict):
        path = Path(snapshot)
        snapshot = json.loads(path.read_text())
        label = f"obs_snapshot:{path.name}"
        if not isinstance(snapshot, dict):
            raise ValueError(f"{path}: not a registry snapshot document")
    occ = snapshot.get("bodywork_tpu_serve_batch_occupancy_ratio")
    if occ:
        s, c = _histogram_moments(occ)
        table.occupancy_sum += s
        table.occupancy_count += c
    flush = snapshot.get("bodywork_tpu_serve_batch_flush_total")
    if flush:
        for sample in flush.get("samples", []):
            reason = sample.get("labels", {}).get("reason", "unknown")
            table.flush_reasons[reason] = (
                table.flush_reasons.get(reason, 0)
                + int(sample.get("value", 0))
            )
    dispatch = snapshot.get("bodywork_tpu_device_dispatch_seconds")
    if dispatch:
        s, c = _histogram_moments(dispatch)
        table.dispatch_sum_s += s
        table.dispatch_count += c
    scoring = snapshot.get("bodywork_tpu_scoring_latency_seconds")
    if scoring:
        s, c = _histogram_moments(scoring)
        table.scoring_sum_s += s
        table.scoring_count += c
    ops = snapshot.get("bodywork_tpu_store_op_seconds")
    if ops:
        for sample in ops.get("samples", []):
            op = sample.get("labels", {}).get("op", "unknown")
            count = int(sample.get("count", 0))
            if count:
                table.store_op_cost_s[op] = (
                    float(sample.get("sum", 0.0)) / count
                )
    table.sources.append(label)


def ingest_day_report(table: ObservationTable, path: str | Path) -> None:
    """Fold one ``run-day`` report (``bodywork_tpu.day_report/1``) into
    the table: span seconds by name — the cold-path timings (snapshot
    refresh, stage walls) a compaction-cadence or prefetch tuner
    conditions on."""
    path = Path(path)
    doc = json.loads(path.read_text())
    if doc.get("schema") != "bodywork_tpu.day_report/1":
        raise ValueError(
            f"{path}: not a day report (schema {doc.get('schema')!r})"
        )
    for span in doc.get("spans", []):
        name = span.get("name", "unknown")
        table.span_seconds[name] = (
            table.span_seconds.get(name, 0.0)
            + float(span.get("duration_s", 0.0))
        )
    table.sources.append(f"day_report:{path.name}")


def probe_dispatch_costs(
    store,
    buckets: tuple[int, ...],
    reps: int = 5,
    n_features: int | None = None,
    device=None,
) -> dict:
    """Measure the serving checkpoint's padded-dispatch cost at each
    bucket (median of ``reps`` timed calls after one untimed warm
    call): ``{bucket: seconds_per_dispatch}``. This is the cost curve
    the bucket-ladder and window models condition on — measured on the
    ACTUAL model the store would serve, through the same
    ``PaddedPredictor`` dispatch path serving uses, on ``device`` (the
    card unless asked for the CPU; without CUDA it raises). On the card
    the untimed warm call of a bucket is its CUDA-graph capture, and a
    timed call replays the graph and copies the answers back to the
    host (``predict`` returns numpy), as the JAX probe's host timer
    includes the copy back."""
    import time

    from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
    from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
    from bodywork_tpu_torch.serve.predictor import PaddedPredictor

    dev = resolve_device(device)
    served_key, _source = resolve_serving_key(store)
    model, _d = load_model(store, served_key, device=dev)
    require_ieee_f32_matmul(model.device)
    predictor = PaddedPredictor(model, tuple(sorted(set(buckets))))
    if n_features is None:
        n_features = getattr(model, "n_features", None) or 1
    costs: dict = {}
    for bucket in predictor.buckets:
        X = np.zeros((bucket, n_features), dtype=np.float32)
        predictor.predict(X)  # capture + first run, untimed
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            predictor.predict(X)
            samples.append(time.perf_counter() - t0)
        costs[int(bucket)] = float(np.median(samples))
    return costs
