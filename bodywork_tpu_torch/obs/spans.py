"""Stage spans: per-day run reports and Chrome trace events (the port
of ``bodywork_tpu.obs.spans``; the same documents).

The runner times its stages (``DayResult.stage_seconds``), but those
numbers die with the process, and the work that overlaps the day (the
lookahead train, the dataset prefetch, the snapshot refresh) shows in no
per-stage table. A :class:`SpanRecorder` collects named spans, the stages
and the background work, on one ``time.perf_counter`` timeline, and
renders them two ways:

- :func:`day_report`: a JSON run report per ``run_day`` (schema
  ``bodywork_tpu.day_report/1``: day, wall clock, seconds per stage,
  every span);
- :func:`chrome_trace`: a Chrome trace-event file (``ph: "X"`` complete
  events on one track per thread), which Perfetto and
  ``chrome://tracing`` load.

Stage spans are recorded from the same measurements as
``DayResult.stage_seconds`` (the runner passes its timings in), so trace
durations equal the per-day numbers exactly. Spans are host-clock
intervals: one around device work ends where the host waited for the
device (a stage returns after its results are on the host or in the
store), never at a kernel launch.

Stdlib-only, like the rest of :mod:`bodywork_tpu_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path

__all__ = [
    "Span",
    "SpanRecorder",
    "chrome_trace",
    "day_report",
    "write_chrome_trace",
    "write_day_report",
]

#: span categories with defined meanings (free-form ones are allowed too)
CATEGORY_STAGE = "stage"      # a DAG stage at its DAG position
CATEGORY_OVERLAP = "overlap"  # background work overlapping the DAG (lookahead)
CATEGORY_PREFETCH = "prefetch"  # dataset prefetch worker
CATEGORY_DAY = "day"          # the whole run_day envelope


@dataclasses.dataclass
class Span:
    """One named interval on the recorder's timeline (seconds since the
    recorder's epoch)."""

    name: str
    category: str
    start_s: float
    duration_s: float
    thread: str
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "category": self.category,
            "start_s": round(self.start_s, 6),
            "duration_s": round(self.duration_s, 6),
            "thread": self.thread,
        }
        if self.meta:
            d["meta"] = dict(self.meta)
        return d


class SpanRecorder:
    """Thread-safe append-only span log on one perf_counter timeline.

    One recorder per runner: background threads (prefetch, lookahead
    train) capture the recorder at span start, so their spans land on
    the same timeline as the stages they overlap. ``mark``/``since``
    let ``run_day`` slice out the spans recorded during its window."""

    def __init__(self, label: str = "run"):
        self.label = label
        self._t0 = time.perf_counter()
        #: wall-clock anchor for the perf_counter epoch (report metadata)
        self.epoch_unix_s = time.time()
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def now(self) -> float:
        """Seconds since the recorder's epoch."""
        return time.perf_counter() - self._t0

    def add(
        self,
        name: str,
        category: str,
        start_s: float,
        duration_s: float,
        **meta,
    ) -> Span:
        """Record an already-measured interval (the runner's stage path:
        the span duration IS ``stage_seconds[name]``, not a re-measure)."""
        span = Span(
            name=name,
            category=category,
            start_s=start_s,
            duration_s=duration_s,
            thread=threading.current_thread().name,
            meta=meta,
        )
        with self._lock:
            self._spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, category: str = CATEGORY_STAGE, **meta):
        """Measure-and-record context manager for background work."""
        start = self.now()
        try:
            yield
        finally:
            self.add(name, category, start, self.now() - start, **meta)

    def mark(self) -> int:
        """Position token for :meth:`since` (spans recorded so far)."""
        with self._lock:
            return len(self._spans)

    def since(self, mark: int) -> list[Span]:
        with self._lock:
            return list(self._spans[mark:])

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


def day_report(result, spans: list[Span] | None = None, fsck: dict | None = None,
               tenant: str | None = None) -> dict:
    """Structured JSON-able run report for one ``DayResult``. ``spans``
    defaults to ``result.spans`` (the runner attaches the day window's
    slice). ``fsck``, an integrity-scrub report (``audit.run_fsck``, what
    ``cli run-day --scrub`` produces), adds its findings block. ``tenant``
    names the tenant namespace the day ran in; the default (root)
    namespace omits the field. Schema (the JAX package's)::

        {"schema": "bodywork_tpu.day_report/1",
         "day": "YYYY-MM-DD", "wall_clock_s": float,
         "stage_seconds": {stage: float},
         "spans": [{name, category, start_s, duration_s, thread, meta?}],
         "fsck"?: {"clean", "ok", "keys_scanned", "by_severity",
                   "findings": [...]},
         "tenant"?: str}
    """
    spans = result.spans if spans is None else spans
    report = {
        "schema": "bodywork_tpu.day_report/1",
        "day": str(result.day),
        "wall_clock_s": round(result.wall_clock_s, 6),
        "stage_seconds": {
            name: round(secs, 6)
            for name, secs in result.stage_seconds.items()
        },
        "spans": [s.to_dict() for s in spans],
    }
    if tenant is not None and tenant != "default":
        report["tenant"] = tenant
    if fsck is not None:
        report["fsck"] = {
            "clean": fsck["clean"],
            "ok": fsck["ok"],
            "keys_scanned": fsck["keys_scanned"],
            "by_severity": fsck["by_severity"],
            "findings": fsck["findings"],
        }
    return report


def write_day_report(path: str | Path, report: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2) + "\n")
    return path


def chrome_trace(
    spans: list[Span], process_name: str = "bodywork_tpu"
) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` object form) from a
    span list: one complete (``ph: "X"``) event per span on a per-thread
    track, plus name metadata so Perfetto labels the tracks."""
    threads = {}
    events: list[dict] = []
    for span in spans:
        tid = threads.setdefault(span.thread, len(threads) + 1)
        events.append(
            {
                "name": span.name,
                "cat": span.category,
                "ph": "X",
                "ts": round(span.start_s * 1e6, 3),
                "dur": round(span.duration_s * 1e6, 3),
                "pid": 1,
                "tid": tid,
                **({"args": dict(span.meta)} if span.meta else {}),
            }
        )
    meta_events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": process_name},
        }
    ]
    for thread_name, tid in threads.items():
        meta_events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": thread_name},
            }
        )
    return {"traceEvents": meta_events + events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str | Path, spans: list[Span], process_name: str = "bodywork_tpu"
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(spans, process_name)) + "\n")
    return path
