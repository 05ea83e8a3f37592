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

Work below the stages records into the recorder a caller installs with
:func:`recording`, and only then: an MLP fit's phases
(:mod:`bodywork_tpu_torch.models.mlp`) look it up with
:func:`current_recorder` once a fit. Nothing installs one by default, so
the day's documents hold the stages alone; the recorder lives in a
``contextvars.ContextVar``, which a ``threading.Thread`` does not inherit.
Such a span names the span that caused it (``parent``), and the spans of
one unit of work share an id in their meta (:meth:`SpanRecorder.next_id`).

Stdlib-only, like the rest of :mod:`bodywork_tpu_torch.obs`.
"""
from __future__ import annotations

import contextvars
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
    "current_recorder",
    "day_report",
    "recording",
    "write_chrome_trace",
    "write_day_report",
]

#: span categories with defined meanings (free-form ones are allowed too)
CATEGORY_STAGE = "stage"      # a DAG stage at its DAG position
CATEGORY_OVERLAP = "overlap"  # background work overlapping the DAG (lookahead)
CATEGORY_PREFETCH = "prefetch"  # dataset prefetch worker
CATEGORY_DAY = "day"          # the whole run_day envelope
CATEGORY_FIT = "fit"          # a model fit's phases (recorded under ``recording``)


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
    # the name of the span that caused this one (None: a root span), set
    # by ``SpanRecorder.add``; a plain attribute, not a dataclass field, so
    # the fields (``dataclasses.asdict``) stay the JAX package's
    parent = None

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
        if self.parent is not None:
            d["parent"] = self.parent
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
        self._ids = 0

    def now(self) -> float:
        """Seconds since the recorder's epoch."""
        return time.perf_counter() - self._t0

    def add(
        self,
        name: str,
        category: str,
        start_s: float,
        duration_s: float,
        *,
        parent: str | None = None,
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
        span.parent = parent
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

    def next_id(self) -> int:
        """The next of this recorder's sequence numbers (1, 2, ...): the id
        the spans of one unit of work share."""
        with self._lock:
            self._ids += 1
            return self._ids

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


_CURRENT: contextvars.ContextVar[SpanRecorder | None] = contextvars.ContextVar(
    "bodywork_tpu_torch_span_recorder", default=None)


@contextmanager
def recording(recorder: SpanRecorder):
    """Install ``recorder`` as :func:`current_recorder` in this context
    (this thread, or this task) for the block's duration."""
    token = _CURRENT.set(recorder)
    try:
        yield recorder
    finally:
        _CURRENT.reset(token)


def current_recorder() -> SpanRecorder | None:
    """The recorder :func:`recording` installed here, or None."""
    return _CURRENT.get()


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
                **_args(span),
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


def _args(span: Span) -> dict:
    """A trace event's ``args``: the span's meta, and its parent where it
    has one (none at all for a root span without meta)."""
    args = dict(span.meta)
    if span.parent is not None:
        args["parent"] = span.parent
    return {"args": args} if args else {}


def write_chrome_trace(
    path: str | Path, spans: list[Span], process_name: str = "bodywork_tpu"
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(spans, process_name)) + "\n")
    return path
