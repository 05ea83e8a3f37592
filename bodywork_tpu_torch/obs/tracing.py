"""Request-scoped tracing through the serving hot path (the port of
``bodywork_tpu.obs.tracing``; the same ids, sampling decisions, span ids
and flight-record bytes, so each package's ``cli trace`` reads the
other's dumps).

- **W3C-compatible ids.** A request arriving with a ``traceparent``
  header (``00-<32 hex trace id>-<16 hex parent span id>-<flags>``)
  keeps its trace id; otherwise one is minted as a pure function of
  ``(sampling seed, request body bytes)``, so a seeded replay mints the
  same ids and two front ends serving the same request agree on the id.
  Identical payloads share a minted id (spans are per execution).
- **Deterministic head sampling.** Keep or drop is a pure function of
  ``(sampling seed, trace id)``: ``sha256(seed|trace_id)``'s top 64 bits
  against ``fraction`` of the 2^64 space.
- **Bounded hot-path cost.** An unsampled request pays the mint, the
  sampling hash and one branch, and allocates one small context object
  (:class:`RequestTrace` with ``spans=None``). The id leaves the service
  only in the :data:`TRACE_ID_HEADER` response header, never in a body.
- **Consumers:** the in-process :class:`FlightRecorder` ring buffer of
  completed sampled traces, stored as ``obs/flightrec/`` documents
  (schema :data:`FLIGHT_RECORD_SCHEMA`, :func:`write_flight_record`); the
  latency histogram's exemplars (``obs.registry.Histogram``) on
  ``/metrics`` and ``/healthz``; and ``cli trace show|tail|export``,
  which renders stored traces through the Chrome-trace emitter of
  :mod:`bodywork_tpu_torch.obs.spans`. Nothing in the port writes flight
  records yet: the SLO watchdog that dumps them at its verdicts is a
  later slice.

Span times are ``time.perf_counter`` readings on the host. A span around
device work ends where the host has the result back (the predictor's
copy to the host is its synchronisation point), never at a launch.

Stdlib-only, like the rest of :mod:`bodywork_tpu_torch.obs`.
"""
from __future__ import annotations

import contextvars
import hashlib
import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

from bodywork_tpu_torch.utils.integrity import stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("obs.tracing")

__all__ = [
    "FLIGHT_RECORD_SCHEMA",
    "TRACEPARENT_HEADER",
    "TRACE_ID_HEADER",
    "FlightRecorder",
    "RequestTrace",
    "TraceSpan",
    "Tracer",
    "annotate_active",
    "configure_tracing",
    "configured_tracing",
    "flight_record_doc",
    "flight_trace_spans",
    "get_tracer",
    "head_sampled",
    "mint_trace_id",
    "parse_traceparent",
    "validate_flight_record",
    "write_flight_record",
]

#: W3C ingress header both engines accept (case-insensitive per HTTP)
TRACEPARENT_HEADER = "traceparent"
#: the ONLY place a trace id leaves the service: a response header, never
#: a body, so response bodies are byte-identical with tracing on or off
#: (the same rule as the model-key header)
TRACE_ID_HEADER = "X-Bodywork-Trace-Id"

FLIGHT_RECORD_SCHEMA = "bodywork_tpu.flight_record/1"

#: env knobs (read once at tracer construction; ``configure_tracing``
#: overrides in-process). Sampling defaults to a light head fraction so
#: the flight recorder has evidence out of the box; 0 disables tracing
#: entirely (no mint, no header, zero overhead).
SAMPLE_ENV = "BODYWORK_TPU_TRACE_SAMPLE"
SEED_ENV = "BODYWORK_TPU_TRACE_SEED"
DEFAULT_SAMPLE_FRACTION = 0.1
#: completed sampled traces the in-process ring buffer retains (oldest
#: evicted first)
DEFAULT_RECORDER_CAPACITY = 256

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header,
    or None for an absent/malformed one (malformed ingress context is
    DROPPED, per the spec — the request then mints its own id; an
    all-zero trace id is invalid too)."""
    if not value:
        return None
    match = _TRACEPARENT_RE.match(value.strip().lower())
    if match is None:
        return None
    trace_id, parent = match.group(1), match.group(2)
    if trace_id == "0" * 32 or parent == "0" * 16:
        return None
    return trace_id, parent


def mint_trace_id(seed: int, payload: bytes) -> str:
    """A 32-hex-char trace id minted as a PURE function of ``(seed,
    request body bytes)`` — seeded replays mint identical ids for
    identical requests (module docstring)."""
    digest = hashlib.sha256(
        str(int(seed)).encode("ascii") + b"|trace|" + payload
    ).digest()
    return digest[:16].hex()


def head_sampled(seed: int, trace_id: str, fraction: float) -> bool:
    """The deterministic head-sampling decision: a pure function of
    ``(sampling seed, trace id)`` — one sha256 + one compare over
    the digest's unbiased top 64 bits."""
    if fraction >= 1.0:
        return True
    if fraction <= 0.0:
        return False
    digest = hashlib.sha256(
        str(int(seed)).encode("ascii") + b"|sample|" + trace_id.encode("ascii")
    ).digest()
    return int.from_bytes(digest[:8], "big") < int(fraction * 2.0**64)


def _derived_span_id(trace_id: str, name: str, ordinal: int) -> str:
    """16-hex span id, deterministic within a trace (replay-stable)."""
    return hashlib.sha256(
        f"{trace_id}|{name}|{ordinal}".encode("ascii")
    ).digest()[:8].hex()


class TraceSpan:
    """One interval inside a request trace (seconds relative to the
    trace's begin). ``meta`` is open: the dispatch path records bucket /
    AOT-cache facts, the coalescer records batch fan-in links."""

    __slots__ = ("name", "span_id", "parent_id", "start_s", "duration_s", "meta")

    def __init__(self, name: str, span_id: str, parent_id: str,
                 start_s: float, duration_s: float | None = None, meta=None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.duration_s = duration_s
        self.meta = meta if meta is not None else {}

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": round(self.start_s, 6),
            # an unclosed span (handler raised mid-flight) reports zero
            # duration rather than poisoning the dump
            "duration_s": round(self.duration_s or 0.0, 6),
        }
        if self.meta:
            d["meta"] = dict(self.meta)
        return d


class RequestTrace:
    """The per-request span context both engines thread through the hot
    path. Unsampled traces carry ``spans=None`` and every record method
    is a no-op behind one branch — the context object is the only
    allocation the unsampled path pays."""

    __slots__ = (
        "trace_id", "parent_span_id", "root_span_id", "sampled",
        "_t0", "spans", "_lock", "_n", "route", "status", "meta",
    )

    def __init__(self, trace_id: str, sampled: bool,
                 parent_span_id: str | None = None):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.root_span_id = _derived_span_id(trace_id, "request", 0)
        self.sampled = sampled
        self._t0 = time.perf_counter()
        self.route: str | None = None
        self.status: int | None = None
        # span storage only exists for sampled traces; the lock is for
        # the coalescer's dispatcher thread recording into a request's
        # trace concurrently with the request thread
        self.spans: list[TraceSpan] | None = [] if sampled else None
        self._lock = threading.Lock() if sampled else None
        self._n = 0
        self.meta: dict = {}

    def now(self) -> float:
        """Seconds since this trace began (perf_counter timeline)."""
        return time.perf_counter() - self._t0

    def rel(self, t_perf: float) -> float:
        return t_perf - self._t0

    def add(self, name: str, t_start_perf: float, t_end_perf: float,
            **meta) -> TraceSpan | None:
        """Record an already-measured interval (absolute perf_counter
        endpoints — the timestamps the metrics path already takes)."""
        if self.spans is None:
            return None
        with self._lock:
            self._n += 1
            span = TraceSpan(
                name, _derived_span_id(self.trace_id, name, self._n),
                self.root_span_id, self.rel(t_start_perf),
                t_end_perf - t_start_perf, meta,
            )
            self.spans.append(span)
        return span

    def start_span(self, name: str, **meta) -> TraceSpan | None:
        """Open a span NOW (closed via :meth:`end_span`) — for paths
        that want mid-flight annotation (the AOT dispatch)."""
        if self.spans is None:
            return None
        with self._lock:
            self._n += 1
            span = TraceSpan(
                name, _derived_span_id(self.trace_id, name, self._n),
                self.root_span_id, self.now(), None, meta,
            )
            self.spans.append(span)
        return span

    def end_span(self, span: TraceSpan | None) -> None:
        if span is not None:
            span.duration_s = self.now() - span.start_s

    def annotate(self, **meta) -> None:
        """Attach request-level facts (stream, model key, …) to the
        trace root. No-op when unsampled."""
        if self.spans is not None:
            self.meta.update(meta)

    def to_dict(self) -> dict:
        doc = {
            "trace_id": self.trace_id,
            "root_span_id": self.root_span_id,
            "route": self.route,
            "status": self.status,
            "duration_s": round(self.now(), 6),
            "spans": [s.to_dict() for s in (self.spans or ())],
        }
        if self.parent_span_id:
            doc["parent_span_id"] = self.parent_span_id
        if self.meta:
            doc["meta"] = dict(self.meta)
        return doc


# -- the active-span channel (predictor annotations) -----------------------

_ACTIVE_SPAN: contextvars.ContextVar[TraceSpan | None] = contextvars.ContextVar(
    "bodywork_tpu_active_span", default=None
)


def set_active_span(span: TraceSpan | None):
    """Install ``span`` as the thread/task's active span; returns the
    reset token. Only the sampled dispatch path sets one."""
    return _ACTIVE_SPAN.set(span)


def reset_active_span(token) -> None:
    _ACTIVE_SPAN.reset(token)


def annotate_active(**meta) -> None:
    """Attach facts to whatever span is active (the predictor's lazy
    AOT-compile seam). One contextvar read + a branch when nothing is —
    safe to call from any depth."""
    span = _ACTIVE_SPAN.get()
    if span is not None:
        span.meta.update(meta)


# -- flight recorder -------------------------------------------------------


class FlightRecorder:
    """Bounded in-process ring buffer of COMPLETED sampled traces: the
    evidence a dump (:func:`write_flight_record`) persists."""

    def __init__(self, capacity: int = DEFAULT_RECORDER_CAPACITY):
        self._lock = threading.Lock()
        self._traces: deque = deque(maxlen=int(capacity))

    def add(self, trace_doc: dict) -> None:
        with self._lock:
            self._traces.append(trace_doc)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class Tracer:
    """The process-wide tracing front door (one per serving process,
    like the metrics registry): config + the flight recorder. Both
    engines call :meth:`begin` on scoring ingress and :meth:`finish`
    once the response is built."""

    def __init__(self, sample_fraction: float | None = None,
                 seed: int | None = None,
                 recorder_capacity: int = DEFAULT_RECORDER_CAPACITY):
        if sample_fraction is None:
            sample_fraction = _env_fraction()
        if seed is None:
            seed = _env_seed()
        self.sample_fraction = float(sample_fraction)
        self.seed = int(seed)
        self.recorder = FlightRecorder(recorder_capacity)
        self._m_sampled = None

    @property
    def enabled(self) -> bool:
        """Fraction 0 turns tracing OFF entirely: no mint, no header,
        no per-request work at all — the tracing-off twin."""
        return self.sample_fraction > 0.0

    def begin(self, traceparent: str | None, payload: bytes) -> RequestTrace:
        """One request's trace context: ingress id when a valid
        ``traceparent`` arrived, minted otherwise; sampled by the
        deterministic head decision. The unsampled path is exactly the
        mint + one hash + one branch + this object."""
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent = parsed
        else:
            trace_id, parent = mint_trace_id(self.seed, payload), None
        sampled = head_sampled(self.seed, trace_id, self.sample_fraction)
        return RequestTrace(trace_id, sampled, parent)

    def finish(self, trace: RequestTrace, route: str, status: int) -> None:
        """Complete a trace; sampled ones land in the flight recorder
        (and count). Unsampled: one branch, nothing else."""
        if trace.spans is None:
            return
        trace.route = route
        trace.status = int(status)
        self.recorder.add(trace.to_dict())
        if self._m_sampled is None:
            from bodywork_tpu_torch.obs.registry import get_registry

            self._m_sampled = get_registry().counter(
                "bodywork_tpu_trace_sampled_total",
                "Scoring requests head-sampled into the flight recorder, "
                "by route",
            )
        self._m_sampled.inc(route=route)


def _env_fraction() -> float:
    raw = os.environ.get(SAMPLE_ENV, "").strip()
    if raw:
        try:
            value = float(raw)
            if 0.0 <= value <= 1.0:
                return value
        except ValueError:
            pass
        log.warning(f"ignoring {SAMPLE_ENV}={raw!r} (need a fraction in [0, 1])")
    return DEFAULT_SAMPLE_FRACTION


def _env_seed() -> int:
    raw = os.environ.get(SEED_ENV, "").strip()
    if raw:
        try:
            return int(raw)
        except ValueError:
            log.warning(f"ignoring {SEED_ENV}={raw!r} (need an integer)")
    return 0


#: THE process-wide tracer (configure_tracing mutates it IN PLACE so
#: apps that captured the reference see config changes immediately)
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def configure_tracing(sample_fraction: float, seed: int = 0,
                      recorder_capacity: int | None = None) -> Tracer:
    """Reconfigure the process tracer in place (CLI / harness entry).
    Clears the recorder: evidence must belong to the configured run."""
    if not 0.0 <= sample_fraction <= 1.0:
        raise ValueError(
            f"sample_fraction must be in [0, 1], got {sample_fraction}"
        )
    _TRACER.sample_fraction = float(sample_fraction)
    _TRACER.seed = int(seed)
    if recorder_capacity is not None:
        _TRACER.recorder = FlightRecorder(recorder_capacity)
    else:
        _TRACER.recorder.clear()
    return _TRACER


@contextmanager
def configured_tracing(sample_fraction: float, seed: int = 0):
    """Scoped tracer config (harnesses and tests): configure, yield the
    tracer, restore the previous (fraction, seed) — the recorder is
    cleared on entry so the scope's evidence is its own."""
    previous = (_TRACER.sample_fraction, _TRACER.seed)
    tracer = configure_tracing(sample_fraction, seed)
    try:
        yield tracer
    finally:
        _TRACER.sample_fraction, _TRACER.seed = previous
        _TRACER.recorder.clear()


# -- flight-record documents (store schema bodywork_tpu.flight_record/1) ---


def flight_record_doc(
    traces: list[dict],
    verdict: str,
    reason: str,
    canary_key: str | None = None,
    production_key: str | None = None,
    window: dict | None = None,
    sampling: dict | None = None,
) -> dict:
    """The dump document persisted at a verdict (the JAX package's SLO
    watchdog writes one at each abort/promote). A pure function of its
    inputs (no wall clock — trace timings are relative offsets), stamped
    with a ``doc_digest`` so a reader can see rot."""
    return stamp_doc({
        "schema": FLIGHT_RECORD_SCHEMA,
        "verdict": verdict,
        "reason": reason,
        "canary_key": canary_key,
        "production_key": production_key,
        "window": window or {},
        "sampling": sampling or {},
        "n_traces": len(traces),
        "traces": list(traces),
    })


def validate_flight_record(doc) -> bool:
    """Schema-tag + shape + embedded-digest validation, which every
    reader of ``obs/flightrec/`` (``cli trace``) goes through."""
    if not isinstance(doc, dict) or doc.get("schema") != FLIGHT_RECORD_SCHEMA:
        return False
    if verify_doc(doc) is False:
        return False
    traces = doc.get("traces")
    if not isinstance(traces, list) or doc.get("n_traces") != len(traces):
        return False
    return all(
        isinstance(t, dict) and t.get("trace_id") and isinstance(
            t.get("spans"), list
        )
        for t in traces
    )


def write_flight_record(store, doc: dict) -> str:
    """Persist one dump under ``obs/flightrec/``. The key leads with a
    sequence number (count of dumps already stored — listing order IS
    write order, no wall clock) and embeds the content digest, so a
    re-write of the SAME document is idempotent (returns the existing
    key) while concurrent distinct documents never collide."""
    from bodywork_tpu_torch.store.schema import FLIGHTREC_PREFIX, flight_record_key

    fragment = doc["doc_digest"].removeprefix("sha256:")[:16]
    existing = store.list_keys(FLIGHTREC_PREFIX)
    for key in existing:
        if key.endswith(f"-{doc['verdict']}-{fragment}.json"):
            return key  # same document already dumped
    key = flight_record_key(len(existing), doc["verdict"], doc["doc_digest"])
    store.put_bytes(
        key, json.dumps(doc, sort_keys=True, indent=1).encode("utf-8")
    )
    return key


def iter_flight_records(store):
    """``(key, doc)`` for every VALID stored dump, newest-keyed last;
    invalid ones are skipped with a warning."""
    from bodywork_tpu_torch.store.schema import FLIGHTREC_PREFIX

    for key in store.list_keys(FLIGHTREC_PREFIX):
        try:
            doc = json.loads(store.get_bytes(key).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            log.warning(f"skipping unreadable flight record {key}")
            continue
        if not validate_flight_record(doc):
            log.warning(f"skipping invalid flight record {key}")
            continue
        yield key, doc


def find_trace(store, trace_id: str):
    """``(dump_key, trace_doc)`` for a stored trace by full id or any
    unambiguous prefix; ``(None, None)`` when absent."""
    trace_id = trace_id.strip().lower()
    for key, doc in iter_flight_records(store):
        for trace in doc["traces"]:
            if trace["trace_id"].startswith(trace_id):
                return key, trace
    return None, None


def flight_trace_spans(trace_doc: dict):
    """A stored trace rendered as :class:`bodywork_tpu_torch.obs.spans.Span`
    objects (one Chrome-trace track per trace), so ``cli trace export
    --chrome`` reuses the existing Perfetto emitter unchanged."""
    from bodywork_tpu_torch.obs.spans import Span

    track = f"trace-{trace_doc['trace_id'][:8]}"
    meta = dict(trace_doc.get("meta") or {})
    meta["trace_id"] = trace_doc["trace_id"]
    out = [Span(
        name=f"request {trace_doc.get('route') or ''}".strip(),
        category="request",
        start_s=0.0,
        duration_s=trace_doc.get("duration_s") or 0.0,
        thread=track,
        meta={**meta, "status": trace_doc.get("status")},
    )]
    for span in trace_doc.get("spans", ()):
        out.append(Span(
            name=span["name"],
            category="serve",
            start_s=span.get("start_s") or 0.0,
            duration_s=span.get("duration_s") or 0.0,
            thread=track,
            meta=dict(span.get("meta") or {}),
        ))
    return out
