"""The scoring application (the port of ``bodywork_tpu.serve.app``, cut to
the serving core): plain Python over the standard library, no WSGI.

Routes, in the JAX app's wire format (the same keys in the same order;
for the same float predictions, the same bytes):

- ``POST /score/v1``  ``{"X": 50}`` -> ``{"prediction", "model_info", "model_date"}``
- ``POST /score/v1/batch`` ``{"X": [...]}`` -> ``{"predictions", "n", "model_info", "model_date"}``
- ``GET /healthz`` -> the JAX app's health document (identity, queue
  depth, admission state, ``effective_config``), then the port's
  ``engine``, ``device``, the serving kernel's ``launches`` and the graph
  cache's counts;
- ``GET /metrics`` -> this process's metrics registry in the Prometheus
  text format.

Malformed requests answer 400 with the JAX app's messages; unknown routes
404 and wrong methods 405 with werkzeug's descriptions; an unhandled
error 500 ``{"error": "internal server error"}``. With an admission
controller (``serve.admission``) a scoring request past the pending
budget answers 429 + ``Retry-After`` before its body is parsed; an app
with no model answers scoring requests 503 + ``Retry-After``. Scoring
answers carry the ``X-Bodywork-Model-Key`` header.

Request tracing (``obs.tracing``, the app's :attr:`ScoringApp.tracer`): a
scoring POST gets a trace id, its ingress ``traceparent``'s (read before
admission, so a shed request answers with it and records its shed span)
or one minted from the body after admission, and answers it in the
``X-Bodywork-Trace-Id`` header, never in a body. A head-sampled request
records ``parse``, ``device-dispatch`` (with the graph cache's
``aot_cache`` and ``bucket``, or ``queue-wait`` and the batch's shared
dispatch span when coalesced) and ``serialize`` spans into the flight
recorder, and leaves its id as the latency histogram's exemplar. At
sample fraction 0 nothing is minted, sent or recorded.

With a request coalescer (``serve.batcher``) concurrent single-row
``/score/v1`` requests share padded device calls; a saturated coalescer
degrades to a direct dispatch. Responses are byte-identical either way.

Every scoring path runs the prediction-sanity firewall before it
serialises a prediction (the production branch of the JAX app's,
``bodywork_tpu/serve/app.py:137-170,697-717``): a non-finite prediction
raises :class:`PredictionSanityError` and the request answers 500, the
value never written; a prediction outside the model's registry band
(``prediction_bounds``, from its training labels) is logged and served,
since the band is statistical. Canary routing and hot swaps (and with
them the firewall's fallback to production, whose re-predict span the
JAX app records) and the multi-process ``/metrics`` wait for later
slices.
"""
from __future__ import annotations

import json
import time

import numpy as np

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.obs.tracing import (
    TRACE_ID_HEADER,
    get_tracer,
    parse_traceparent,
    reset_active_span,
    set_active_span,
)
from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
from bodywork_tpu_torch.serve.batcher import CoalescerSaturated
from bodywork_tpu_torch.serve.wire import (
    MODEL_KEY_HEADER,
    BatchResponseTemplate,
    SingleResponseTemplate,
    parse_features,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.app")

_NOT_FOUND = (
    "The requested URL was not found on the server. If you entered the URL "
    "manually please check your spelling and try again."
)
_METHOD_NOT_ALLOWED = "The method is not allowed for the requested URL."
_JSON = {"Content-Type": "application/json"}
#: the Prometheus text exposition's content type
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: parse/serialize are µs-scale host work (the JAX app's buckets)
_FAST_PHASE_BUCKETS = (
    0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1,
)

#: routes whose successful requests count into the scoring-latency histogram
_SCORING_ROUTES = ("/score/v1", "/score/v1/batch")

#: Retry-After (seconds) on a no-model 503 from an app without admission
#: control; with admission, every backpressure answer carries its EWMA
RETRY_AFTER_S = 5


class PredictionSanityError(RuntimeError):
    """A production prediction failed the sanity firewall (non-finite).
    There is no healthier model to answer from, so the request fails
    (500) rather than serialise garbage to the client."""


def as_bounds(bounds) -> tuple[float, float] | None:
    """A registry ``prediction_bounds`` value (``{"lo", "hi"}`` or a
    ``(lo, hi)`` pair) as a float pair; None when absent or malformed (the
    firewall then checks finiteness only)."""
    if bounds is None:
        return None
    try:
        if isinstance(bounds, dict):
            lo, hi = float(bounds["lo"]), float(bounds["hi"])
        else:
            lo, hi = float(bounds[0]), float(bounds[1])
    except (KeyError, IndexError, TypeError, ValueError):
        return None
    if not (np.isfinite(lo) and np.isfinite(hi) and lo <= hi):
        return None
    return lo, hi


def sanity_violation(predictions, bounds: tuple[float, float] | None) -> str | None:
    """The firewall's verdict on one response's predictions:
    ``"non_finite"`` (NaN or inf anywhere), ``"out_of_range"`` (outside
    ``bounds``) or None (sane)."""
    arr = np.asarray(predictions, dtype=np.float64)
    if not np.all(np.isfinite(arr)):
        return "non_finite"
    if bounds is not None:
        lo, hi = bounds
        if np.any(arr < lo) or np.any(arr > hi):
            return "out_of_range"
    return None


def _json_response(payload: dict, status: int = 200, headers=None):
    return status, {**_JSON, **(headers or {})}, json.dumps(payload).encode()


def _with_trace_id(response, trace):
    """``response`` with the trace id header: the only place an id leaves
    the service (never a body, so bodies stay byte-identical)."""
    status, headers, body = response
    return status, {**headers, TRACE_ID_HEADER: trace.trace_id}, body


def _is_json(content_type: str | None) -> bool:
    mimetype = (content_type or "").split(";", 1)[0].strip().lower()
    return mimetype == "application/json" or (
        mimetype.startswith("application/") and mimetype.endswith("+json")
    )


class _Served:
    """One served model: predictor + identity, read once per request."""

    __slots__ = (
        "predictor", "model_info", "model_date", "model_key", "source",
        "bounds", "single_template", "batch_template",
    )

    def __init__(self, predictor, model_info: str, model_date: str | None,
                 model_key: str | None = None, source: str | None = None,
                 bounds: tuple[float, float] | None = None):
        self.predictor = predictor
        self.model_info = model_info
        self.model_date = model_date
        self.model_key = model_key
        self.source = source
        #: (lo, hi) prediction-sanity band from the model's registry record
        self.bounds = bounds
        self.single_template = SingleResponseTemplate(model_info, model_date)
        self.batch_template = BatchResponseTemplate(model_info, model_date)


class ScoringApp:
    """Scoring application over a shape-bucketed predictor. :meth:`handle`
    maps one request to ``(status, headers, body)``; the HTTP front ends
    (``serve.server``'s thread engine, ``serve.aio``) only move bytes.

    ``batcher`` (a started ``RequestCoalescer``) and ``admission`` (an
    ``AdmissionController``) are optional; ``model=None`` boots an app
    with nothing to serve, whose scoring requests answer 503."""

    def __init__(self, model, model_date=None, predictor=None,
                 model_key: str | None = None, model_source: str | None = None,
                 model_bounds=None, batcher=None, admission=None):
        if model is None:
            assert predictor is None, "a predictor needs a model"
            self.served = None
        else:
            if predictor is None:
                from bodywork_tpu_torch.serve.predictor import PaddedPredictor

                predictor = PaddedPredictor(model)
            self.served = _Served(
                predictor, model.info, str(model_date) if model_date else None,
                model_key=model_key, source=model_source, bounds=as_bounds(model_bounds),
            )
        self.batcher = batcher
        self.admission = admission
        #: the process-wide request tracer (``obs.tracing``); fraction 0
        #: turns tracing off, with no per-request work
        self.tracer = get_tracer()
        reg = get_registry()
        self._m_requests = reg.counter(
            "bodywork_tpu_http_requests_total",
            "HTTP requests served, by route and status",
        )
        self._m_latency = reg.histogram(
            "bodywork_tpu_scoring_latency_seconds",
            "End-to-end handler time of successful scoring requests",
        )
        self._m_parse = reg.histogram(
            "bodywork_tpu_request_parse_seconds",
            "Request-parse phase: JSON body -> validated feature array",
            buckets=_FAST_PHASE_BUCKETS,
        )
        self._m_dispatch = reg.histogram(
            "bodywork_tpu_device_dispatch_seconds",
            "Device-dispatch phase: one padded predictor call",
        )
        self._m_serialize = reg.histogram(
            "bodywork_tpu_response_serialize_seconds",
            "Serialization phase: prediction -> JSON response",
            buckets=_FAST_PHASE_BUCKETS,
        )
        self._m_fallbacks = reg.counter(
            "bodywork_tpu_coalescer_fallback_total",
            "Requests degraded to a direct dispatch (coalescer saturated)",
        )
        self._m_sanity = reg.counter(
            "bodywork_tpu_serve_sanity_violations_total",
            "Predictions caught by the sanity firewall before "
            "serialization, by model_key, stream, and reason "
            "(non_finite|out_of_range)",
        )
        reg.gauge(
            "bodywork_tpu_serve_degraded_state",
            "Serving degradation: 0=healthy, 1=serving last-good model "
            "after a failed reload, 2=no model loaded",
            aggregate="max",
        ).set(2.0 if self.served is None else 0.0)
        served = self.served
        if served is not None and served.model_key is not None:
            reg.gauge(
                "bodywork_tpu_serve_model_version_info",
                "Served model version: 1 on the (model_key, source) sample "
                "currently serving, 0 on superseded ones",
                aggregate="max",
            ).set(1.0, model_key=served.model_key, source=served.source or "unspecified")
        self._routes = {
            ("POST", "/score/v1"): self.score_data_instance,
            ("POST", "/score/v1/batch"): self.score_batch,
            ("GET", "/healthz"): self.healthz,
            ("GET", "/metrics"): self.metrics_endpoint,
        }

    @property
    def predictor(self):
        served = self.served
        return None if served is None else served.predictor

    @property
    def model_key(self) -> str | None:
        served = self.served
        return None if served is None else served.model_key

    @property
    def model_source(self) -> str | None:
        served = self.served
        return None if served is None else served.source

    def known_path(self, path: str) -> bool:
        return any(p == path for _m, p in self._routes)

    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None, traceparent: str | None = None):
        """One request -> ``(status, headers, body)``. Admission runs first
        for a scoring POST, before anything that costs per-request work: a
        shed leaves nothing behind but its counter (and, for a request
        that arrived with a valid ``traceparent``, its trace). A scoring
        POST's trace id is minted from the body only once admitted."""
        path = path.split("?", 1)[0]
        t0 = time.perf_counter()
        scoring_post = method == "POST" and path in _SCORING_ROUTES
        tracer = self.tracer
        traced = scoring_post and tracer.enabled
        trace = None
        if traced and traceparent is not None and parse_traceparent(traceparent) is not None:
            trace = tracer.begin(traceparent, b"")
        admission = self.admission
        admitted = False
        if admission is not None and scoring_post:
            if not admission.try_admit():
                response = self.shed_response()
                if trace is not None:
                    if trace.sampled:
                        now = time.perf_counter()
                        trace.add("admission-shed", now, now,
                                  queue_depth=admission.queue_depth)
                    tracer.finish(trace, path, response[0])
                    response = _with_trace_id(response, trace)
                self._m_requests.inc(route=path, status=str(response[0]))
                return response
            admitted = True
        if traced and trace is None:
            trace = tracer.begin(None, body)
        try:
            handler = self._routes.get((method, path))
            if handler is None:
                if self.known_path(path):
                    response = _json_response({"error": _METHOD_NOT_ALLOWED}, 405)
                else:
                    response = _json_response({"error": _NOT_FOUND}, 404)
            else:
                response = handler(body, content_type, trace)
        except Exception as exc:  # don't leak tracebacks to clients
            log.error(f"unhandled error serving {path}: {exc!r}")
            response = _json_response({"error": "internal server error"}, 500)
        finally:
            if admitted:
                # admission -> response ready: the EWMA behind Retry-After
                admission.release(time.perf_counter() - t0)
        status = response[0]
        route = path if self.known_path(path) else "unknown"
        self._m_requests.inc(route=route, status=str(status))
        if path in _SCORING_ROUTES and status == 200:
            # a sampled request leaves its trace id as the bucket's exemplar
            self._m_latency.observe(
                time.perf_counter() - t0,
                exemplar=trace.trace_id if trace is not None and trace.sampled else None,
            )
        if trace is not None:
            tracer.finish(trace, route, status)
            response = _with_trace_id(response, trace)
        return response

    # -- parsing and backpressure ------------------------------------------
    def _parse(self, body: bytes, content_type: str | None, trace=None):
        t0 = time.perf_counter()
        payload = None
        if _is_json(content_type):
            try:
                payload = json.loads(body)
            except ValueError:
                payload = None
        X, message = parse_features(payload)
        t1 = time.perf_counter()
        self._m_parse.observe(t1 - t0)
        if trace is not None and trace.sampled:
            trace.add("parse", t0, t1)
        if message is not None:
            return None, _json_response({"error": message}, 400)
        return X, None

    def retry_after_s(self) -> int:
        """The one Retry-After every backpressure answer of this app
        carries: admission's clamped EWMA, else :data:`RETRY_AFTER_S`."""
        if self.admission is not None:
            return self.admission.retry_after_s()
        return RETRY_AFTER_S

    def shed_response(self):
        """The admission-shed 429."""
        return _json_response({"error": "server over capacity; request shed"}, 429,
                              {"Retry-After": str(self.retry_after_s())})

    def _no_model_response(self):
        return _json_response({"error": "no model loaded yet; retry shortly"}, 503,
                              {"Retry-After": str(self.retry_after_s())})

    def _traced_dispatch(self, served: _Served, X, trace=None):
        """One direct (uncoalesced) padded dispatch, timed. For a sampled
        ``trace`` its ``device-dispatch`` span is the ACTIVE span on the
        calling thread (the one that dispatches, on either front end),
        so the graph cache's seam can annotate it. The span ends when
        ``predict`` returns, after the copy of the results to the host,
        which waits for the card; a replay alone returns at once."""
        span = token = None
        if trace is not None:
            span = trace.start_span("device-dispatch", coalesced=False)
            token = set_active_span(span)
        t0 = time.perf_counter()
        try:
            return served.predictor.predict(X)
        finally:
            self._m_dispatch.observe(time.perf_counter() - t0)
            if span is not None:
                reset_active_span(token)
                trace.end_span(span)

    def _respond(self, served: _Served, payload: bytes):
        headers = dict(_JSON)
        if served.model_key:
            headers[MODEL_KEY_HEADER] = served.model_key
        return 200, headers, payload

    # -- routes ------------------------------------------------------------
    def score_data_instance(self, body: bytes, content_type: str | None, trace=None):
        """Single-instance scoring; reference-parity contract
        (``stage_2:73-80``)."""
        X, err = self._parse(body, content_type, trace)
        if err is not None:
            # a malformed request gets its 400 even from a model-less app
            return err
        served = self.served
        if served is None:
            return self._no_model_response()
        sampled = trace is not None and trace.sampled
        if sampled:
            trace.annotate(stream="production", routed_model_key=served.model_key)
        X = np.array(X, ndmin=2)  # scalar -> (1, 1), as the reference
        prediction0 = None
        if self.batcher is not None and X.shape[0] == 1:
            try:
                # the submission carries ITS served bundle: its batch is
                # scored by one model only; the coalescer records the
                # queue-wait and device-dispatch spans
                prediction0 = self.batcher.submit(served, X[0],
                                                  trace=trace if sampled else None)
            except CoalescerSaturated:
                self._m_fallbacks.inc()  # overload or shutdown: go direct
        if prediction0 is None:
            predictions = self._traced_dispatch(served, X, trace if sampled else None)
            prediction0 = float(np.asarray(predictions).ravel()[0])
        return self.render(served, served.single_template.render, prediction0, trace)

    def score_batch(self, body: bytes, content_type: str | None, trace=None):
        """Batched scoring: one padded device call per bucket-size chunk."""
        X, err = self._parse(body, content_type, trace)
        if err is not None:
            return err
        served = self.served
        if served is None:
            return self._no_model_response()
        sampled = trace is not None and trace.sampled
        if sampled:
            trace.annotate(stream="production", routed_model_key=served.model_key,
                           rows=int(np.atleast_1d(X).shape[0]))
        if X.ndim == 0:
            X = X[None]
        predictions = self._traced_dispatch(served, X, trace if sampled else None)
        return self.render(served, served.batch_template.render, predictions, trace)

    def render(self, served: _Served, template, predictions, trace=None):
        """The firewall, then the response from ``template`` (a
        ``serve.wire`` renderer), timed, with its ``serialize`` span for a
        sampled ``trace``."""
        self.firewall(served, predictions)
        t0 = time.perf_counter()
        payload = template(predictions)
        t1 = time.perf_counter()
        self._m_serialize.observe(t1 - t0)
        if trace is not None and trace.sampled:
            trace.add("serialize", t0, t1)
        return self._respond(served, payload)

    def firewall(self, served: _Served, predictions) -> None:
        """The prediction-sanity firewall, before serialisation: a
        non-finite prediction raises :class:`PredictionSanityError` (500);
        one outside the model's band is logged and served. Both count into
        ``bodywork_tpu_serve_sanity_violations_total``."""
        reason = sanity_violation(predictions, served.bounds)
        if reason is None:
            return
        self._m_sanity.inc(model_key=served.model_key or "unknown", stream="production",
                           reason=reason)
        if reason == "non_finite":
            log.error(f"production prediction non-finite on {served.model_key}; "
                      "refusing to serialize")
            raise PredictionSanityError(reason)
        log.warning(f"production prediction out of sanity band on "
                    f"{served.model_key} (served anyway; band is statistical)")

    def effective_config(self) -> dict:
        """The knob values live in this process, read from the live
        objects (coalescer, admission controller, predictor)."""
        predictor = self.predictor
        batcher = self.batcher
        admission = self.admission
        buckets = getattr(predictor, "buckets", None)
        return {
            "batch_window_ms": round(batcher.window_s * 1e3, 3) if batcher is not None else None,
            "batch_max_rows": batcher.max_rows if batcher is not None else None,
            "buckets": list(buckets) if buckets else None,
            "max_pending": admission.max_pending if admission is not None else None,
            "dtype": getattr(predictor, "dtype", "float32") if predictor is not None else None,
            "tuned_config": None,
        }

    def healthz_response(self) -> tuple[dict, int, int | None]:
        """``(payload, status, retry_after_s or None)``: the health document
        both front ends serve. The keys are the JAX app's, in its order
        (the parts of later slices null: mesh, canary, watchdog, tuning,
        degraded reason), then the port's ``engine``, ``device``,
        ``launches`` (of the serving kernel since the counts were last
        reset; null for a plain engine) and ``graph_cache``."""
        from bodywork_tpu_torch.serve.predictor import GRAPH_CACHE

        served = self.served
        admission = self.admission
        if admission is not None:
            queue_depth = admission.queue_depth
            admission_state = admission.state()
        else:
            queue_depth = self.batcher.pending_depth() if self.batcher is not None else 0
            admission_state = None
        common = {
            "canary_key": None, "canary_fraction": None, "watchdog": None, "tuning": None,
        }
        if served is None:
            return ({
                "status": "no model loaded", "degraded": True,
                "reason": "no model has been loaded yet",
                "model_info": None, "model_date": None, "model_key": None,
                "model_source": None, "serving_dtype": None, "mesh": None, **common,
                "queue_depth": queue_depth, "admission": admission_state,
                "effective_config": self.effective_config(),
                "latency_exemplars": self._m_latency.exemplars() or None,
            }, 503, self.retry_after_s())
        predictor = served.predictor
        engine = getattr(predictor, "engine", "torch")
        return ({
            "status": "ok",
            "model_info": served.model_info,
            "model_date": served.model_date,
            "model_key": served.model_key,
            "model_source": served.source,
            "serving_dtype": getattr(predictor, "dtype", "float32"),
            "mesh": None, **common,
            "degraded": False,
            "queue_depth": queue_depth,
            "admission": admission_state,
            "effective_config": self.effective_config(),
            "latency_exemplars": self._m_latency.exemplars() or None,
            "engine": engine,
            "device": predictor.device.type,
            "launches": LAUNCHES.get(engine),
            "graph_cache": GRAPH_CACHE.stats(),
        }, 200, None)

    def healthz_payload(self) -> dict:
        return self.healthz_response()[0]

    def healthz(self, body: bytes, content_type: str | None, trace=None):
        payload, status, retry_after = self.healthz_response()
        headers = {"Retry-After": str(retry_after)} if retry_after is not None else None
        return _json_response(payload, status, headers)

    def metrics_endpoint(self, body: bytes, content_type: str | None, trace=None):
        """This process's registry in the Prometheus text format."""
        return (200, {"Content-Type": METRICS_CONTENT_TYPE},
                get_registry().render().encode())

    def close(self) -> None:
        """Stop the coalescer's dispatcher after flushing what it holds.
        Idempotent; the app still serves afterwards, uncoalesced."""
        if self.batcher is not None:
            self.batcher.stop()


def create_app(model, model_date=None, predictor=None, warmup: bool = True,
               batch_window_ms: float | None = None, batch_max_rows: int | None = None,
               model_key: str | None = None, model_source: str | None = None,
               admission=None, model_bounds=None) -> ScoringApp:
    """A :class:`ScoringApp`, warmed. ``batch_window_ms`` > 0 opts into
    cross-request micro-batching (``serve.batcher``), flushed when
    ``batch_max_rows`` accumulate or the window elapses, whichever first.
    ``admission`` (``serve.admission.AdmissionController``) opts into load
    shedding; replica apps of one listener share one controller."""
    batcher = None
    if batch_window_ms and batch_window_ms > 0:
        from bodywork_tpu_torch.serve.batcher import DEFAULT_MAX_ROWS, RequestCoalescer

        batcher = RequestCoalescer(
            window_ms=batch_window_ms, max_rows=batch_max_rows or DEFAULT_MAX_ROWS,
        ).start()
    app = ScoringApp(model, model_date, predictor=predictor, model_key=model_key,
                     model_source=model_source, model_bounds=model_bounds,
                     batcher=batcher, admission=admission)
    if warmup and app.predictor is not None:
        app.predictor.warmup()
    return app
