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

Scoring bodies are JSON, or the binary row framing
(``application/x-bodywork-rows``, ``serve.wire``), which parses to the
same array.

Hot reload and canary routing (the JAX app's, ``bodywork_tpu/serve/
app.py:118-134,443-743``): :meth:`ScoringApp.swap_model` replaces the
served bundle in one pointer write, warm before it publishes, then
drains the coalescer; a live canary (:meth:`ScoringApp.set_canary`)
takes the requests :func:`routes_to_canary` picks by a seeded hash of
the request's float32 bytes, measured under per-stream request, error
and latency metrics while it is live.

Every scoring path runs the prediction-sanity firewall before it
serialises a prediction: a canary's violation is answered from
production (its ``firewall-fallback`` span recorded); a production
non-finite prediction raises :class:`PredictionSanityError` and the
request answers 500, the value never written; a production prediction
outside the model's registry band (``prediction_bounds``, from its
training labels) is logged and served, since the band is statistical.
Under ``serve --workers N`` every replica flushes its registry to a
shared snapshot directory (``metrics_dir``, ``obs.multiproc``), and
``GET /metrics`` merges this process's live registry with its siblings'
snapshots, one service-wide view on one port.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import time

import numpy as np

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.obs.tracing import (
    get_tracer,
    parse_traceparent,
    reset_active_span,
    set_active_span,
)
from bodywork_tpu_torch.serve.batcher import CoalescerSaturated
from bodywork_tpu_torch.serve.httpcore import (
    FAST_PHASE_BUCKETS,
    JSON_HEADERS,
    METHOD_NOT_ALLOWED,
    METRICS_CONTENT_TYPE,
    NOT_FOUND,
    RETRY_AFTER_S,
    SCORING_ROUTES,
    json_response,
    with_trace_id,
)
from bodywork_tpu_torch.serve.wire import (
    BINARY_CONTENT_TYPE,
    MODEL_KEY_HEADER,
    BatchResponseTemplate,
    SingleResponseTemplate,
    parse_binary_rows,
    parse_features,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.app")

class PredictionSanityError(RuntimeError):
    """A production prediction failed the sanity firewall (non-finite).
    There is no healthier model to answer from, so the request fails
    (500) rather than serialise garbage to the client."""


def _predictor_mesh(predictor) -> dict | None:
    """The device-mesh shape a predictor dispatches over, or None for a
    single-device predictor: the ``/healthz`` ``mesh`` block."""
    mesh = getattr(predictor, "mesh", None)
    if mesh is None:
        return None
    return {"data": int(mesh.shape["data"]), "model": int(mesh.shape["model"])}


def routes_to_canary(seed: int, fraction: float, X) -> bool:
    """Whether a request routes to the canary: a pure function of the
    seed and the request's float32 feature bytes (no RNG, no clock), so
    one request picks the same stream on every replica, engine and
    replay, and in both packages. The sha256's top 64 bits are held
    against ``fraction`` of 2^64."""
    if fraction >= 1.0:
        return True
    if fraction <= 0.0:
        return False
    digest = hashlib.sha256(
        str(int(seed)).encode("ascii")
        + b"|"
        + np.ascontiguousarray(np.asarray(X, dtype=np.float32)).tobytes()
    ).digest()
    return int.from_bytes(digest[:8], "big") < int(fraction * 2.0**64)


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


def _is_json(content_type: str | None) -> bool:
    mimetype = (content_type or "").split(";", 1)[0].strip().lower()
    return mimetype == "application/json" or (
        mimetype.startswith("application/") and mimetype.endswith("+json")
    )


class _Served:
    """One served model: predictor + identity, swapped as a unit and read
    once per request, so no answer pairs one model's prediction with
    another's identity."""

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

    The served model is one bundle behind one attribute (``served``), so
    :meth:`swap_model` is a pointer write: a request in flight finishes
    on the model it started with. ``batcher`` (a started
    ``RequestCoalescer``) and ``admission`` (an ``AdmissionController``)
    are optional; ``model=None`` boots an app with nothing to serve,
    whose scoring requests answer 503 until the first swap."""

    def __init__(self, model, model_date=None, predictor=None,
                 model_key: str | None = None, model_source: str | None = None,
                 model_bounds=None, batcher=None, admission=None,
                 metrics_dir: str | None = None):
        #: the shared snapshot directory of a multi-process service, or
        #: None (``/metrics`` then renders this process's registry)
        self.metrics_dir = metrics_dir
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
        #: why the service is degraded (serving its last-good model after a
        #: failed reload), or None; /healthz carries it
        self._degraded_reason: str | None = None
        #: the live canary bundle and its routing knobs (``serve.reload``
        #: syncs them from the alias document); one attribute each, read
        #: once per request
        self._canary: _Served | None = None
        self._canary_fraction = 0.0
        self._canary_seed = 0
        #: the SLO watchdog's latest evaluation (``ops.slo`` publishes it)
        self.slo_state: dict | None = None
        #: the online tune controller's latest state (``tune.online``
        #: publishes it every poll), and the controller itself where
        #: ``serve --online-tune`` armed one (drills inject through its
        #: ``apply_tuned``)
        self.tune_state: dict | None = None
        self.tune_controller = None
        #: doc_digest of the applied tuned serving config
        #: (``tune.config.resolve_serving_knobs``; the serving wiring and
        #: the online controller set it), None on hand-set or built-in knobs
        self.tuned_config_digest: str | None = None
        self._plan_getter = None  # the chaos plan's resolver, looked up once
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
            buckets=FAST_PHASE_BUCKETS,
        )
        self._m_dispatch = reg.histogram(
            "bodywork_tpu_device_dispatch_seconds",
            "Device-dispatch phase: one padded predictor call",
        )
        self._m_serialize = reg.histogram(
            "bodywork_tpu_response_serialize_seconds",
            "Serialization phase: prediction -> JSON response",
            buckets=FAST_PHASE_BUCKETS,
        )
        self._m_swaps = reg.counter(
            "bodywork_tpu_model_hot_swaps_total",
            "Served-model hot swaps (serve.reload checkpoint watcher)",
        )
        self._m_fallbacks = reg.counter(
            "bodywork_tpu_coalescer_fallback_total",
            "Requests degraded to a direct dispatch (coalescer saturated)",
        )
        # per-stream accounting, written only while a canary is live: the
        # SLO watchdog reads it
        self._m_stream_requests = reg.counter(
            "bodywork_tpu_serve_model_requests_total",
            "Scoring requests routed per served model while a canary is "
            "live, by model_key and stream (production|canary)",
        )
        self._m_stream_errors = reg.counter(
            "bodywork_tpu_serve_model_errors_total",
            "Scoring requests that errored per served model while a "
            "canary is live, by model_key and stream",
        )
        self._m_stream_latency = reg.histogram(
            "bodywork_tpu_serve_model_latency_seconds",
            "Scoring latency per served model while a canary is live, "
            "by model_key and stream — the SLO watchdog's p99 source",
        )
        self._m_sanity = reg.counter(
            "bodywork_tpu_serve_sanity_violations_total",
            "Predictions caught by the sanity firewall before "
            "serialization, by model_key, stream, and reason "
            "(non_finite|out_of_range)",
        )
        self._g_degraded = reg.gauge(
            "bodywork_tpu_serve_degraded_state",
            "Serving degradation: 0=healthy, 1=serving last-good model "
            "after a failed reload, 2=no model loaded",
            aggregate="max",
        )
        self._g_degraded.set(2.0 if self.served is None else 0.0)
        self._g_model_version = reg.gauge(
            "bodywork_tpu_serve_model_version_info",
            "Served model version: 1 on the (model_key, source) sample "
            "currently serving, 0 on superseded ones",
            aggregate="max",
        )
        self._model_version_labels: dict | None = None
        self._record_model_version()
        self._routes = {
            ("POST", "/score/v1"): self.score_data_instance,
            ("POST", "/score/v1/batch"): self.score_batch,
            ("GET", "/healthz"): self.healthz,
            ("GET", "/metrics"): self.metrics_endpoint,
        }

    def _record_model_version(self) -> None:
        """The info gauge: 1 on the served (model_key, source), 0 on the
        sample it replaced."""
        served = self.served
        if served is None or served.model_key is None:
            return
        labels = {"model_key": served.model_key, "source": served.source or "unspecified"}
        old = self._model_version_labels
        if old is not None and old != labels:
            self._g_model_version.set(0.0, **old)
        self._g_model_version.set(1.0, **labels)
        self._model_version_labels = labels

    @property
    def predictor(self):
        served = self.served
        return None if served is None else served.predictor

    @property
    def model_date(self) -> str | None:
        served = self.served
        return None if served is None else served.model_date

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

    # -- hot swaps and the degraded channel (serve.reload drives them) -----
    def set_degraded(self, reason: str) -> None:
        """Flag the service as serving its last-good model (a reload
        failed). It keeps answering; /healthz and the gauge say so."""
        self._degraded_reason = reason
        if self.served is not None:
            self._g_degraded.set(1.0)

    def clear_degraded(self) -> None:
        self._degraded_reason = None
        self._g_degraded.set(0.0 if self.served is not None else 2.0)

    def _warm_predictor_for(self, model, canary: bool = False):
        """A warmed predictor for ``model`` on the served predictor's
        engine and buckets (a same-architecture checkpoint rebinds the
        captured graphs and captures nothing), in production's weight-slot
        lane, or for a ``canary`` in the other one."""
        from bodywork_tpu_torch.serve.predictor import PaddedPredictor, use_serving_lane
        from bodywork_tpu_torch.serve.server import build_predictor

        old = self.served
        if old is None or not hasattr(old.predictor, "engine"):
            predictor = PaddedPredictor(model)
        else:
            predictor = build_predictor(model, old.predictor.engine,
                                        buckets=old.predictor.buckets)
        use_serving_lane(predictor, old.predictor if old is not None else None, canary)
        predictor.warmup()
        return predictor

    def swap_model(self, model, model_date=None, predictor=None,
                   model_key: str | None = None, model_source: str | None = None,
                   model_bounds=None) -> None:
        """Replace the served model (hot reload). ``predictor`` is warmed
        by the caller off the request path (``serve.reload`` does); a
        predictor built here is warmed before the pointer publishes. The
        coalescer is drained after the swap, the swap counted, and the
        degraded flag cleared (a model-less app goes live)."""
        if predictor is None:
            predictor = self._warm_predictor_for(model)
        self.served = _Served(
            predictor, model.info, str(model_date) if model_date else None,
            model_key=model_key, source=model_source, bounds=as_bounds(model_bounds),
        )
        self._record_model_version()
        if self.batcher is not None and not self.batcher.drain():
            # queued rows still score on their own bundle; the prompt
            # flush did not hold, which a wedged dispatcher would hide
            log.warning("hot-swap proceeded before the request coalescer "
                        "fully drained; old-model rows may still be in flight")
        self._m_swaps.inc()
        self.clear_degraded()
        log.info(f"hot-swapped served model -> {model.info} ({model_date})")

    # -- canary routing -----------------------------------------------------
    @property
    def canary_key(self) -> str | None:
        canary = self._canary
        return None if canary is None else canary.model_key

    @property
    def canary_fraction(self) -> float:
        return self._canary_fraction if self._canary is not None else 0.0

    def set_canary(self, model, model_date=None, predictor=None,
                   model_key: str | None = None, fraction: float = 0.1,
                   seed: int = 0, bounds=None) -> None:
        """Install (or replace) the canary bundle: ``fraction`` of the
        scoring traffic routes to it by :func:`routes_to_canary`. Its
        predictor is warm before it publishes, as for a swap."""
        if predictor is None:
            predictor = self._warm_predictor_for(model, canary=True)
        old = self._canary
        self._canary_fraction = float(fraction)
        self._canary_seed = int(seed)
        self._canary = _Served(
            predictor, model.info, str(model_date) if model_date else None,
            model_key=model_key, source="canary", bounds=as_bounds(bounds),
        )
        if old is not None and old.model_key and old.model_key != model_key:
            self._g_model_version.set(0.0, model_key=old.model_key, source="canary")
        if model_key:
            self._g_model_version.set(1.0, model_key=model_key, source="canary")
        log.info(f"canary live: {model.info} ({model_key}) at fraction {fraction} "
                 f"(seed {seed})")

    def clear_canary(self) -> None:
        """Stop routing to the canary; a request that already read its
        bundle finishes on it."""
        old = self._canary
        self._canary = None
        self._canary_fraction = 0.0
        if old is not None:
            if old.model_key:
                self._g_model_version.set(0.0, model_key=old.model_key, source="canary")
            log.info(f"canary cleared: {old.model_key}")

    def promote_canary_bundle(self) -> None:
        """The warm canary bundle becomes production in-process (the
        watchdog's healthy-window action, after its alias CAS)."""
        bundle = self._canary
        if bundle is None:
            return
        self.clear_canary()
        self.served = _Served(
            bundle.predictor, bundle.model_info, bundle.model_date,
            model_key=bundle.model_key, source="production", bounds=bundle.bounds,
        )
        self._record_model_version()
        if self.batcher is not None and not self.batcher.drain():
            log.warning("canary promotion proceeded before the request coalescer "
                        "fully drained; old-model rows may still be in flight")
        self._m_swaps.inc()
        self.clear_degraded()
        log.info(f"canary promoted in-process -> {bundle.model_info} ({bundle.model_key})")

    def route_stream(self, X):
        """The ``(bundle, "production"|"canary")`` a request's features
        route to, from one read of each pointer."""
        served = self.served
        canary = self._canary
        if canary is None or served is None:
            return served, "production"
        if routes_to_canary(self._canary_seed, self._canary_fraction, X):
            return canary, "canary"
        return served, "production"

    def stream_metrics_active(self) -> bool:
        """Whether per-stream accounting is on (a canary is live): the
        check a scoring path makes before paying labelled metric writes."""
        return self._canary is not None

    def count_stream_request(self, served, stream: str) -> None:
        """Count one request on ``stream`` (the dispatcher's accounting,
        where the request's latency belongs to its front end)."""
        self._m_stream_requests.inc(model_key=served.model_key or "unknown",
                                    stream=stream)

    def sanity_reason(self, served, predictions) -> str | None:
        """The firewall's cheap precheck of ``served``'s predictions."""
        return sanity_violation(predictions, served.bounds)

    @contextlib.contextmanager
    def stream_accounting(self, served, stream: str, trace=None):
        """The per-stream accounting of one scoring request routed to
        ``served`` on ``stream``, kept only while a canary is live: the
        request counted on entry, an error on an exception, the latency
        (with a sampled ``trace``'s id as exemplar) on a clean exit. Both
        front ends score inside it."""
        if self._canary is None:
            yield
            return
        labels = {"model_key": served.model_key or "unknown", "stream": stream}
        t0 = time.perf_counter()
        self._m_stream_requests.inc(**labels)
        try:
            yield
        except Exception:
            self._m_stream_errors.inc(**labels)
            raise
        self._m_stream_latency.observe(time.perf_counter() - t0,
                                       exemplar=trace.trace_id if trace is not None else None,
                                       **labels)

    def canary_chaos_delay(self, stream: str) -> float | None:
        """The active fault plan's latency for the canary stream
        (``FaultPlan.canary_latency_delay``), or None; production
        requests never consult the plan."""
        if stream != "canary":
            return None
        if self._plan_getter is None:
            from bodywork_tpu_torch.chaos.plan import get_active_plan

            self._plan_getter = get_active_plan
        plan = self._plan_getter()
        if plan is None:
            return None
        canary = self._canary
        return plan.canary_latency_delay(canary.model_key if canary is not None else "unknown")

    def apply_canary_chaos(self, stream: str) -> None:
        delay = self.canary_chaos_delay(stream)
        if delay is not None:
            time.sleep(delay)

    # -- the request path -----------------------------------------------
    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None, traceparent: str | None = None):
        """One request -> ``(status, headers, body)``. Admission runs first
        for a scoring POST, before anything that costs per-request work: a
        shed leaves nothing behind but its counter (and, for a request
        that arrived with a valid ``traceparent``, its trace). A scoring
        POST's trace id is minted from the body only once admitted."""
        path = path.split("?", 1)[0]
        t0 = time.perf_counter()
        scoring_post = method == "POST" and path in SCORING_ROUTES
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
                    response = with_trace_id(response, trace)
                self._m_requests.inc(route=path, status=str(response[0]))
                return response
            admitted = True
        if traced and trace is None:
            trace = tracer.begin(None, body)
        try:
            handler = self._routes.get((method, path))
            if handler is None:
                if self.known_path(path):
                    response = json_response({"error": METHOD_NOT_ALLOWED}, 405)
                else:
                    response = json_response({"error": NOT_FOUND}, 404)
            else:
                response = handler(body, content_type, trace)
        except Exception as exc:  # don't leak tracebacks to clients
            log.error(f"unhandled error serving {path}: {exc!r}")
            response = json_response({"error": "internal server error"}, 500)
        finally:
            if admitted:
                # admission -> response ready: the EWMA behind Retry-After
                admission.release(time.perf_counter() - t0)
        status = response[0]
        route = path if self.known_path(path) else "unknown"
        self._m_requests.inc(route=route, status=str(status))
        if path in SCORING_ROUTES and status == 200:
            # a sampled request leaves its trace id as the bucket's exemplar
            self._m_latency.observe(
                time.perf_counter() - t0,
                exemplar=trace.trace_id if trace is not None and trace.sampled else None,
            )
        if trace is not None:
            tracer.finish(trace, route, status)
            response = with_trace_id(response, trace)
        return response

    # -- parsing and backpressure ------------------------------------------
    def parse_rows(self, body: bytes, content_type: str | None,
                   json_by_default: bool = False):
        """A scoring body as ``(X, None)`` or ``(None, message)``: the
        binary row framing by its content type, else JSON — only under a
        JSON content type, or under any with ``json_by_default`` (the
        ``aio`` engine's rule, as the JAX package's)."""
        if (content_type or "").split(";", 1)[0].strip().lower() == BINARY_CONTENT_TYPE:
            return parse_binary_rows(body)
        payload = None
        if json_by_default or _is_json(content_type):
            try:
                payload = json.loads(body)
            except ValueError:
                payload = None
        return parse_features(payload)

    def _parse(self, body: bytes, content_type: str | None, trace=None):
        t0 = time.perf_counter()
        X, message = self.parse_rows(body, content_type)
        t1 = time.perf_counter()
        self._m_parse.observe(t1 - t0)
        if trace is not None and trace.sampled:
            trace.add("parse", t0, t1)
        if message is not None:
            return None, json_response({"error": message}, 400)
        return X, None

    def retry_after_s(self) -> int:
        """The one Retry-After every backpressure answer of this app
        carries: admission's clamped EWMA, else :data:`RETRY_AFTER_S`."""
        if self.admission is not None:
            return self.admission.retry_after_s()
        return RETRY_AFTER_S

    def shed_response(self):
        """The admission-shed 429."""
        return json_response({"error": "server over capacity; request shed"}, 429,
                              {"Retry-After": str(self.retry_after_s())})

    def _no_model_response(self):
        return json_response({"error": "no model loaded yet; retry shortly"}, 503,
                              {"Retry-After": str(self.retry_after_s())})

    def _traced_dispatch(self, served: _Served, X, trace=None):
        """One direct (uncoalesced) padded dispatch on the calling thread
        (the ``thread`` engine's), timed. For a sampled ``trace`` its
        ``device-dispatch`` span is the active span on that thread, so the
        graph cache's seam can annotate it. The span ends when ``predict``
        returns, after the copy of the results to the host, which waits
        for the card; a replay alone returns at once."""
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

    # -- routes ------------------------------------------------------------
    def score_data_instance(self, body: bytes, content_type: str | None, trace=None):
        """Single-instance scoring; reference-parity contract
        (``stage_2:73-80``)."""
        X, err = self._parse(body, content_type, trace)
        if err is not None:
            # a malformed request gets its 400 even from a model-less app
            return err
        served, stream = self.route_stream(X)
        if served is None:
            return self._no_model_response()
        sampled = trace is not None and trace.sampled
        if sampled:
            trace.annotate(stream=stream, routed_model_key=served.model_key)
        X = np.array(X, ndmin=2)  # scalar -> (1, 1), as the reference
        # the stream metrics stay with the routed bundle: a fallen-back
        # canary request still cost its caller the canary
        with self.stream_accounting(served, stream, trace if sampled else None):
            self.apply_canary_chaos(stream)
            prediction0 = None
            if self.batcher is not None and X.shape[0] == 1:
                try:
                    # the submission carries ITS bundle: its batch is scored
                    # by one model only; the coalescer records the
                    # queue-wait and device-dispatch spans
                    prediction0 = self.batcher.submit(served, X[0],
                                                      trace=trace if sampled else None)
                except CoalescerSaturated:
                    self._m_fallbacks.inc()  # overload or shutdown: go direct
            if prediction0 is None:
                predictions = self._traced_dispatch(served, X, trace if sampled else None)
                prediction0 = float(np.asarray(predictions).ravel()[0])
            reason = sanity_violation(prediction0, served.bounds)
            if reason is not None:
                served, fallback = self.firewall(served, stream, X, prediction0, reason,
                                                 trace=trace)
                prediction0 = float(np.asarray(fallback).ravel()[0])
            return self.render(served, "single", prediction0, trace)

    def score_batch(self, body: bytes, content_type: str | None, trace=None):
        """Batched scoring: one padded device call per bucket-size chunk."""
        X, err = self._parse(body, content_type, trace)
        if err is not None:
            return err
        served, stream = self.route_stream(X)  # the whole batch, one stream
        if served is None:
            return self._no_model_response()
        sampled = trace is not None and trace.sampled
        if sampled:
            trace.annotate(stream=stream, routed_model_key=served.model_key,
                           rows=int(np.atleast_1d(X).shape[0]))
        if X.ndim == 0:
            X = X[None]
        with self.stream_accounting(served, stream, trace if sampled else None):
            self.apply_canary_chaos(stream)
            predictions = self._traced_dispatch(served, X, trace if sampled else None)
            reason = sanity_violation(predictions, served.bounds)
            if reason is not None:
                served, predictions = self.firewall(served, stream, X, predictions, reason,
                                                    trace=trace)
            return self.render(served, "batch", predictions, trace)

    def render(self, served: _Served, kind: str, predictions, trace=None):
        """The 200 response from ``served``'s ``kind`` (``single`` or
        ``batch``) template, timed, with its ``serialize`` span for a
        sampled ``trace``, and the answering model's key header."""
        template = served.single_template if kind == "single" else served.batch_template
        t0 = time.perf_counter()
        payload = template.render(predictions)
        t1 = time.perf_counter()
        self._m_serialize.observe(t1 - t0)
        if trace is not None and trace.sampled:
            trace.add("serialize", t0, t1)
        headers = dict(JSON_HEADERS)
        if served.model_key:
            headers[MODEL_KEY_HEADER] = served.model_key
        return 200, headers, payload

    def firewall(self, served: _Served, stream: str, X, predictions, reason: str,
                 trace=None):
        """The prediction-sanity firewall after a violation: a canary's
        is answered from production (re-predicted under a
        ``firewall-fallback`` span for a sampled ``trace``); a production
        non-finite prediction raises :class:`PredictionSanityError` (500);
        a production prediction outside the band is logged and served.
        Every violation counts into
        ``bodywork_tpu_serve_sanity_violations_total``. Returns the
        answering ``(bundle, predictions)``."""
        self._m_sanity.inc(model_key=served.model_key or "unknown", stream=stream,
                           reason=reason)
        if stream == "canary":
            production = self.served
            log.warning(f"canary prediction sanity violation ({reason}) on "
                        f"{served.model_key}; answering from production")
            t0 = time.perf_counter()
            fallback = production.predictor.predict(X)
            t1 = time.perf_counter()
            self._m_dispatch.observe(t1 - t0)
            if trace is not None and trace.sampled:
                trace.add("firewall-fallback", t0, t1, reason=reason,
                          violating_model_key=served.model_key,
                          answered_by=production.model_key)
            if sanity_violation(fallback, None) is not None:
                # production's own answer is non-finite: nothing sane to send
                self._m_sanity.inc(model_key=production.model_key or "unknown",
                                   stream="production", reason="non_finite")
                raise PredictionSanityError("non_finite")
            return production, fallback
        if reason == "non_finite":
            log.error(f"production prediction non-finite on {served.model_key}; "
                      "refusing to serialize")
            raise PredictionSanityError(reason)
        log.warning(f"production prediction out of sanity band on "
                    f"{served.model_key} (served anyway; band is statistical)")
        return served, predictions

    def effective_config(self) -> dict:
        """The knob values live in this process, read from the live
        objects (coalescer, admission controller, predictor), and the
        applied tuned config's digest (None: hand-set or built-in)."""
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
            "tuned_config": self.tuned_config_digest,
        }

    def healthz_response(self) -> tuple[dict, int, int | None]:
        """``(payload, status, retry_after_s or None)``: the health document
        both front ends serve. The keys are the JAX app's, in its order
        (``mesh``: the serving mesh's shape, null single-device), then the port's
        ``engine``, ``device``, ``launches`` (of the serving kernel since
        the counts were last reset; null for a plain engine) and
        ``graph_cache``."""
        from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
        from bodywork_tpu_torch.serve.predictor import GRAPH_CACHE

        served = self.served
        admission = self.admission
        if admission is not None:
            queue_depth = admission.queue_depth
            admission_state = admission.state()
        else:
            queue_depth = self.batcher.pending_depth() if self.batcher is not None else 0
            admission_state = None
        canary = self._canary
        common = {
            "canary_key": canary.model_key if canary is not None else None,
            "canary_fraction": self._canary_fraction if canary is not None else None,
            "watchdog": self.slo_state, "tuning": self.tune_state,
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
        reason = self._degraded_reason
        payload = {
            "status": "ok",
            "model_info": served.model_info,
            "model_date": served.model_date,
            "model_key": served.model_key,
            "model_source": served.source,
            "serving_dtype": getattr(predictor, "dtype", "float32"),
            "mesh": _predictor_mesh(predictor), **common,
            "degraded": reason is not None,
            "queue_depth": queue_depth,
            "admission": admission_state,
            "effective_config": self.effective_config(),
            "latency_exemplars": self._m_latency.exemplars() or None,
        }
        if reason is not None:
            payload["reason"] = reason
        payload.update({
            "engine": engine,
            "device": predictor.device.type,
            "launches": LAUNCHES.get(engine),
            "graph_cache": GRAPH_CACHE.stats(),
        })
        return payload, 200, None

    def healthz_payload(self) -> dict:
        return self.healthz_response()[0]

    def healthz(self, body: bytes, content_type: str | None, trace=None):
        payload, status, retry_after = self.healthz_response()
        headers = {"Retry-After": str(retry_after)} if retry_after is not None else None
        return json_response(payload, status, headers)

    def metrics_endpoint(self, body: bytes, content_type: str | None, trace=None):
        """This process's registry in the Prometheus text format, merged
        with its sibling workers' flushed snapshots when ``metrics_dir``
        is set (``serve --workers N --metrics``)."""
        return (200, {"Content-Type": METRICS_CONTENT_TYPE}, self.metrics_text().encode())

    def metrics_text(self) -> str:
        if self.metrics_dir is None:
            return get_registry().render()
        from bodywork_tpu_torch.obs.multiproc import aggregated_render

        return aggregated_render(get_registry(), self.metrics_dir)

    def close(self) -> None:
        """Stop the coalescer's dispatcher after flushing what it holds.
        Idempotent; the app still serves afterwards, uncoalesced."""
        if self.batcher is not None:
            self.batcher.stop()


def create_app(model, model_date=None, predictor=None, warmup: bool = True,
               batch_window_ms: float | None = None, batch_max_rows: int | None = None,
               model_key: str | None = None, model_source: str | None = None,
               admission=None, model_bounds=None,
               metrics_dir: str | None = None) -> ScoringApp:
    """A :class:`ScoringApp`, warmed. ``batch_window_ms`` > 0 opts into
    cross-request micro-batching (``serve.batcher``), flushed when
    ``batch_max_rows`` accumulate or the window elapses, whichever first.
    ``admission`` (``serve.admission.AdmissionController``) opts into load
    shedding; replica apps of one listener share one controller.
    ``metrics_dir`` points ``GET /metrics`` at a multi-process service's
    shared snapshot directory."""
    batcher = None
    if batch_window_ms and batch_window_ms > 0:
        from bodywork_tpu_torch.serve.batcher import DEFAULT_MAX_ROWS, RequestCoalescer

        batcher = RequestCoalescer(
            window_ms=batch_window_ms, max_rows=batch_max_rows or DEFAULT_MAX_ROWS,
        ).start()
    app = ScoringApp(model, model_date, predictor=predictor, model_key=model_key,
                     model_source=model_source, model_bounds=model_bounds,
                     batcher=batcher, admission=admission, metrics_dir=metrics_dir)
    if warmup and app.predictor is not None:
        app.predictor.warmup()
    return app
