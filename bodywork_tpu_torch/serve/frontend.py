"""The disaggregated serving front end: parse + admission, no model (the
port of ``bodywork_tpu.serve.frontend``, on the port's own HTTP layer).

``serve --frontends N`` splits the serving plane that ``--workers N``
replicates: N of THESE processes own the HTTP socket (SO_REUSEPORT) and
do request parse, feature validation, and admission, while exactly one
dispatcher process (``serve.dispatch``) owns the predictor, the CUDA
graphs, the canary bundles, and the request coalescer. The two halves
meet over the shared-memory row-queue (``serve.rowqueue``) or the socket
row-queue (``serve.netqueue``): a front end writes a request's rows once
and enqueues a descriptor; the dispatcher reads them, scores, and replies
with predictions plus the answering bundle's identity.

What a front-end process deliberately does NOT have: torch (a guard test
pins that importing this module never imports it), a CUDA context, a
model, a coalescer. What it keeps, unchanged from the in-process engines:

- **Admission-shed-BEFORE-parse.** The :class:`~bodywork_tpu_torch.serve.
  admission.AdmissionController` (with its cross-process
  ``SharedBudgetSlot`` budget) runs first, upstream of body parse — a
  shed request never touches the row-queue (``rows_submitted`` stays
  untouched; a regression test pins it).
- **Byte-identical responses.** Success bodies are rendered from the
  reply's bundle identity through the same ``serve.wire`` templates;
  error bodies reuse the in-process strings.
- **Degrade, never wedge.** A dead dispatcher turns scoring into
  503 + Retry-After (``/healthz`` flips 503 so probes see it) the
  moment the supervisor observes the death; in-flight waits are failed
  by the row-queue epoch bump. The supervisor's respawn flips it back —
  front ends hold no dispatcher state beyond the shared handles, so
  healing requires nothing from them.

:meth:`FrontendApp.handle` serves the thread engine
(``serve.httpcore``); the ``aio`` engine drives the transport-agnostic
core (``parse_rows`` / ``submit`` / ``render_reply`` and the canned
backpressure parts) from its event loop.
"""
from __future__ import annotations

import json
import threading
import time

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.obs.tracing import get_tracer, parse_traceparent
from bodywork_tpu_torch.serve.admission import count_shed
from bodywork_tpu_torch.serve.httpcore import (
    FAST_PHASE_BUCKETS,
    METHOD_NOT_ALLOWED,
    METRICS_CONTENT_TYPE,
    NOT_FOUND,
    RETRY_AFTER_S,
    SCORING_ROUTES,
    LocalClient,
    json_response,
    with_trace_id,
)
from bodywork_tpu_torch.serve.rowqueue import (
    KIND_BATCH,
    KIND_SINGLE,
    DispatcherUnavailable,
    SlotsExhausted,
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

log = get_logger("serve.frontend")

__all__ = ["FrontendApp"]

#: ceiling on one row-queue rendezvous — mirrors the coalescer's
#: COALESCE_TIMEOUT_S; the epoch-bump failure path makes hitting it
#: near-impossible (a dead dispatcher fails waits in <1s)
DISPATCH_TIMEOUT_S = 60.0


class FrontendApp:
    """The front end over a :class:`~bodywork_tpu_torch.serve.rowqueue.
    RowQueueClient` (or a ``netqueue.NetQueueClient``). Route set,
    admission placement, metrics names, and response bytes all mirror
    :class:`~bodywork_tpu_torch.serve.app.ScoringApp`; the scoring
    handlers enqueue instead of predict."""

    #: how serve.aio tells a front-end app from a scoring app without
    #: importing either
    is_frontend = True

    def __init__(self, client, admission=None, metrics_dir=None):
        self.client = client
        self.admission = admission
        self.metrics_dir = metrics_dir
        self.tracer = get_tracer()
        reg = get_registry()
        # same metric families as ScoringApp: dashboards see one request
        # stream regardless of the serving topology
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
        self._m_serialize = reg.histogram(
            "bodywork_tpu_response_serialize_seconds",
            "Serialization phase: prediction -> JSON response",
            buckets=FAST_PHASE_BUCKETS,
        )
        # templates per answering-bundle identity: the dispatcher names
        # the bundle in each reply; invalidation is structural (a hot
        # swap changes the identity, hence the key)
        self._templates: dict = {}
        self._templates_lock = threading.Lock()
        self._routes = {
            ("POST", "/score/v1"): self.score_single,
            ("POST", "/score/v1/batch"): self.score_batch,
            ("GET", "/healthz"): self.healthz,
            ("GET", "/metrics"): self.metrics_endpoint,
        }

    # -- transport-agnostic core (shared with the aio engine) --------------
    def retry_after_s(self) -> int:
        if self.admission is not None:
            return self.admission.retry_after_s()
        return RETRY_AFTER_S

    def parse_rows(self, body: bytes, content_type: str | None):
        """Decode a scoring request body — JSON ``{"X": [...]}`` or the
        binary row framing, selected by content type — into ``(X,
        error_message)``. Same helpers, hence same arrays and same 400
        strings, as the in-process engines."""
        mimetype = (content_type or "").split(";", 1)[0].strip().lower()
        if mimetype == BINARY_CONTENT_TYPE:
            return parse_binary_rows(body)
        try:
            payload = json.loads(body) if body else None
        except ValueError:
            payload = None
        return parse_features(payload)

    def submit(self, X, single: bool, on_done, trace_id=None) -> None:
        """Enqueue one parsed request; raises
        :class:`DispatcherUnavailable` / :class:`SlotsExhausted` when
        nothing was enqueued (the caller maps them to 503/429)."""
        self.client.submit(
            X, KIND_SINGLE if single else KIND_BATCH, on_done,
            trace_id=trace_id,
        )

    def _template_for(self, reply, single: bool):
        key = (reply.model_info, reply.model_date, single)
        template = self._templates.get(key)
        if template is None:
            cls = SingleResponseTemplate if single else BatchResponseTemplate
            with self._templates_lock:
                template = self._templates.setdefault(
                    key, cls(reply.model_info, reply.model_date),
                )
        return template

    def render_reply(self, reply, single: bool):
        """A dispatcher reply -> ``(status, body_bytes, extra_headers)``,
        byte-identical to the in-process response for the same request:
        the same template splice, the same error strings and Retry-After
        placement."""
        if reply.status == 200:
            t0 = time.perf_counter()
            if single:
                body = self._template_for(reply, True).render(
                    float(reply.predictions[0])
                )
            else:
                body = self._template_for(reply, False).render(
                    reply.predictions
                )
            self._m_serialize.observe(time.perf_counter() - t0)
            extra = (
                ((MODEL_KEY_HEADER, reply.model_key),)
                if reply.model_key else ()
            )
            return 200, body, extra
        if reply.status == 503:
            return (
                503,
                json.dumps(
                    {"error": "no model loaded yet; retry shortly"}
                ).encode(),
                (("Retry-After", str(self.retry_after_s())),),
            )
        return (
            500,
            json.dumps({"error": "internal server error"}).encode(),
            (),
        )

    def unavailable_parts(self):
        """The dead-dispatcher 503: honest about WHY (distinct from the
        no-model-yet 503 — an operator must tell "still warming" from
        "the singleton died"), still retryable."""
        return (
            503,
            json.dumps(
                {"error": "scoring dispatcher unavailable; retry shortly"}
            ).encode(),
            (("Retry-After", str(self.retry_after_s())),),
        )

    def shed_parts(self):
        return (
            429,
            json.dumps(
                {"error": "server over capacity; request shed"}
            ).encode(),
            (("Retry-After", str(self.retry_after_s())),),
        )

    def healthz_response(self):
        """``(payload, status, retry_after_s-or-None)``: 503 while the
        dispatcher is down — a front end that cannot score must leave
        the endpoints so load concentrates on healthy pods (unlike the
        in-process degraded-but-serving 200). The JAX front end's
        ``healthz_payload``."""
        stats = self.client.stats()
        admission = self.admission
        payload = {
            "status": "ok" if stats["dispatcher_up"]
            else "scoring dispatcher unavailable",
            "role": "frontend",
            "dispatcher_up": stats["dispatcher_up"],
            "queue_depth": (
                admission.queue_depth if admission is not None
                else stats["in_flight"]
            ),
            "admission": admission.state() if admission is not None else None,
            "rowqueue": stats,
            # which transport the handoff rides and how it is doing:
            # kind/connected/reconnects/credit window, one schema for
            # shm and socket clients
            "transport": (
                self.client.transport_state()
                if hasattr(self.client, "transport_state") else None
            ),
        }
        if stats["dispatcher_up"]:
            return payload, 200, None
        return payload, 503, self.retry_after_s()

    def healthz_payload(self) -> dict:
        return self.healthz_response()[0]

    def metrics_text(self) -> str:
        """One coherent service-wide scrape regardless of which process
        answers: this front end's live registry merged with every
        sibling's (and the dispatcher's) flushed snapshots — which is
        how dispatcher-side coalescer metrics stay visible from any
        front end."""
        from bodywork_tpu_torch.obs.multiproc import aggregated_render

        return aggregated_render(get_registry(), self.metrics_dir)

    # -- the thread engine's request path (mirrors ScoringApp.handle) ------
    def handle(self, method: str, path: str, body: bytes = b"",
               content_type: str | None = None, traceparent: str | None = None):
        """One request -> ``(status, headers, body)``. Admission runs
        first for a scoring POST: a shed request leaves zero footprint —
        no parse and (the split's own invariant) no row-queue slot."""
        path = path.split("?", 1)[0]
        t0 = time.perf_counter()
        scoring_post = method == "POST" and path in SCORING_ROUTES
        tracer = self.tracer
        traced = scoring_post and tracer.enabled
        trace = None
        if traced and traceparent is not None and (
            parse_traceparent(traceparent) is not None
        ):
            trace = tracer.begin(traceparent, b"")
        admission = self.admission
        admitted = False
        if admission is not None and scoring_post:
            if not admission.try_admit():
                response = self._respond(*self.shed_parts())
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
        try:
            if traced and trace is None:
                trace = tracer.begin(None, body)
            handler = self._routes.get((method, path))
            if handler is None:
                if self._known_path(path):
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
                admission.release(time.perf_counter() - t0)
        status = response[0]
        route = path if self._known_path(path) else "unknown"
        self._m_requests.inc(route=route, status=str(status))
        if path in SCORING_ROUTES and status == 200:
            self._m_latency.observe(
                time.perf_counter() - t0,
                exemplar=(
                    trace.trace_id
                    if trace is not None and trace.sampled else None
                ),
            )
        if trace is not None:
            tracer.finish(trace, route, status)
            response = with_trace_id(response, trace)
        return response

    def _known_path(self, path: str) -> bool:
        return any(p == path for _m, p in self._routes)

    # -- routes ------------------------------------------------------------
    def score_single(self, body: bytes, content_type: str | None, trace=None):
        return self._score(body, content_type, trace, single=True)

    def score_batch(self, body: bytes, content_type: str | None, trace=None):
        return self._score(body, content_type, trace, single=False)

    def _score(self, body: bytes, content_type: str | None, trace, single: bool):
        sampled = trace is not None and trace.sampled
        t0 = time.perf_counter()
        X, message = self.parse_rows(body, content_type)
        t1 = time.perf_counter()
        self._m_parse.observe(t1 - t0)
        if sampled:
            trace.add("parse", t0, t1)
        if message is not None:
            return json_response({"error": message}, 400)
        done = threading.Event()
        box: list = [None]

        def on_done(outcome) -> None:
            box[0] = outcome
            done.set()

        t_submit = time.perf_counter()
        try:
            self.submit(
                X, single, on_done,
                trace_id=trace.trace_id if sampled else None,
            )
        except DispatcherUnavailable:
            return self._respond(*self.unavailable_parts())
        except SlotsExhausted:
            # queue backpressure sheds exactly like a budget refusal
            count_shed("rowqueue")
            return self._respond(*self.shed_parts())
        if not done.wait(DISPATCH_TIMEOUT_S):
            # slot reclamation belongs to the reader/epoch machinery —
            # never free here, or a late reply could tear a reused slot
            log.error("row-queue rendezvous timed out")
            return json_response({"error": "internal server error"}, 500)
        outcome = box[0]
        if sampled:
            trace.add("rowqueue", t_submit, time.perf_counter())
        if isinstance(outcome, Exception):
            # the dispatcher died mid-request: degraded, not wedged
            return self._respond(*self.unavailable_parts())
        return self._respond(*self.render_reply(outcome, single))

    @staticmethod
    def _respond(status: int, body: bytes, extra):
        return status, {"Content-Type": "application/json", **dict(extra)}, body

    def healthz(self, body: bytes, content_type: str | None, trace=None):
        payload, status, retry_after = self.healthz_response()
        headers = {"Retry-After": str(retry_after)} if retry_after is not None else None
        return json_response(payload, status, headers)

    def metrics_endpoint(self, body: bytes, content_type: str | None, trace=None):
        return 200, {"Content-Type": METRICS_CONTENT_TYPE}, self.metrics_text().encode()

    def test_client(self) -> LocalClient:
        """An in-process client over :meth:`handle` (``get`` / ``post`` ->
        status, headers and body bytes), as the JAX app's werkzeug one."""
        return LocalClient(self)

    def close(self) -> None:
        """Nothing to flush: the front end holds no coalescer."""
