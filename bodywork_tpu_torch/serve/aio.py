"""Asyncio event-loop front end for the scoring service (the port of
``bodywork_tpu.serve.aio``; the server engine ``aio``).

The thread engine spends one OS thread per connection; under open-loop
arrival-rate load every queued request pins a thread. This front end
serves every connection from one event loop:

- **A hand-written HTTP/1.1 server** over ``asyncio.start_server``
  (standard library only): request line, headers and a Content-Length
  body, keep-alive connections.
- **Admission before work** (``serve.admission``): a scoring request is
  admitted against the pending budget before its body is parsed; a shed
  answers 429 + ``Retry-After`` straight from the loop.
- **The coalescer fed from the loop**: an admitted single-row request
  enqueues with ``submit_nowait`` and an ``on_done`` callback that
  resolves an asyncio future through ``call_soon_threadsafe``, so the
  loop never blocks on a batch. Batch requests and the uncoalesced
  fallback run the padded dispatch on a small thread pool.
- **Byte-identical responses**: bodies come from the same parse and
  response templates as the thread engine's (``serve.app``), and the
  404 and 405 bodies carry werkzeug's descriptions as the JAX engine's
  do, without werkzeug.

:class:`AioServiceHandle` has the thread engine's handle interface
(``start``, ``stop``, ``wait``, ``serve_forever``, ``add_cleanup``,
``url``, ``base_url``). Request tracing is the thread engine's (the same
ids, spans and ``X-Bodywork-Trace-Id`` header; ``serve.app``). Fault-plan
composition, the row-queue front ends and the multi-process ``/metrics``
are later slices.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.obs.tracing import TRACE_ID_HEADER, TRACEPARENT_HEADER, parse_traceparent
from bodywork_tpu_torch.serve.app import (
    _METHOD_NOT_ALLOWED,
    _NOT_FOUND,
    METRICS_CONTENT_TYPE,
)
from bodywork_tpu_torch.serve.batcher import CoalescerSaturated
from bodywork_tpu_torch.serve.wire import MODEL_KEY_HEADER, parse_features
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.aio")

__all__ = ["AioScoringServer", "AioServiceHandle"]

#: request line + headers cap (also the StreamReader limit)
MAX_HEADER_BYTES = 64 * 1024
#: request body cap: two orders of magnitude above a 2048-row batch
MAX_BODY_BYTES = 16 * 1024 * 1024
#: ceiling on a coalesced prediction rendezvous (as ``submit``'s)
COALESCE_TIMEOUT_S = 60.0

_REASONS = {
    200: "OK",
    400: "BAD REQUEST",
    404: "NOT FOUND",
    405: "METHOD NOT ALLOWED",
    408: "REQUEST TIMEOUT",
    411: "LENGTH REQUIRED",
    413: "PAYLOAD TOO LARGE",
    429: "TOO MANY REQUESTS",
    431: "REQUEST HEADER FIELDS TOO LARGE",
    500: "INTERNAL SERVER ERROR",
    503: "SERVICE UNAVAILABLE",
}

_SCORING_ROUTES = ("/score/v1", "/score/v1/batch")


def _error(status: int, message: str, extra=()):
    return status, json.dumps({"error": message}).encode(), "application/json", tuple(extra)


class _BadRequest(Exception):
    """Protocol-level parse failure: answer and close the connection."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class AioScoringServer:
    """The protocol and dispatch core: a callback per connection
    (:meth:`handle_connection`, for ``asyncio.start_server``) serving one
    or more replica :class:`~bodywork_tpu_torch.serve.app.ScoringApp`
    round-robin, sharing their admission controller."""

    def __init__(self, apps, executor_workers: int = 4):
        self.apps = list(apps)
        if not self.apps:
            raise ValueError("need at least one replica app")
        # ONE admission budget for the listener: the apps share theirs
        self.admission = self.apps[0].admission
        #: connections with a request being read, handled or written: the
        #: loop's own queue, which the admission depth probe folds in.
        #: Written on the loop thread only.
        self._busy_connections = 0
        if self.admission is not None:
            self.admission.attach_depth_probe(lambda: self._busy_connections)
        self._rr = itertools.count()
        # device dispatches the loop must not block on (uncoalesced single
        # rows, batch scoring, /metrics renders)
        self._executor = ThreadPoolExecutor(max_workers=executor_workers,
                                            thread_name_prefix="aio-dispatch")

    def close(self) -> None:
        self._executor.shutdown(wait=False)

    def _next_app(self):
        return self.apps[next(self._rr) % len(self.apps)]

    # -- HTTP framing ------------------------------------------------------
    async def _read_request(self, reader):
        """One request off the connection: ``(method, path, headers,
        body)``, or None on a clean EOF between requests."""
        try:
            blob = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as exc:
            if not exc.partial:
                return None  # clean close between keep-alive requests
            raise _BadRequest(400, "truncated request head")
        except asyncio.LimitOverrunError:
            raise _BadRequest(431, "request head too large")
        head = blob.decode("latin-1").split("\r\n")
        try:
            method, target, _version = head[0].split(" ", 2)
        except ValueError:
            raise _BadRequest(400, "malformed request line")
        headers: dict[str, str] = {}
        for line in head[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(400, f"malformed header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        body = b""
        if "transfer-encoding" in headers:
            raise _BadRequest(400, "chunked request bodies not supported")
        if "content-length" in headers:
            try:
                length = int(headers["content-length"])
            except ValueError:
                raise _BadRequest(400, "malformed Content-Length")
            if length < 0:
                raise _BadRequest(400, "malformed Content-Length")
            if length > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            if length:
                try:
                    body = await reader.readexactly(length)
                except asyncio.IncompleteReadError:
                    raise _BadRequest(400, "truncated request body")
        elif method == "POST":
            raise _BadRequest(411, "POST requires Content-Length")
        return method, target.split("?", 1)[0], headers, body

    @staticmethod
    def _encode_response(status: int, body: bytes, content_type: str,
                         extra_headers=(), keep_alive: bool = True) -> bytes:
        lines = [
            f"HTTP/1.1 {status} {_REASONS.get(status, 'UNKNOWN')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        lines += [f"{name}: {value}" for name, value in extra_headers]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body

    async def handle_connection(self, reader, writer) -> None:
        """One keep-alive connection: read, dispatch, write, until the
        peer closes or asks to. A connection counts as busy from accept
        and while a request is in flight; an idle keep-alive connection
        between requests does not."""
        self._busy_connections += 1
        busy = True
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except _BadRequest as exc:
                    status, body, content_type, _ = _error(exc.status, exc.message)
                    writer.write(self._encode_response(status, body, content_type,
                                                       keep_alive=False))
                    await writer.drain()
                    break
                if request is None:
                    break
                if not busy:
                    self._busy_connections += 1
                    busy = True
                method, path, headers, body = request
                status, payload, content_type, extra = await self._dispatch(
                    method, path, headers, body)
                keep_alive = headers.get("connection", "").lower() != "close"
                writer.write(self._encode_response(status, payload, content_type, extra,
                                                   keep_alive))
                await writer.drain()
                if not keep_alive:
                    break
                self._busy_connections -= 1
                busy = False
        except (ConnectionResetError, BrokenPipeError, asyncio.CancelledError):
            pass  # peer went away (or shutdown): nothing to answer
        finally:
            if busy:
                self._busy_connections -= 1
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    # -- dispatch ----------------------------------------------------------
    async def _dispatch(self, method: str, path: str, headers: dict, body: bytes):
        """Route one request: ``(status, body, content_type, extra
        headers)``, with the thread engine's request and latency metrics
        and its request tracing (the same ids, spans and header: one
        request traces the same way on either front end). Before
        admission only an ingress ``traceparent`` creates a trace; an
        admitted request without one mints its id in
        :meth:`_score_common` and publishes it through ``trace_box``."""
        app = self._next_app()
        t0 = time.perf_counter()
        routes = {
            ("POST", "/score/v1"): self._score_single,
            ("POST", "/score/v1/batch"): self._score_batch,
            ("GET", "/healthz"): self._healthz,
            ("GET", "/metrics"): self._metrics,
        }
        known_path = any(p == path for _m, p in routes)
        tracer = app.tracer
        traced = method == "POST" and path in _SCORING_ROUTES and tracer.enabled
        trace_box: list = [None]
        if traced:
            traceparent = headers.get(TRACEPARENT_HEADER)
            if traceparent is not None and parse_traceparent(traceparent) is not None:
                trace_box[0] = tracer.begin(traceparent, b"")
        try:
            handler = routes.get((method, path))
            if handler is None:
                result = (_error(405, _METHOD_NOT_ALLOWED) if known_path
                          else _error(404, _NOT_FOUND))
            else:
                result = await handler(app, body, trace_box if traced else None)
        except Exception as exc:  # don't leak tracebacks to clients
            log.error(f"unhandled error serving {path}: {exc!r}")
            result = _error(500, "internal server error")
        status = result[0]
        route = path if known_path else "unknown"
        app._m_requests.inc(route=route, status=str(status))
        trace = trace_box[0]
        if path in _SCORING_ROUTES and status == 200:
            app._m_latency.observe(
                time.perf_counter() - t0,
                exemplar=trace.trace_id if trace is not None and trace.sampled else None,
            )
        if trace is not None:
            tracer.finish(trace, route, status)
            result = (*result[:3], (*result[3], (TRACE_ID_HEADER, trace.trace_id)))
        return result

    async def _score_common(self, app, body: bytes, score, trace_box=None):
        """The scoring shell: admission, the trace id minted from the body
        once admitted, parse, the no-model 503, then the route's ``score``
        coroutine with the request's trace."""
        trace = trace_box[0] if trace_box is not None else None
        admission = self.admission
        if admission is not None and not admission.try_admit():
            # shed BEFORE parsing: one counter and a small answer
            if trace is not None and trace.sampled:
                now = time.perf_counter()
                trace.add("admission-shed", now, now, queue_depth=admission.queue_depth)
            return _error(429, "server over capacity; request shed",
                          (("Retry-After", str(admission.retry_after_s())),))
        if trace_box is not None and trace is None:
            trace = trace_box[0] = app.tracer.begin(None, body)
        sampled = trace is not None and trace.sampled
        t_admit = time.perf_counter()
        try:
            t0 = time.perf_counter()
            try:
                payload = json.loads(body) if body else None
            except ValueError:
                payload = None
            X, message = parse_features(payload)
            t1 = time.perf_counter()
            app._m_parse.observe(t1 - t0)
            if sampled:
                trace.add("parse", t0, t1)
            if message is not None:
                return _error(400, message)
            served = app.served
            if served is None:
                return _error(503, "no model loaded yet; retry shortly",
                              (("Retry-After", str(app.retry_after_s())),))
            return await score(app, served, X, trace if sampled else None)
        finally:
            if admission is not None:
                admission.release(time.perf_counter() - t_admit)

    async def _predict(self, app, served, X, trace):
        """One direct padded dispatch on the executor: the app's
        ``_traced_dispatch``, which sets the sampled request's dispatch
        span active on the executor's thread (a contextvar does not cross
        ``run_in_executor``)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, app._traced_dispatch, served, X,
                                          trace)

    @staticmethod
    def _render(app, served, render, predictions, trace):
        status, headers, payload = app.render(served, render, predictions, trace)
        extra = ((MODEL_KEY_HEADER, served.model_key),) if served.model_key else ()
        return status, payload, headers["Content-Type"], extra

    async def _score_single(self, app, body: bytes, trace_box=None):
        async def score(app, served, X, trace):
            X = np.array(X, ndmin=2)  # scalar -> (1, 1), as the reference
            if trace is not None:
                trace.annotate(stream="production", routed_model_key=served.model_key)
            loop = asyncio.get_running_loop()
            prediction0 = None
            if app.batcher is not None and X.shape[0] == 1:
                future = loop.create_future()

                def _resolve(sub) -> None:
                    # dispatcher thread -> event loop; the loop may be gone
                    def _set() -> None:
                        if future.cancelled():
                            return
                        if sub.error is not None:
                            future.set_exception(sub.error)
                        else:
                            future.set_result(sub.result)

                    try:
                        loop.call_soon_threadsafe(_set)
                    except RuntimeError:
                        pass

                try:
                    app.batcher.submit_nowait(served, X[0], on_done=_resolve, trace=trace)
                except CoalescerSaturated:
                    app._m_fallbacks.inc()
                else:
                    try:
                        prediction0 = await asyncio.wait_for(future, COALESCE_TIMEOUT_S)
                    except asyncio.TimeoutError:
                        return _error(500, "internal server error")
            if prediction0 is None:
                predictions = await self._predict(app, served, X, trace)
                prediction0 = float(predictions[0])
            return self._render(app, served, served.single_template.render, prediction0,
                                trace)

        return await self._score_common(app, body, score, trace_box)

    async def _score_batch(self, app, body: bytes, trace_box=None):
        async def score(app, served, X, trace):
            if trace is not None:
                trace.annotate(stream="production", routed_model_key=served.model_key,
                               rows=int(np.atleast_1d(X).shape[0]))
            if X.ndim == 0:
                X = X[None]
            predictions = await self._predict(app, served, X, trace)
            return self._render(app, served, served.batch_template.render, predictions,
                                trace)

        return await self._score_common(app, body, score, trace_box)

    async def _healthz(self, app, body: bytes, trace_box=None):
        payload, status, retry_after = app.healthz_response()
        extra = (("Retry-After", str(retry_after)),) if retry_after is not None else ()
        return status, json.dumps(payload).encode(), "application/json", extra

    async def _metrics(self, app, body: bytes, trace_box=None):
        loop = asyncio.get_running_loop()
        text = await loop.run_in_executor(self._executor, get_registry().render)
        return 200, text.encode(), METRICS_CONTENT_TYPE, ()


class AioServiceHandle:
    """A scoring service on an asyncio event loop, with the thread
    engine's handle interface: the loop runs on a background thread
    (:meth:`start`) or in the calling thread (:meth:`serve_forever`);
    :meth:`stop` is thread-safe and runs the registered cleanups first."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 5000):
        apps = list(app) if isinstance(app, (list, tuple)) else [app]
        self.server = AioScoringServer(apps)
        #: the first replica app (in-process scoring goes through it)
        self.app = apps[0]
        self.replica_apps = apps
        self.host = host
        self.port = port
        self._cleanups: list = []
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_event: asyncio.Event | None = None
        self._ready = threading.Event()
        self._startup_error: BaseException | None = None
        self._crash: BaseException | None = None
        self._thread = threading.Thread(target=self._run_loop,
                                        name="aio-scoring-service", daemon=True)

    @property
    def base_url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.base_url}/score/v1"

    def add_cleanup(self, fn) -> None:
        self._cleanups.append(fn)

    async def _serve_main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        try:
            server = await asyncio.start_server(self.server.handle_connection, self.host,
                                                self.port, limit=MAX_HEADER_BYTES)
            self.port = server.sockets[0].getsockname()[1]
        except BaseException as exc:
            self._startup_error = exc
            self._ready.set()
            raise
        log.info(f"scoring service (aio engine) listening on {self.url}")
        self._ready.set()
        try:
            async with server:
                await self._stop_event.wait()
        finally:
            self.server.close()

    def _run_loop(self) -> None:
        try:
            asyncio.run(self._serve_main())
        except BaseException as exc:
            if self._startup_error is not None:
                return  # start() reports it
            self._crash = exc
            raise

    def start(self) -> "AioServiceHandle":
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._startup_error is not None:
            raise RuntimeError(f"asyncio scoring service failed to start: "
                               f"{self._startup_error!r}") from self._startup_error
        if not self._ready.is_set():
            raise TimeoutError("asyncio scoring service not ready within 30s")
        return self

    def serve_forever(self) -> None:
        """Serve until stopped (pod-entrypoint mode). The loop runs on its
        thread and the caller waits for it: a signal handler's exception
        (``ShutdownRequested``) then reaches the caller, where inside the
        loop a callback would swallow it. A loop that dies raises here."""
        self.start()
        self.wait()
        if self._crash is not None:
            raise RuntimeError(f"asyncio scoring service failed: {self._crash!r}") \
                from self._crash

    def wait(self) -> None:
        self._thread.join()

    def stop(self) -> None:
        for fn in self._cleanups:
            fn()
        loop, stop_event = self._loop, self._stop_event
        if loop is not None and stop_event is not None:
            try:
                loop.call_soon_threadsafe(stop_event.set)
            except RuntimeError:
                pass  # loop already closed
        if self._thread.ident is not None:
            self._thread.join(timeout=10)
        log.info("scoring service (aio engine) stopped")
