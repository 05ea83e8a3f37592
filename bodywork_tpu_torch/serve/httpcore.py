"""The torch-free HTTP layer every scoring front end shares: the thread
engine's server and request handler, and the constants and helpers of the
``/score/v1`` contract that the in-process app (``serve.app``), the
``aio`` engine and the disaggregated front end (``serve.frontend``) all
answer with, and :class:`LocalClient`, the apps' in-process
``test_client()``.

:class:`ServiceHandle` is the thread engine's service (``serve_model``
and a ``serve --frontends`` front end serve through it). An app served
here maps one request to ``(status, headers, body)``
through ``app.handle(method, path, body, content_type,
traceparent=...)``; this module only moves bytes. It imports nothing
beyond the standard library and ``obs``, so a front-end process that
serves the thread engine never loads torch.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from json import dumps

from bodywork_tpu_torch.obs.tracing import TRACE_ID_HEADER, TRACEPARENT_HEADER
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.server")

#: werkzeug's 404 and 405 descriptions, which the JAX engines answer with
NOT_FOUND = (
    "The requested URL was not found on the server. If you entered the URL "
    "manually please check your spelling and try again."
)
METHOD_NOT_ALLOWED = "The method is not allowed for the requested URL."
JSON_HEADERS = {"Content-Type": "application/json"}
#: the Prometheus text exposition's content type
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: parse/serialize are µs-scale host work (the JAX app's buckets; every
#: app registering these histograms must pass the same ones)
FAST_PHASE_BUCKETS = (
    0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1,
)

#: routes whose successful requests count into the scoring-latency histogram
SCORING_ROUTES = ("/score/v1", "/score/v1/batch")

#: Retry-After (seconds) on a 503 from an app without admission control;
#: with admission, every backpressure answer carries its EWMA
RETRY_AFTER_S = 5


def json_response(payload: dict, status: int = 200, headers=None):
    """``(status, headers, body)`` of a JSON answer."""
    return status, {**JSON_HEADERS, **(headers or {})}, json.dumps(payload).encode()


def with_trace_id(response, trace):
    """``response`` with the trace id header: the only place an id leaves
    the service (never a body, so bodies stay byte-identical)."""
    status, headers, body = response
    return status, {**headers, TRACE_ID_HEADER: trace.trace_id}, body


class LocalResponse:
    """One in-process answer: ``status_code``, ``headers`` (with the
    ``Content-Length`` the server would add) and ``data``, the body bytes."""

    def __init__(self, status: int, headers: dict, body: bytes):
        self.status_code = status
        self.headers = {**headers, "Content-Length": str(len(body))}
        self.data = body

    def get_json(self):
        return json.loads(self.data)


class LocalClient:
    """An in-process client of an app served here (what ``test_client()``
    returns, the werkzeug client's calls): each request goes through
    ``app.handle``, the handler code the servers run, with no socket."""

    def __init__(self, app):
        self.app = app

    def open(self, path: str, method: str = "GET", data: bytes | str = b"",
             json: dict | list | None = None, headers: dict | None = None,
             content_type: str | None = None) -> LocalResponse:
        headers = dict(headers or {})
        if json is not None:
            data = dumps(json)  # the parameter is werkzeug's name; it hides the module
            content_type = content_type or "application/json"
        if isinstance(data, str):
            data = data.encode()
        status, response_headers, body = self.app.handle(
            method, path, data, content_type or headers.get("Content-Type"),
            traceparent=headers.get(TRACEPARENT_HEADER),
        )
        return LocalResponse(status, response_headers, body)

    def get(self, path: str, **kwargs) -> LocalResponse:
        return self.open(path, "GET", **kwargs)

    def post(self, path: str, **kwargs) -> LocalResponse:
        return self.open(path, "POST", **kwargs)


class ThreadingServer(ThreadingHTTPServer):
    # one daemon thread per connection; a listen backlog of werkzeug's
    # 128 (the standard library's 5 resets a burst of connections)
    daemon_threads = True
    request_queue_size = 128


def handler_for(app):
    """The request handler class of ``app`` on a :class:`ThreadingServer`."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # one segment per response, sent at once: unbuffered, the headers
        # and the body leave as two writes, and on a keep-alive connection
        # the second waits out the client's delayed ACK (~40 ms)
        wbufsize = -1
        disable_nagle_algorithm = True

        def _respond(self, method: str) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, headers, payload = app.handle(
                method, self.path, body, self.headers.get("Content-Type"),
                traceparent=self.headers.get(TRACEPARENT_HEADER),
            )
            self.send_response(status)
            for name, value in headers.items():
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._respond("GET")

        def do_POST(self):
            self._respond("POST")

        def log_message(self, format, *args):
            log.debug(format % args)

    return Handler


class ServiceHandle:
    """A scoring service on a ``ThreadingHTTPServer`` (the ``thread``
    engine: one thread per connection). ``port=0`` lets the OS pick a
    free port. :meth:`stop` runs the registered cleanups (the apps'
    coalescers flush and stop) before it closes the listener."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 5000, sock=None):
        self.app = app
        #: the scoring apps behind the front (one unless replicated)
        self.replica_apps = list(getattr(app, "apps", [app]))
        if sock is None:
            self._server = ThreadingServer((host, port), handler_for(app))
        else:
            # a bound socket handed in (a ``serve --workers`` replica's
            # SO_REUSEPORT socket): listen on it instead of binding one
            self._server = ThreadingServer(sock.getsockname(), handler_for(app),
                                            bind_and_activate=False)
            self._server.socket.close()
            self._server.socket = sock
            self._server.server_address = sock.getsockname()
            self._server.server_name = host
            self._server.server_port = sock.getsockname()[1]
            self._server.server_activate()
        self.host = host
        self.port = self._server.server_port
        self._cleanups: list = []
        #: the checkpoint watcher (``serve.reload``) of a watched service
        self.watcher = None
        self._thread = threading.Thread(
            # poll_interval bounds how long shutdown() blocks
            target=lambda: self._server.serve_forever(poll_interval=0.005),
            name="scoring-service",
            daemon=True,
        )

    @property
    def base_url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
        return f"http://{host}:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.base_url}/score/v1"

    def add_cleanup(self, fn) -> None:
        """Run ``fn`` on :meth:`stop`."""
        self._cleanups.append(fn)

    def start(self) -> "ServiceHandle":
        self._thread.start()
        log.info(f"scoring service listening on {self.url}")
        return self

    def serve_forever(self) -> None:
        """Serve in the calling thread (pod-entrypoint mode)."""
        log.info(f"scoring service listening on {self.url}")
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()

    def wait(self) -> None:
        """Block until the server thread exits: a service pod's lifetime
        (``cli run-stage`` of a service stage)."""
        self._thread.join()

    def stop(self) -> None:
        for fn in self._cleanups:
            fn()
        self._server.shutdown()
        self._server.server_close()
        if self._thread.ident is not None:
            self._thread.join(timeout=10)
        log.info("scoring service stopped")
