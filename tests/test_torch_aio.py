"""The asyncio front end (``bodywork_tpu_torch.serve.aio``) over real HTTP,
against the port's thread engine and the JAX package's two engines
answering from the same predictions: equal response bytes for single and
batch scores, ``/healthz``, 404, 405, malformed JSON and the no-model
503; a 429 with ``Retry-After`` from the loop with no work behind it; the
``/metrics`` shed count equal to the 429s; keep-alive; and the engine
tables in step with the JAX package's."""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
from bodywork_tpu.serve import AioServiceHandle as JaxAioServiceHandle
from bodywork_tpu.serve import ServiceHandle as JaxServiceHandle
from bodywork_tpu.serve import create_app as jax_create_app
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import LinearRegressor
from bodywork_tpu_torch.serve import (
    SERVER_ENGINES,
    AdmissionController,
    AioServiceHandle,
    PaddedPredictor,
    ServiceHandle,
    create_app,
)

torch.set_num_threads(1)

DAY = date(2026, 7, 1)
#: werkzeug's own headers
JAX_ONLY_HEADERS = {"server", "date"}


class _Shared:
    """One port predictor behind both packages' predictor interface, so
    the four services answer from the same floats."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.buckets = predictor.buckets
        self.dtype = predictor.dtype

    def predict(self, X):
        return self.predictor.predict(X)

    def warmup(self, n_features=None, sync=True):
        self.predictor.warmup()


def _http(base, path, body=None, method=None, content_type="application/json"):
    data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
    request = urllib.request.Request(
        base + path, data=data, method=method or ("POST" if data is not None else "GET"),
        headers={"Content-Type": content_type} if data is not None else {})
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _exemplar_ids(exemplars) -> list:
    """The trace ids of a ``latency_exemplars`` value (null, or bucket ->
    32-hex trace id), checked for shape."""
    ids = list((exemplars or {}).values())
    assert all(isinstance(i, str) and len(i) == 32 and int(i, 16) >= 0 for i in ids), ids
    return ids


@pytest.fixture(scope="module")
def services():
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 100, 600).astype(np.float32)
    jax_model = JaxLinearRegressor().fit(X, (1.0 + 0.5 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    predictor = PaddedPredictor(model, (1, 8, 64))
    kwargs = {"batch_window_ms": 2.0, "model_key": "models/m", "model_source": "production"}
    handles = {}
    for name, cls in (("thread", ServiceHandle), ("aio", AioServiceHandle)):
        handles[name] = cls(create_app(model, DAY, predictor=predictor, **kwargs),
                            "127.0.0.1", 0).start()
    for name, cls in (("jax-thread", JaxServiceHandle), ("jax-aio", JaxAioServiceHandle)):
        handles[name] = cls(jax_create_app(jax_model, DAY, predictor=_Shared(predictor),
                                           **kwargs), "127.0.0.1", 0).start()
    yield {name: (h, h.url.replace("/score/v1", "")) for name, h in handles.items()}
    for h in handles.values():
        h.stop()
        h.app.close()


@pytest.mark.parametrize("path,body,method,status", [
    ("/score/v1", {"X": 50}, None, 200),
    ("/score/v1", {"X": [[60.0]]}, None, 200),
    ("/score/v1", {"X": 0.125}, None, 200),
    ("/score/v1/batch", {"X": [1.0, 2.0, 3.0]}, None, 200),
    ("/score/v1/batch", {"X": list(np.linspace(0, 100, 70).round(2))}, None, 200),
    ("/score/v1", {"Y": 1}, None, 400),
    ("/score/v1", {"X": "fifty"}, None, 400),
    ("/score/v1", {"X": []}, None, 400),
    ("/score/v1/batch", {"X": [1.0, float("nan")]}, None, 400),
    ("/score/v1", b"not json", None, 400),
    ("/score/v2", {"X": 1}, None, 404),
    ("/nope", None, "GET", 404),
    ("/score/v1", None, "GET", 405),
    ("/metrics", b"{}", "POST", 405),
])
def test_every_engine_answers_the_same_bytes(services, path, body, method, status):
    answers = {name: _http(base, path, body, method) for name, (_h, base) in services.items()}
    for name, (got_status, _headers, _body) in answers.items():
        assert got_status == status, name
    assert len({payload for _s, _h, payload in answers.values()}) == 1, answers
    # the two asyncio engines also send the same headers; the thread
    # engines the same application headers (their HTTP servers frame
    # connections each their own way)
    (_, aio_h, _), (_, jax_aio_h, _) = answers["aio"], answers["jax-aio"]
    assert aio_h == {k: v for k, v in jax_aio_h.items() if k.lower() not in JAX_ONLY_HEADERS}
    app_headers = ("Content-Type", "Content-Length", "Retry-After", "X-Bodywork-Model-Key",
                   "X-Bodywork-Trace-Id")
    (_, thread_h, _), (_, jax_thread_h, _) = answers["thread"], answers["jax-thread"]
    assert ({k: thread_h.get(k) for k in app_headers}
            == {k: jax_thread_h.get(k) for k in app_headers})


def test_coalesced_bursts_answer_the_same_bytes_on_every_engine(services):
    xs = [float(v) for v in np.linspace(5, 95, 24)]

    def burst(base):
        out = {}

        def one(x):
            out[x] = _http(base, "/score/v1", {"X": x})[2]

        threads = [threading.Thread(target=one, args=(x,)) for x in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return out

    per_engine = {name: burst(base) for name, (_h, base) in services.items()}
    for x in xs:
        assert len({per_engine[name][x] for name in per_engine}) == 1, x
    for name in ("thread", "aio"):
        stats = services[name][0].app.batcher.stats()
        assert stats["rows_submitted"] == stats["rows_dispatched"] >= len(xs)


def test_healthz_bytes_equal_across_engines_and_jaxs_keys_and_values(services):
    answers = {name: _http(base, "/healthz") for name, (_h, base) in services.items()}
    assert answers["thread"][2] == answers["aio"][2]
    assert answers["jax-thread"][2] == answers["jax-aio"][2]
    port, ref = json.loads(answers["aio"][2]), json.loads(answers["jax-aio"][2])
    assert list(port)[:len(ref)] == list(ref)
    # latency exemplars are sampled requests' trace ids, per bucket of a
    # process-wide histogram: their buckets follow each process's timings
    _exemplar_ids(port.pop("latency_exemplars"))
    _exemplar_ids(ref.pop("latency_exemplars"))
    assert {k: port[k] for k in ref} == ref
    assert port["engine"] == "torch" and port["device"] == "cpu"
    assert port["effective_config"] == {"batch_window_ms": 2.0, "batch_max_rows": 64,
                                        "buckets": [1, 8, 64], "max_pending": None,
                                        "dtype": "float32", "tuned_config": None}


def test_metrics_on_both_engines_with_the_exposition_content_type(services):
    for name in ("thread", "aio"):
        status, headers, body = _http(services[name][1], "/metrics")
        assert status == 200
        assert headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
        text = body.decode()
        assert "# TYPE bodywork_tpu_http_requests_total counter" in text
        assert "bodywork_tpu_scoring_latency_seconds_bucket" in text


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_the_no_model_503_is_jaxs(engine):
    """An app with nothing to serve: scoring answers 503 + Retry-After,
    /healthz 503 with the JAX document, a malformed request still 400."""
    port_cls = AioServiceHandle if engine == "aio" else ServiceHandle
    jax_cls = JaxAioServiceHandle if engine == "aio" else JaxServiceHandle
    port = port_cls(create_app(None), "127.0.0.1", 0).start()
    ref = jax_cls(jax_create_app(None), "127.0.0.1", 0).start()
    try:
        for path, body in (("/score/v1", {"X": 1}), ("/score/v1/batch", {"X": [1]}),
                           ("/score/v1", {"Y": 1})):
            got = _http(port.url.replace("/score/v1", ""), path, body)
            want = _http(ref.url.replace("/score/v1", ""), path, body)
            assert got[0] == want[0] and got[2] == want[2]
            assert got[1].get("Retry-After") == want[1].get("Retry-After")
        got = _http(port.url.replace("/score/v1", ""), "/healthz")
        want = _http(ref.url.replace("/score/v1", ""), "/healthz")
        assert got[0] == want[0] == 503 and got[1]["Retry-After"] == want[1]["Retry-After"]
        got, want = json.loads(got[2]), json.loads(want[2])
        _exemplar_ids(got.pop("latency_exemplars"))  # the process-wide histogram's
        _exemplar_ids(want.pop("latency_exemplars"))
        assert got == want
    finally:
        port.stop()
        ref.stop()


def _shed_total(base) -> float:
    text = _http(base, "/metrics")[2].decode()
    for line in text.splitlines():
        if line.startswith('bodywork_tpu_serve_shed_total{reason="admission"}'):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_a_burst_past_the_budget_sheds_429s_from_the_loop():
    """max_pending 2 under 24 concurrent slow requests: the sheds answer
    429 + Retry-After before any work (the predictor runs once per
    admitted request), every 200 is the unshed answer, and the /metrics
    shed count rises by exactly the 429s."""
    calls = []

    class Slow(PaddedPredictor):
        def predict(self, X):
            calls.append(1)
            time.sleep(0.05)
            return super().predict(X)

    rng = np.random.default_rng(2)
    X = rng.uniform(0, 100, 300).astype(np.float32)
    model = LinearRegressor().fit(X, (2.0 + 0.25 * X).astype(np.float32), device="cpu")
    admission = AdmissionController(max_pending=2, retry_after_min_s=1.0)
    handle = AioServiceHandle(create_app(model, DAY, predictor=Slow(model, (1, 8)),
                                         admission=admission), "127.0.0.1", 0).start()
    base = handle.url.replace("/score/v1", "")
    calls.clear()
    try:
        before = _shed_total(base)
        unshed = {x: _http(base, "/score/v1", {"X": x})[2] for x in range(24)}
        calls.clear()
        results = {}
        start = threading.Barrier(24)

        def one(x):
            start.wait()
            results[x] = _http(base, "/score/v1", {"X": x})

        threads = [threading.Thread(target=one, args=(x,)) for x in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        statuses = [results[x][0] for x in range(24)]
        sheds = [x for x in range(24) if results[x][0] == 429]
        assert set(statuses) == {200, 429} and sheds
        for x in sheds:
            status, headers, body = results[x]
            assert headers["Retry-After"] == str(int(headers["Retry-After"]))
            assert int(headers["Retry-After"]) >= 1
            assert json.loads(body) == {"error": "server over capacity; request shed"}
        for x in range(24):
            if results[x][0] == 200:
                assert results[x][2] == unshed[x]
        assert len(calls) == statuses.count(200)  # a shed did no work
        assert _shed_total(base) - before == len(sheds)
        assert admission.state()["pending"] == 0
        assert admission.max_observed_pending <= 2
    finally:
        handle.stop()


def test_keep_alive_holds_on_the_aio_engine(services):
    handle, base = services["aio"]
    conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=30)
    try:
        sockets = set()
        for x in range(5):
            conn.request("POST", "/score/v1", body=json.dumps({"X": x}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Connection") == "keep-alive"
            assert json.loads(resp.read())["prediction"] == pytest.approx(1 + 0.5 * x, abs=1e-3)
            sockets.add(id(conn.sock))
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        assert len(sockets) == 1 and conn.sock is not None
    finally:
        conn.close()


@pytest.mark.parametrize("head,status", [
    (b"POST /score/v1 HTTP/1.1\r\nContent-Length: nope\r\n\r\n", 400),
    (b"POST /score/v1 HTTP/1.1\r\n\r\n", 411),
    (b"POST /score/v1 HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 400),
    (b"garbage\r\n\r\n", 400),
])
def test_protocol_faults_answer_and_close_like_jax(services, head, status):
    import socket

    answers = []
    for name in ("aio", "jax-aio"):
        with socket.create_connection(("127.0.0.1", services[name][0].port), timeout=30) as s:
            s.sendall(head)
            chunks = []
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                chunks.append(chunk)
            answers.append(b"".join(chunks))
    assert answers[0] == answers[1]
    assert answers[0].startswith(f"HTTP/1.1 {status} ".encode())
    assert b"Connection: close" in answers[0]


@pytest.mark.parametrize("content_type,body,framing", [
    ("text/plain", {"X": 50}, "json"),
    ("", {"X": [1.0, 2.0]}, "json"),
    ("application/x-bodywork-rows", [[50.0]], "binary"),
    ("application/x-bodywork-rows; charset=binary", [[1.0], [2.0]], "binary"),
])
def test_content_type_rules_match_jaxs_per_engine(services, content_type, body, framing):
    """Which framing a content type selects: the binary rows by their
    type on every engine; JSON under any other type on the asyncio
    engines, and only under a JSON type on the thread engines. Each port
    engine answers its JAX counterpart's status and bytes."""
    from bodywork_tpu_torch.serve.wire import encode_binary_rows

    data = (encode_binary_rows(np.asarray(body, dtype=np.float32)) if framing == "binary"
            else json.dumps(body).encode())
    path = "/score/v1" if len(body if framing == "binary" else np.atleast_1d(body["X"])) == 1 \
        else "/score/v1/batch"
    answers = {name: _http(base, path, data, None, content_type)
               for name, (_h, base) in services.items()}
    for port, jax in (("thread", "jax-thread"), ("aio", "jax-aio")):
        assert (answers[port][0], answers[port][2]) == (answers[jax][0], answers[jax][2]), port
    if framing == "binary":
        assert answers["thread"][0] == answers["aio"][0] == 200
    else:
        assert (answers["thread"][0], answers["aio"][0]) == (400, 200)


def test_engine_tables_stay_in_step_with_jax():
    from bodywork_tpu.serve.server import SERVER_ENGINES as JAX_SERVER_ENGINES

    serve = cli.build_parser()._subparsers._group_actions[0].choices["serve"]
    action = next(a for a in serve._actions if a.dest == "server_engine")
    assert tuple(action.choices) == SERVER_ENGINES == JAX_SERVER_ENGINES


def test_aio_dispatch_timing_includes_the_executor_wait_in_both_packages():
    """One executor worker, a predictor that holds it for HOLD seconds,
    two concurrent batch requests at trace fraction 1: on both packages'
    aio engines the second request's ``device_dispatch_seconds``
    observation and ``device-dispatch`` span include the first request's
    hold (the JAX engine times the whole ``await run_in_executor``)."""
    from concurrent.futures import ThreadPoolExecutor

    from bodywork_tpu.obs import get_registry as jax_get_registry
    from bodywork_tpu.obs.tracing import configured_tracing as jax_configured_tracing
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.obs.tracing import configured_tracing

    hold = 0.25

    class Held(PaddedPredictor):
        def predict(self, X):
            time.sleep(hold)
            return super().predict(X)

    rng = np.random.default_rng(5)
    X = rng.uniform(0, 100, 300).astype(np.float32)
    jax_model = JaxLinearRegressor().fit(X, (3.0 + 0.5 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    predictor = Held(model, (1, 8))
    packages = {
        "port": (AioServiceHandle(create_app(model, DAY, predictor=predictor), "127.0.0.1", 0),
                 get_registry, configured_tracing),
        "jax": (JaxAioServiceHandle(jax_create_app(jax_model, DAY, predictor=_Shared(predictor)),
                                    "127.0.0.1", 0),
                jax_get_registry, jax_configured_tracing),
    }
    for name, (handle, registry, tracing) in packages.items():
        handle.server._executor = ThreadPoolExecutor(max_workers=1)
        handle.start()
        base = handle.url.replace("/score/v1", "")
        hist = registry().histogram("bodywork_tpu_device_dispatch_seconds")
        try:
            with tracing(1.0, seed=11) as tracer:
                count0, sum0 = hist.count(), hist.sum()
                start = threading.Barrier(2)
                statuses = []

                def one(x, start=start, statuses=statuses, base=base):
                    start.wait()
                    statuses.append(_http(base, "/score/v1/batch", {"X": [x, x + 1.0]})[0])

                threads = [threading.Thread(target=one, args=(x,)) for x in (10.0, 20.0)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
                assert statuses == [200, 200], name
                assert hist.count() - count0 == 2, name
                # the two observations: one hold, then the wait plus a hold
                assert hist.sum() - sum0 >= 2.9 * hold, (name, hist.sum() - sum0)
                spans = sorted(s["duration_s"] for t in tracer.recorder.snapshot()
                               for s in t["spans"] if s["name"] == "device-dispatch")
                assert len(spans) == 2, (name, spans)
                assert spans[0] >= 0.95 * hold and spans[1] >= 1.95 * hold, (name, spans)
        finally:
            handle.stop()
            handle.app.close()
