"""Request tracing in the port (``bodywork_tpu_torch.obs.tracing`` and its
hooks in ``serve.app``, ``serve.aio``, ``serve.batcher`` and
``serve.predictor``) against the JAX package's (``bodywork_tpu.obs.
tracing``): ``parse_traceparent``, ``mint_trace_id``, ``head_sampled`` and
the derived span ids equal over seeded bodies, seeds and fractions; flight
records byte-equal, each package reading the other's dumps; a sampled
request through the port's two front ends and through the JAX app giving
the same trace (ids, span names, parent ids, links and meta; times
masked), coalesced or not; the id only in a header; fraction 0 leaving no
header and no span; exemplars that resolve to recorded traces.

Tolerance: none for ids, decisions and documents, compared for equality
with only the timeline fields (``start_s``, ``duration_s``) masked. The
response bodies of the two apps carry each package's own float32 linear
apply, whose last bit can differ: their predictions are held at rtol
1e-6, every other field equal."""
import http.client
import json
import threading
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
from bodywork_tpu.obs import tracing as jax_tracing
from bodywork_tpu.serve import create_app as jax_create_app
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.models import LinearRegressor
from bodywork_tpu_torch.obs import tracing
from bodywork_tpu_torch.serve import (
    AdmissionController,
    AioServiceHandle,
    PaddedPredictor,
    ServiceHandle,
    create_app,
)
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

DAY = date(2026, 7, 1)
BUCKETS = (1, 8, 64)
MODEL_KEY = "models/regressor-2026-07-01.npz"
SEED = 11


def _bodies(seed: int, n: int = 12) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = [b"", b"{}", json.dumps({"X": 50}).encode()]
    for _ in range(n):
        out.append(rng.bytes(int(rng.integers(1, 200))))
        out.append(json.dumps({"X": rng.uniform(0, 100, int(rng.integers(1, 5))).round(3)
                               .tolist()}).encode())
    return out


@pytest.mark.parametrize("value", [
    None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "  00-" + "A" * 32 + "-" + "B" * 16 + "-00  ", "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01", "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "zz-" + "a" * 32 + "-" + "b" * 16 + "-01", "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "garbage", "00-" + "a" * 32 + "-" + "b" * 16,
])
def test_parse_traceparent_is_jaxs(value):
    assert tracing.parse_traceparent(value) == jax_tracing.parse_traceparent(value)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5])
def test_ids_sampling_and_span_ids_are_jaxs(seed):
    for body in _bodies(seed):
        trace_id = tracing.mint_trace_id(seed, body)
        assert trace_id == jax_tracing.mint_trace_id(seed, body)
        assert len(trace_id) == 32 and int(trace_id, 16) >= 0
        for fraction in (0.0, 1e-9, 0.1, 0.5, 0.999, 1.0):
            assert (tracing.head_sampled(seed, trace_id, fraction)
                    == jax_tracing.head_sampled(seed, trace_id, fraction))
        for name, ordinal in (("request", 0), ("parse", 1), ("device-dispatch", 2),
                              ("queue-wait", 7)):
            assert (tracing._derived_span_id(trace_id, name, ordinal)
                    == jax_tracing._derived_span_id(trace_id, name, ordinal))
    # the sampled share over many ids tracks the fraction in both
    ids = [tracing.mint_trace_id(seed, str(i).encode()) for i in range(2000)]
    kept = sum(tracing.head_sampled(seed, t, 0.1) for t in ids)
    assert kept == sum(jax_tracing.head_sampled(seed, t, 0.1) for t in ids)
    assert 140 <= kept <= 260


def _trace_docs(module, seed: int, n: int = 3) -> list[dict]:
    """Completed sampled traces built through ``module``'s RequestTrace,
    with spans, links, meta and an ingress parent."""
    docs = []
    for i, body in enumerate(_bodies(seed, n)[:n + 2]):
        parent = None if i % 2 else f"00-{module.mint_trace_id(seed + 1, body)}-{'c' * 16}-01"
        tracer = module.Tracer(sample_fraction=1.0, seed=seed)
        trace = tracer.begin(parent, body)
        trace.annotate(stream="production", routed_model_key=MODEL_KEY)
        trace.add("parse", trace._t0, trace._t0 + 1e-5)
        span = trace.start_span("device-dispatch", coalesced=False)
        span.meta.update(aot_cache="warm", bucket=8)
        trace.end_span(span)
        trace.add("queue-wait", trace._t0, trace._t0 + 2e-4, links=[trace.root_span_id])
        doc = trace.to_dict()
        doc["route"], doc["status"] = "/score/v1", 200
        docs.append(_masked(doc, zero=True))
    return docs


def _masked(doc: dict, zero: bool = False) -> dict:
    """A trace document with its timeline fields masked (0.0 with
    ``zero``, else removed)."""
    out = {k: v for k, v in doc.items() if k != "duration_s"}
    out["spans"] = [{k: v for k, v in s.items() if k not in ("start_s", "duration_s")}
                    for s in doc["spans"]]
    if zero:
        out["duration_s"] = 0.0
        for s in out["spans"]:
            s["start_s"] = s["duration_s"] = 0.0
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_flight_record_documents_are_the_jax_bytes(seed):
    traces = _trace_docs(tracing, seed)
    assert traces == _trace_docs(jax_tracing, seed)
    kwargs = {"canary_key": "models/c.npz", "production_key": MODEL_KEY,
              "window": {"requests": 40}, "sampling": {"fraction": 1.0, "seed": seed}}
    port = tracing.flight_record_doc(traces, "abort", "p99 over budget", **kwargs)
    ref = jax_tracing.flight_record_doc(traces, "abort", "p99 over budget", **kwargs)
    assert json.dumps(port, sort_keys=True, indent=1) == json.dumps(ref, sort_keys=True, indent=1)
    assert tracing.validate_flight_record(ref) and jax_tracing.validate_flight_record(port)
    port["traces"][0]["status"] = 500  # a flipped byte of content fails the digest
    assert not tracing.validate_flight_record(port)
    assert not jax_tracing.validate_flight_record(port)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_dumps(tmp_path, writer):
    traces = _trace_docs(tracing, 5)
    module, store_cls = ((jax_tracing, JaxStore) if writer == "jax"
                         else (tracing, FilesystemStore))
    store = store_cls(tmp_path)
    keys = [module.write_flight_record(store, module.flight_record_doc(traces[:k], v, "r"))
            for k, v in ((2, "abort"), (3, "promote"))]
    # a re-write of the same document is idempotent, in both
    assert module.write_flight_record(
        store, module.flight_record_doc(traces[:2], "abort", "r")) == keys[0]
    store.put_bytes("obs/flightrec/flight-000009-abort-0000000000000000.json", b"{torn")
    for reader, reader_store in ((tracing, FilesystemStore(tmp_path)),
                                 (jax_tracing, JaxStore(tmp_path))):
        records = list(reader.iter_flight_records(reader_store))
        assert [k for k, _ in records] == keys
        assert [d["n_traces"] for _, d in records] == [2, 3]
        for i, trace in enumerate(traces):
            key, doc = reader.find_trace(reader_store, trace["trace_id"][:9].upper())
            assert (key, doc) == ((keys[0 if i < 2 else 1], trace) if i < 3 else (None, None))
        assert reader.find_trace(reader_store, "f" * 32) == (None, None)
    spans = tracing.flight_trace_spans(traces[0])
    jax_spans = jax_tracing.flight_trace_spans(traces[0])
    assert [s.__dict__ for s in spans] == [s.__dict__ for s in jax_spans]


# -- a request through both packages' front ends ------------------------------

def _post(base: str, path: str, body: bytes, headers=None):
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _assert_same_answer(got: bytes, want: bytes) -> None:
    got, want = json.loads(got), json.loads(want)
    for key in ("prediction", "predictions"):
        if key in want:
            np.testing.assert_allclose(got.pop(key), want.pop(key), rtol=1e-6)
    assert got == want


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    jax_model = JaxLinearRegressor().fit(X, (2.0 + 0.25 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    return model, jax_model


def _port_service(model, engine: str, window_ms=None, admission=None):
    app = create_app(model, DAY, predictor=PaddedPredictor(model, BUCKETS),
                     batch_window_ms=window_ms, model_key=MODEL_KEY,
                     model_source="production", admission=admission)
    cls = AioServiceHandle if engine == "aio" else ServiceHandle
    return cls(app, "127.0.0.1", 0).start()


def _jax_trace(jax_model, path, body, headers, window_ms):
    app = jax_create_app(jax_model, DAY, buckets=BUCKETS, batch_window_ms=window_ms,
                         model_key=MODEL_KEY, model_source="production")
    try:
        with jax_tracing.configured_tracing(1.0, seed=SEED) as tracer:
            resp = app.test_client().post(path, data=body, headers={
                "Content-Type": "application/json", **headers})
            return resp.status_code, resp.headers.get("X-Bodywork-Trace-Id"), \
                resp.get_data(), tracer.recorder.snapshot()
    finally:
        app.close()


CASES = [
    ("/score/v1", {"X": 42.5}, None),
    ("/score/v1", {"X": 42.5}, 2.0),
    ("/score/v1/batch", {"X": [1.0, 2.0, 3.0, 4.0, 5.0]}, None),
    ("/score/v1/batch", {"X": list(np.linspace(0, 100, 70).round(2))}, 2.0),
    ("/score/v1", {"Y": 1}, None),
]


@pytest.mark.parametrize("engine", ["thread", "aio"])
@pytest.mark.parametrize("path,payload,window_ms", CASES)
@pytest.mark.parametrize("ingress", [False, True])
def test_a_sampled_request_traces_as_in_jax(models, engine, path, payload, window_ms,
                                            ingress):
    model, jax_model = models
    body = json.dumps(payload).encode()
    headers = ({"traceparent": f"00-{'5e' * 16}-{'7a' * 8}-01"} if ingress else {})
    want_status, want_id, want_body, want = _jax_trace(jax_model, path, body, headers,
                                                       window_ms)
    handle = _port_service(model, engine, window_ms)
    try:
        with tracing.configured_tracing(1.0, seed=SEED) as tracer:
            status, got_headers, got_body = _post(handle.base_url, path, body, headers)
            got = tracer.recorder.snapshot()
    finally:
        handle.stop()
        handle.app.close()
    assert status == want_status
    _assert_same_answer(got_body, want_body)
    assert got_headers["X-Bodywork-Trace-Id"] == want_id
    assert want_id == ("5e" * 16 if ingress else tracing.mint_trace_id(SEED, body))
    assert want_id.encode() not in got_body  # the id rides the header only
    assert [_masked(d) for d in got] == [_masked(d) for d in want]
    (doc,) = got
    names = [s["name"] for s in doc["spans"]]
    if status != 200:
        assert names == ["parse"]
        return
    coalesced = window_ms is not None and path == "/score/v1"
    assert names == (["parse", "queue-wait", "device-dispatch", "serialize"] if coalesced
                     else ["parse", "device-dispatch", "serialize"])
    dispatch = doc["spans"][names.index("device-dispatch")]
    if coalesced:
        assert dispatch["meta"]["links"] == [doc["root_span_id"]]
    else:  # the graph cache's seam annotated the span on the dispatching thread
        assert dispatch["meta"]["aot_cache"] == "warm"
        assert dispatch["meta"]["bucket"] in BUCKETS
    assert all(s["parent_id"] == doc["root_span_id"] for s in doc["spans"])
    assert doc.get("parent_span_id") == ("7a" * 8 if ingress else None)


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_coalesced_members_link_the_one_shared_dispatch(models, engine):
    model, _ = models
    handle = _port_service(model, engine, window_ms=20.0)
    xs = [float(x) for x in np.linspace(1, 99, 12)]
    answers = {}

    def one(x):
        answers[x] = _post(handle.base_url, "/score/v1", json.dumps({"X": x}).encode())

    try:
        with tracing.configured_tracing(1.0, seed=SEED) as tracer:
            threads = [threading.Thread(target=one, args=(x,)) for x in xs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            traces = tracer.recorder.snapshot()
    finally:
        handle.stop()
        handle.app.close()
    assert len(answers) == len(traces) == len(xs)
    by_root = {t["root_span_id"]: t for t in traces}
    for trace in traces:
        (dispatch,) = [s for s in trace["spans"] if s["name"] == "device-dispatch"]
        meta = dispatch["meta"]
        assert trace["root_span_id"] in meta["links"] and meta["coalesced"] is True
        assert meta["batch_rows"] == len(meta["links"])
        for root in meta["links"]:  # every linked member holds the same dispatch
            (other,) = [s for s in by_root[root]["spans"] if s["name"] == "device-dispatch"]
            assert other["meta"] == meta
    assert max(len(t["spans"][2]["meta"]["links"]) for t in traces) > 1


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_fraction_zero_mints_nothing_and_records_nothing(models, engine):
    model, _ = models
    handle = _port_service(model, engine)
    try:
        with tracing.configured_tracing(0.0, seed=SEED) as tracer:
            for path, payload in (("/score/v1", {"X": 3}), ("/score/v1/batch", {"X": [1, 2]})):
                status, headers, body = _post(handle.base_url, path,
                                              json.dumps(payload).encode(),
                                              {"traceparent": f"00-{'1' * 32}-{'2' * 16}-01"})
                assert status == 200 and "X-Bodywork-Trace-Id" not in headers
            assert len(tracer.recorder) == 0
    finally:
        handle.stop()
        handle.app.close()


def test_unsampled_requests_carry_an_id_and_record_no_span(models):
    model, _ = models
    app = create_app(model, DAY, predictor=PaddedPredictor(model, BUCKETS))
    with tracing.configured_tracing(0.1, seed=SEED) as tracer:
        sampled = 0
        for i in range(40):
            body = json.dumps({"X": i}).encode()
            status, headers, payload = app.handle("POST", "/score/v1", body,
                                                  "application/json")
            trace_id = headers["X-Bodywork-Trace-Id"]
            assert trace_id == tracing.mint_trace_id(SEED, body)
            assert trace_id.encode() not in payload
            sampled += tracing.head_sampled(SEED, trace_id, 0.1)
        assert len(tracer.recorder) == sampled < 40


def test_exemplars_resolve_to_recorded_traces(models, monkeypatch):
    from bodywork_tpu_torch.obs import registry

    # a registry of this test's own: the process's holds other tests' exemplars
    monkeypatch.setattr(registry, "_DEFAULT", registry.Registry())
    model, _ = models
    app = create_app(model, DAY, predictor=PaddedPredictor(model, BUCKETS))
    with tracing.configured_tracing(1.0, seed=SEED) as tracer:
        for i in range(30):
            app.handle("POST", "/score/v1", json.dumps({"X": i}).encode(), "application/json")
        exemplars = app.healthz_payload()["latency_exemplars"]
        recorded = {t["trace_id"] for t in tracer.recorder.snapshot()}
    assert exemplars and set(exemplars.values()) <= recorded
    text = app.handle("GET", "/metrics")[2].decode()
    assert any(f" trace_id={trace_id} " in text for trace_id in exemplars.values())


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_a_shed_request_answers_its_ingress_id_and_records_the_shed(models, engine):
    model, _ = models
    admission = AdmissionController(max_pending=1)
    handle = _port_service(model, engine, admission=admission)
    admission.try_admit()  # the budget is taken: the next request sheds
    try:
        with tracing.configured_tracing(1.0, seed=SEED) as tracer:
            status, headers, body = _post(handle.base_url, "/score/v1", b'{"X": 1}',
                                          {"traceparent": f"00-{'ab' * 16}-{'cd' * 8}-01"})
            plain = _post(handle.base_url, "/score/v1", b'{"X": 1}')
            traces = tracer.recorder.snapshot()
    finally:
        admission.release(0.0)
        handle.stop()
        handle.app.close()
    assert status == 429 and headers["X-Bodywork-Trace-Id"] == "ab" * 16
    # a shed request without ingress context never reads its body: no id
    assert plain[0] == 429 and "X-Bodywork-Trace-Id" not in plain[1]
    (doc,) = traces
    assert [s["name"] for s in doc["spans"]] == ["admission-shed"]
    assert doc["status"] == 429 and doc["spans"][0]["meta"]["queue_depth"] >= 1


def test_the_tracer_knobs_are_jaxs(monkeypatch):
    assert tracing.DEFAULT_SAMPLE_FRACTION == jax_tracing.DEFAULT_SAMPLE_FRACTION == 0.1
    assert (tracing.SAMPLE_ENV, tracing.SEED_ENV, tracing.TRACE_ID_HEADER) == (
        jax_tracing.SAMPLE_ENV, jax_tracing.SEED_ENV, jax_tracing.TRACE_ID_HEADER)
    for raw, seed in (("0.25", "9"), ("2", "x"), ("nope", ""), ("", "3")):
        monkeypatch.setenv(tracing.SAMPLE_ENV, raw)
        monkeypatch.setenv(tracing.SEED_ENV, seed)
        port, ref = tracing.Tracer(), jax_tracing.Tracer()
        assert (port.sample_fraction, port.seed) == (ref.sample_fraction, ref.seed)
    with pytest.raises(ValueError):
        tracing.configure_tracing(1.5)
