"""The request coalescer (``bodywork_tpu_torch.serve.batcher``): the cases
of the JAX package's ``tests/test_batcher.py`` on the port, and response
bytes equal to the JAX app's with the coalescer on and off."""
import json
import threading
import time
import urllib.request
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
from bodywork_tpu.serve import create_app as jax_create_app
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import LinearRegressor
from bodywork_tpu_torch.serve import (
    CoalescerSaturated,
    RequestCoalescer,
    create_app,
    serve_model,
)
from bodywork_tpu_torch.serve.app import _Served

torch.set_num_threads(1)

DAY = date(2026, 7, 1)


def _data(seed=1, n=600, slope=0.5):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, n).astype(np.float32)
    return X, (1.0 + slope * X).astype(np.float32)


@pytest.fixture(scope="module")
def fitted_model():
    return LinearRegressor().fit(*_data(), device="cpu")


def _batched_app(model, window_ms=20.0, max_rows=64, buckets=(1, 8, 64)):
    from bodywork_tpu_torch.serve import PaddedPredictor

    return create_app(model, DAY, predictor=PaddedPredictor(model, buckets),
                      batch_window_ms=window_ms, batch_max_rows=max_rows)


def _post(app, path, payload):
    status, headers, body = app.handle("POST", path, json.dumps(payload).encode(),
                                       "application/json")
    return status, headers, body


def test_response_bytes_identical_with_batcher_on(fitted_model):
    """The frozen /score/v1 contract survives coalescing byte for byte."""
    from bodywork_tpu_torch.serve import PaddedPredictor

    plain = create_app(fitted_model, DAY, predictor=PaddedPredictor(fitted_model, (1, 8, 64)))
    batched = _batched_app(fitted_model)
    try:
        for payload in ({"X": 50}, {"X": [[60.0]]}, {"X": 0.0}):
            s_plain, _, b_plain = _post(plain, "/score/v1", payload)
            s_batch, _, b_batch = _post(batched, "/score/v1", payload)
            assert s_plain == s_batch == 200
            assert b_plain == b_batch
        # error paths bypass the batcher identically
        assert _post(batched, "/score/v1", {"Y": 1})[0] == 400
        # multi-row /score/v1 and the batch endpoint stay direct-dispatch
        status, _, body = _post(batched, "/score/v1/batch", {"X": [1.0, 2.0]})
        assert status == 200 and json.loads(body)["n"] == 2
        assert batched.batcher.stats()["rows_submitted"] == 3
    finally:
        batched.close()


class _PortPredictor:
    """The port's predictor behind the JAX app's predictor interface, so
    both apps answer from the same floats and the comparison reads
    everything above the model: routing, parsing, the coalescer, the
    firewall, serialisation, statuses and headers."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.buckets = predictor.buckets
        self.dtype = predictor.dtype

    def predict(self, X):
        return self.predictor.predict(X)

    def warmup(self, n_features=None, sync=True):
        self.predictor.warmup()


@pytest.mark.parametrize("window_ms", [0, 5.0])
def test_response_bytes_equal_to_the_jax_app_coalescer_on_and_off(window_ms):
    """The JAX app and the port's, coalescer off (0) and on, answering
    from the same predictions: every single, batch and error answer is
    the same bytes with the same status and model-key header; and the
    JAX fit of the same data, served by the JAX app, is within the f32
    bar of the port's answers."""
    from bodywork_tpu_torch.serve import PaddedPredictor

    X, y = _data(seed=7)
    jax_model = JaxLinearRegressor().fit(X, y)
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    predictor = PaddedPredictor(model)
    kwargs = {"batch_window_ms": window_ms, "model_key": "models/m",
              "model_source": "production"}
    jax_app = jax_create_app(jax_model, DAY, predictor=_PortPredictor(predictor), **kwargs)
    jax_own = jax_create_app(jax_model, DAY, **kwargs)
    app = create_app(model, DAY, predictor=predictor, **kwargs)
    client, own = jax_app.test_client(), jax_own.test_client()
    try:
        cases = [("/score/v1", {"X": x}) for x in (50, 0.5, 99.25, [[42.0]], 1e-3)]
        cases += [("/score/v1/batch", {"X": list(np.linspace(0, 100, n).round(3))})
                  for n in (1, 3, 70)]
        cases += [("/score/v1", {"Y": 1}), ("/score/v1", {"X": []}),
                  ("/score/v1/batch", {"X": "fifty"})]
        for path, payload in cases:
            status, headers, body = _post(app, path, payload)
            ref = client.post(path, json=payload)
            assert status == ref.status_code, (path, payload)
            assert body == ref.data, (path, payload)
            if status == 200:
                assert headers["X-Bodywork-Model-Key"] == ref.headers["X-Bodywork-Model-Key"]
                got, want = json.loads(body), own.post(path, json=payload).get_json()
                key = "prediction" if "prediction" in want else "predictions"
                np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=2e-4)
        if window_ms:
            assert app.batcher.stats()["rows_submitted"] == 5
    finally:
        app.close()
        jax_app.close()
        jax_own.close()


def test_concurrent_requests_coalesce_into_fewer_dispatches(fitted_model):
    """>= 16 threads of single-row requests issue strictly fewer device
    dispatches than requests, every row still getting its own answer."""
    app = _batched_app(fitted_model, window_ms=25.0)
    client_errors, results = [], []
    n_threads = 24
    start = threading.Barrier(n_threads)

    def hit(v: float):
        try:
            start.wait()
            status, _, body = _post(app, "/score/v1", {"X": v})
            assert status == 200
            results.append((v, json.loads(body)["prediction"]))
        except Exception as exc:  # noqa: BLE001
            client_errors.append(repr(exc))

    threads = [threading.Thread(target=hit, args=(float(i),)) for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not client_errors, client_errors[:3]
        stats = app.batcher.stats()
        assert stats["rows_submitted"] == stats["rows_dispatched"] == n_threads
        assert stats["batches_dispatched"] < n_threads, stats
        assert stats["max_batch_rows"] >= 2
        for v, pred in results:
            assert pred == pytest.approx(1.0 + 0.5 * v, abs=0.2), (v, pred)
        assert len({round(p, 3) for _, p in results}) == n_threads
    finally:
        app.close()


def test_mixed_row_shapes_never_share_a_batch():
    """A concurrent odd-width row must not fail its neighbours' stack:
    batches group by row shape as well as bundle."""
    rng = np.random.default_rng(4)
    X3 = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    model3 = LinearRegressor().fit(X3, X3.sum(axis=1).astype(np.float32), device="cpu")
    app = _batched_app(model3, window_ms=25.0, buckets=(1, 8))
    errors, results = [], []
    start = threading.Barrier(16)

    def hit(payload, want):
        try:
            start.wait()
            status, _, body = _post(app, "/score/v1", payload)
            assert status == 200, body
            results.append((json.loads(body)["prediction"], want))
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    threads = []
    for i in range(16):
        if i % 2:
            payload, want = {"X": [[0.1 * i, 0.2, 0.3]]}, 0.1 * i + 0.5
        else:  # a 1-feature row on a 3-feature model: the others must not 500
            payload, want = {"X": 0.1 * i}, None
        threads.append(threading.Thread(target=hit, args=(payload, want)))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        full = [(p, w) for p, w in results if w is not None]
        assert len(full) == 8, (errors, len(results))
        for pred, want in full:
            assert pred == pytest.approx(want, abs=0.05), (pred, want)
    finally:
        app.close()


def test_batch_flushes_at_max_rows_before_window(fitted_model):
    """max_rows caps the batch and flushes it at once."""
    from bodywork_tpu_torch.serve import PaddedPredictor

    coalescer = RequestCoalescer(window_ms=10_000.0, max_rows=4).start()
    app = create_app(fitted_model, DAY, predictor=PaddedPredictor(fitted_model, (1, 4, 8)),
                     warmup=False)
    bundle = app.served
    results = []

    def submit(v):
        results.append((v, coalescer.submit(bundle, np.asarray([v], np.float32))))

    threads = [threading.Thread(target=submit, args=(float(i),)) for i in range(4)]
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert time.monotonic() - t0 < 5.0
        assert coalescer.stats()["max_batch_rows"] == 4
        for v, pred in results:
            assert pred == pytest.approx(1.0 + 0.5 * v, abs=0.2)
    finally:
        coalescer.stop()


def test_saturated_coalescer_raises_and_request_path_degrades(fitted_model):
    """A never-started or stopped coalescer raises CoalescerSaturated; the
    app degrades to a direct dispatch and counts the fallback."""
    from bodywork_tpu_torch.obs import get_registry

    app = create_app(fitted_model, DAY, warmup=False)
    bundle = app.served
    stopped = RequestCoalescer(window_ms=1.0)
    with pytest.raises(CoalescerSaturated):  # never started
        stopped.submit(bundle, np.asarray([1.0], np.float32))
    stopped.start()
    stopped.stop()
    with pytest.raises(CoalescerSaturated):  # stopped
        stopped.submit(bundle, np.asarray([1.0], np.float32))
    full = RequestCoalescer(window_ms=10_000.0, max_pending=1).start()
    try:
        full.submit_nowait(bundle, np.asarray([1.0], np.float32))
        with pytest.raises(CoalescerSaturated, match="already pending"):
            full.submit_nowait(bundle, np.asarray([2.0], np.float32))
    finally:
        full.stop()

    fallbacks = get_registry().counter("bodywork_tpu_coalescer_fallback_total")
    before = fallbacks.value()
    app2 = _batched_app(fitted_model, window_ms=5.0)
    app2.batcher.stop()
    status, _, body = _post(app2, "/score/v1", {"X": 50})
    assert status == 200
    assert json.loads(body)["prediction"] == pytest.approx(26.0, abs=2.0)
    assert app2.batcher.stats()["batches_dispatched"] == 0
    assert fallbacks.value() == before + 1


def test_failed_batch_scatters_error_and_dispatcher_survives(fitted_model):
    app = _batched_app(fitted_model, window_ms=5.0)

    class _Boom:
        buckets = (1,)

        def predict(self, X):
            raise RuntimeError("injected device fault")

    class _BadBundle:
        predictor = _Boom()
        model_info = "broken"
        model_date = None

    try:
        with pytest.raises(RuntimeError, match="injected device fault"):
            app.batcher.submit(_BadBundle(), np.asarray([1.0], np.float32))
        assert _post(app, "/score/v1", {"X": 50})[0] == 200
    finally:
        app.close()


def test_hot_swap_never_mixes_models_within_a_batch():
    """Submissions against two bundles in one window flush as separate
    device calls, each caller scored by the bundle it enqueued against."""
    calls = []

    class _RecordingPredictor:
        buckets = (64,)

        def __init__(self, gen: str, slope: float):
            self.gen = gen
            self.slope = slope

        def predict(self, X):
            calls.append((self.gen, X.shape[0]))
            return (self.slope * X[:, 0]).astype(np.float32)

    class _Bundle:
        def __init__(self, gen, slope):
            self.predictor = _RecordingPredictor(gen, slope)
            self.model_info = gen
            self.model_date = None

    old, new = _Bundle("old", 1.0), _Bundle("new", 10.0)
    coalescer = RequestCoalescer(window_ms=200.0, max_rows=64).start()
    results = []
    entered = threading.Barrier(9)

    def submit(bundle, v):
        entered.wait()
        results.append((bundle.model_info, v,
                        coalescer.submit(bundle, np.asarray([v], np.float32))))

    threads = [threading.Thread(target=submit, args=(old, float(i))) for i in range(4)]
    threads += [threading.Thread(target=submit, args=(new, float(i))) for i in range(4)]
    try:
        for t in threads:
            t.start()
        entered.wait()
        for t in threads:
            t.join(timeout=30)
    finally:
        coalescer.stop()
    assert sum(n for _, n in calls) == 8
    assert {g for g, _ in calls} == {"old", "new"}
    for gen, v, pred in results:
        assert pred == pytest.approx(v * (1.0 if gen == "old" else 10.0), abs=1e-5)


def test_drain_returns_after_every_queued_row_is_scored(fitted_model):
    """The swap path's drain: a bundle replaced on the app while a row of
    the old one waits in the window; drain returns once that row is
    scored, and the in-flight request finishes on the model it started
    with (the port's hot swap itself is a later slice: the bundle is
    replaced here as the swap does)."""
    app = _batched_app(fitted_model, window_ms=30.0)
    try:
        holder = []
        t = threading.Thread(target=lambda: holder.append(
            json.loads(_post(app, "/score/v1", {"X": 50})[2])))
        t.start()
        deadline = time.monotonic() + 10
        while app.batcher.pending_depth() == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        new_model = LinearRegressor().fit(*_data(seed=2, n=200, slope=2.0), device="cpu")
        app.served = _Served(app.predictor.__class__(new_model, (1, 8, 64)),
                             new_model.info, "2026-07-02")
        assert app.batcher.drain(timeout_s=10) is True
        assert app.batcher.drain(timeout_s=0.5) is True
        t.join(timeout=10)
        assert holder and holder[0]["prediction"] == pytest.approx(26.0, abs=2.0)
        after = json.loads(_post(app, "/score/v1", {"X": 50})[2])
        assert after["model_date"] == "2026-07-02"
        assert after["prediction"] == pytest.approx(100.0, abs=2.0)
    finally:
        app.close()


def test_bundle_replaced_under_batched_http_traffic():
    """Over real HTTP with the coalescer on, eight clients hammer the
    service while its bundle is replaced by a visibly different model:
    every response pairs a prediction with the model that produced it."""
    m1 = LinearRegressor().fit(*_data(seed=1, n=400, slope=0.5), device="cpu")
    m2 = LinearRegressor().fit(*_data(seed=2, n=400, slope=2.0), device="cpu")
    handle = serve_model(m1, date(2026, 7, 1), host="127.0.0.1", port=0, block=False,
                         engine="torch", batch_window_ms=3.0, batch_max_rows=32)
    app = handle.app
    failures, results = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                req = urllib.request.Request(handle.url, data=b'{"X": 10}', method="POST",
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    body = json.loads(resp.read())
                results.append((body["model_date"], body["prediction"]))
            except Exception as exc:  # noqa: BLE001
                failures.append(repr(exc))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        predictor = app.predictor.__class__(m2, app.predictor.buckets)
        predictor.warmup()
        app.served = _Served(predictor, m2.info, "2026-07-02")
        app.batcher.drain()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        handle.stop()
    assert not failures, failures[:5]
    assert {d for d, _ in results} == {"2026-07-01", "2026-07-02"}
    for d, pred in results:
        want = 5.0 if d == "2026-07-01" else 20.0
        assert abs(pred - want) < 2.5, (d, pred)
    stats = app.batcher.stats()
    assert stats["rows_dispatched"] == stats["rows_submitted"] > 0


def test_replica_apps_each_own_a_coalescer_with_the_knobs(fitted_model):
    """The knobs reach every replica: each app gets its own coalescer
    (replicas never share one, as the JAX workers do not)."""
    handle = serve_model(fitted_model, DAY, host="127.0.0.1", port=0, block=False,
                         engine="torch", replicas=2, batch_window_ms=1.5,
                         batch_max_rows=16)
    try:
        batchers = [app.batcher for app in handle.replica_apps]
        assert len(batchers) == 2 and batchers[0] is not batchers[1]
        assert all(b.window_s == 0.0015 and b.max_rows == 16 for b in batchers)
        health = handle.app.healthz_payload()["effective_config"]
        assert health["batch_window_ms"] == 1.5 and health["batch_max_rows"] == 16
    finally:
        handle.stop()
    # stop flushed and stopped every dispatcher
    assert all(b._stopped for b in batchers)


def test_cli_serve_batch_flags_parse(monkeypatch):
    """The flags parse, env vars supply defaults, a non-positive
    --batch-max-rows is a usage error, and a malformed env value is
    ignored rather than fatal."""
    for var in ("BODYWORK_TPU_BATCH_WINDOW_MS", "BODYWORK_TPU_BATCH_MAX_ROWS"):
        monkeypatch.delenv(var, raising=False)
    parser = cli.build_parser()
    args = parser.parse_args(["serve", "--store", "/tmp/s", "--batch-window-ms", "1.5",
                              "--batch-max-rows", "32"])
    assert args.batch_window_ms == 1.5 and args.batch_max_rows == 32
    args = parser.parse_args(["serve", "--store", "/tmp/s"])
    assert args.batch_window_ms is None and args.batch_max_rows is None
    with pytest.raises(SystemExit):
        parser.parse_args(["serve", "--store", "/tmp/s", "--batch-max-rows", "0"])
    monkeypatch.setenv("BODYWORK_TPU_BATCH_WINDOW_MS", "2.5")
    monkeypatch.setenv("BODYWORK_TPU_BATCH_MAX_ROWS", "48")
    args = cli.build_parser().parse_args(["serve", "--store", "/tmp/s"])
    assert args.batch_window_ms == 2.5 and args.batch_max_rows == 48
    monkeypatch.setenv("BODYWORK_TPU_BATCH_WINDOW_MS", "2ms")
    monkeypatch.setenv("BODYWORK_TPU_BATCH_MAX_ROWS", "-5")
    args = cli.build_parser().parse_args(["serve", "--store", "/tmp/s"])
    assert args.batch_window_ms is None and args.batch_max_rows is None


def test_reconfigure_applies_at_the_next_batch_and_validates():
    coalescer = RequestCoalescer(window_ms=5.0, max_rows=8)
    assert coalescer.reconfigure(window_ms=1.25, max_rows=3) == {"window_ms": 1.25,
                                                                 "max_rows": 3}
    assert coalescer.stats()["window_ms"] == 1.25 and coalescer.stats()["max_rows"] == 3
    with pytest.raises(ValueError):
        coalescer.reconfigure(window_ms=0)
    with pytest.raises(ValueError):
        coalescer.reconfigure(max_rows=0)
    with pytest.raises(ValueError):
        RequestCoalescer(window_ms=0)


def test_stats_json_serialisable(fitted_model):
    app = _batched_app(fitted_model, window_ms=5.0)
    try:
        _post(app, "/score/v1", {"X": 50})
        stats = app.batcher.stats()
        assert json.loads(json.dumps(stats)) == stats
        assert stats["rows_submitted"] == 1
    finally:
        app.close()
