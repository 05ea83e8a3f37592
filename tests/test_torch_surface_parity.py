"""Parity of the names the surface guard (``test_torch_surface.py``) found
missing and this slice ported, each against the JAX function of the same
name on the same inputs: the in-process ``test_client()`` of the four
apps, ``Regressor.host_params`` / ``predict_device`` /
``predict_padded``, ``make_eval_fn``, ``registry_exists``,
``innermost_backend_label``, ``load_metric_history`` and the
``ScoringApp`` stream and sanity counters."""
import json
import math
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.chaos.http import FlakyScoringMiddleware as JaxFlaky
from bodywork_tpu.chaos.plan import FaultPlan as JaxFaultPlan
from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.models.linear import LinearConfig as JaxLinearConfig
from bodywork_tpu.models.linear import LinearRegressor as JaxLinear
from bodywork_tpu.models.metrics import make_eval_fn as jax_make_eval_fn
from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLP
from bodywork_tpu.monitor.analytics import load_metric_history as jax_load_metric_history
from bodywork_tpu.registry import registry_exists as jax_registry_exists
from bodywork_tpu.serve import create_app as jax_create_app
from bodywork_tpu.serve import frontend as jax_frontend
from bodywork_tpu.serve import rowqueue as jax_rowqueue
from bodywork_tpu.serve.server import RoundRobinApp as JaxRoundRobin
from bodywork_tpu.store import open_store as jax_open_store
from bodywork_tpu.store.base import innermost_backend_label as jax_innermost_backend_label
from bodywork_tpu.store.resilient import ResilientStore as JaxResilientStore
from bodywork_tpu.train import train_on_history as jax_train_on_history
from bodywork_tpu_torch.chaos.http import FlakyScoringMiddleware
from bodywork_tpu_torch.chaos.plan import FaultPlan
from bodywork_tpu_torch.models.base import pad_rows
from bodywork_tpu_torch.models.linear import LinearConfig, LinearRegressor
from bodywork_tpu_torch.models.metrics import make_eval_fn
from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor, params_from_jax
from bodywork_tpu_torch.monitor import load_metric_history
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.registry import ModelRegistry, registry_exists
from bodywork_tpu_torch.serve import frontend, rowqueue
from bodywork_tpu_torch.serve.app import create_app
from bodywork_tpu_torch.serve.predictor import PaddedPredictor
from bodywork_tpu_torch.serve.server import RoundRobinApp
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.store.base import innermost_backend_label
from bodywork_tpu_torch.store.resilient import ResilientStore

torch.set_num_threads(1)

DAY = date(2026, 7, 1)
#: f32 apply against XLA (``tests/test_ops.py:42``)
TOL = 2e-4
#: pandas' default CSV float parser is not round-trip (``tests/test_torch_ab.py``)
PANDAS_PARSE_RTOL = 1e-11


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (n, 1)).astype(np.float32)
    y = (0.5 * X[:, 0] + 3.0 + rng.normal(0, 1, n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def models():
    """A linear model and a (16, 8) MLP fitted by the JAX package, and the
    port's models on the same parameters (the weight converter)."""
    X, y = _data(0, 300)
    jax_linear = JaxLinear(JaxLinearConfig()).fit(X, y)
    jax_mlp = JaxMLP(JaxMLPConfig(hidden=(16, 8), n_steps=50)).fit(X, y)
    return {
        "linear": (jax_linear, LinearRegressor(
            LinearConfig(), params_from_jax(jax_linear.host_params(), "cpu"))),
        "mlp": (jax_mlp, MLPRegressor(MLPConfig(hidden=(16, 8)),
                                      params_from_jax(jax_mlp.host_params(), "cpu"))),
    }


# -- test_client() -------------------------------------------------------

class _StubClient:
    """A row-queue client that answers at once, twice each row (the
    rowqueue test's stand-in for a dispatcher)."""

    def __init__(self, reply_mod):
        self.reply_mod = reply_mod

    def submit(self, X, kind, on_done, trace_id=None):
        on_done(self.reply_mod._Reply(200, np.asarray(X, np.float32).ravel() * 2.0,
                                      "k-2026-07-01", "Stub(x2)", "2026-07-01"))

    def dispatcher_up(self):
        return True

    def stats(self):
        return {"dispatcher_up": True, "requests_submitted": 0, "rows_submitted": 0,
                "replies_received": 0, "failures": 0, "in_flight": 0, "slots": 16,
                "slots_free": 16}


def _scoring_apps(models):
    jax_model, port_model = models["linear"]
    kw = dict(model_key="models/surface-parity", model_source="latest")
    return (jax_create_app(jax_model, DAY, **kw),
            create_app(port_model, DAY, predictor=PaddedPredictor(port_model), **kw))


def _apps(kind: str, models):
    if kind == "frontend":
        return (jax_frontend.FrontendApp(_StubClient(jax_rowqueue)),
                frontend.FrontendApp(_StubClient(rowqueue)))
    if kind == "round-robin":
        pairs = [_scoring_apps(models) for _ in range(2)]
        return JaxRoundRobin([j for j, _ in pairs]), RoundRobinApp([p for _, p in pairs])
    jax_app, port_app = _scoring_apps(models)
    if kind == "flaky":  # a plan that injects nothing: the request passes through
        return JaxFlaky(jax_app, JaxFaultPlan()), FlakyScoringMiddleware(port_app, FaultPlan())
    return jax_app, port_app


REQUESTS = {
    "score": ("POST", "/score/v1", {"X": 50}),
    "batch": ("POST", "/score/v1/batch", {"X": [1.5, 2.25, 3.0]}),
    "healthz": ("GET", "/healthz", None),
    "not-found": ("GET", "/no-such-route", None),
}


@pytest.mark.parametrize("request_name", sorted(REQUESTS))
@pytest.mark.parametrize("kind", ["scoring", "round-robin", "flaky", "frontend"])
def test_client_answers_the_jax_clients_status_and_body(kind, request_name, models):
    jax_app, port_app = _apps(kind, models)
    method, path, payload = REQUESTS[request_name]
    kw = {} if payload is None else {"json": payload}
    want = jax_app.test_client().open(path, method=method, **kw)
    got = port_app.test_client().open(path, method=method, **kw)
    assert got.status_code == want.status_code
    if request_name == "healthz":
        del got.headers["Content-Length"], want.headers["Content-Length"]
    assert got.headers == dict(want.headers)
    if request_name == "healthz":
        # the JAX document's keys and values; the port appends its own
        # (engine, device, launches, graph cache) after them
        doc, jax_doc = got.get_json(), want.get_json()
        assert list(doc)[:len(jax_doc)] == list(jax_doc)
        assert {k: doc[k] for k in jax_doc} == jax_doc
    else:
        assert got.data == want.data
    assert got.get_json() is not None


def test_flaky_clients_inject_the_jax_faults(models):
    """The same seeded refusals (the plan caps consecutive faults, so some
    requests pass), with the same bodies and headers: the client goes
    through the middleware, not around it."""
    jax_app, port_app = _scoring_apps(models)
    jax_client = JaxFlaky(jax_app, JaxFaultPlan(seed=5, http_error_p=1.0)).test_client()
    client = FlakyScoringMiddleware(port_app, FaultPlan(seed=5, http_error_p=1.0)).test_client()
    statuses = []
    for _ in range(6):
        want = jax_client.post("/score/v1", json={"X": 50})
        got = client.post("/score/v1", json={"X": 50})
        assert (got.status_code, got.data) == (want.status_code, want.data)
        assert got.headers == dict(want.headers)
        statuses.append(got.status_code)
    assert {429, 503} & set(statuses), statuses
    assert client.get("/healthz").status_code == 200  # only scoring routes fail


# -- the Regressor methods ------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "mlp"])
@pytest.mark.parametrize("n", [1, 7, 256, 300])
def test_predict_padded_and_predict_device_match_jax(kind, n, models):
    jax_model, port_model = models[kind]
    X = _data(1, n)[0]
    np.testing.assert_allclose(port_model.predict_padded(X), jax_model.predict_padded(X),
                               rtol=TOL, atol=TOL)
    on_device = port_model.predict_device(X)
    assert isinstance(on_device, torch.Tensor) and on_device.device == port_model.device
    np.testing.assert_allclose(on_device.numpy(), np.asarray(jax_model.predict_device(X)),
                               rtol=TOL, atol=TOL)
    # the padding rows never reach an answer
    np.testing.assert_array_equal(port_model.predict_padded(X), port_model.predict(X))


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_host_params_are_the_jax_host_params(kind, models):
    jax_model, port_model = models[kind]
    got, want = port_model.host_params(), jax_model.host_params()

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, np.asarray(tree)

    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert list(got_leaves) == list(want_leaves)
    for path, value in want_leaves.items():
        assert got_leaves[path].shape == value.shape, path
        np.testing.assert_array_equal(got_leaves[path], value.astype(np.float32))


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_make_eval_fn_matches_the_jax_metrics(kind, models):
    jax_model, port_model = models[kind]
    X, y = _data(2, 700)
    Xp, yp, w = pad_rows(X, y, minimum=256)
    want = jax_make_eval_fn(type(jax_model).apply)(jax_model.params, Xp, yp, w)
    got = make_eval_fn(type(port_model).apply)(
        port_model.params, *(torch.from_numpy(a) for a in (Xp, yp, w)))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(list(port_model.evaluate(X, y).values()),
                               list(jax_model.evaluate(X, y).values()), rtol=TOL, atol=TOL)


# -- stores both packages wrote --------------------------------------------

@pytest.fixture(scope="module")
def shared_store(tmp_path_factory):
    """Two days of the port's linear loop (datasets, checkpoints, both
    metrics histories, a gated registry), then a third day trained by the
    JAX package on the same directory."""
    root = tmp_path_factory.mktemp("shared") / "store"
    LocalRunner(default_pipeline("linear"), open_store(root), device="cpu").run_simulation(DAY, 2)
    third = date(2026, 7, 3)
    jax_store = jax_open_store(str(root))
    if not jax_store.exists(f"datasets/regression-dataset-{third}.csv"):
        X, y = jax_generate_day(third)
        jax_persist_dataset(jax_store, JaxDataset(X, y, third))
    jax_train_on_history(jax_store, "linear")
    return root


def test_load_metric_history_gives_the_jax_frames_columns_and_rows(shared_store):
    got = load_metric_history(open_store(shared_store))
    want = jax_load_metric_history(jax_open_store(str(shared_store)))
    for table, frame in zip(got, want):
        assert list(table) == list(frame.columns)
        assert len(frame) >= 2
        for column in frame.columns:
            values, expected = table[column], frame[column].to_numpy()
            assert len(values) == len(expected), column
            if column == "date":
                assert list(values) == list(expected)
            else:
                assert values.dtype == expected.dtype, column
                np.testing.assert_allclose(values, expected, rtol=PANDAS_PARSE_RTOL,
                                           equal_nan=True, err_msg=column)


def test_load_metric_history_of_an_empty_store_is_empty(tmp_path):
    assert load_metric_history(open_store(tmp_path)) == ({}, {})
    assert all(frame.empty for frame in jax_load_metric_history(jax_open_store(str(tmp_path))))


def test_registry_exists_gives_the_jax_answer(tmp_path, shared_store):
    jax_store = jax_open_store(str(tmp_path))
    X, y = jax_generate_day(DAY)
    jax_persist_dataset(jax_store, JaxDataset(X, y, DAY))
    result = jax_train_on_history(jax_store, "linear")  # a candidate, no alias yet
    store = open_store(tmp_path)
    assert registry_exists(store) is jax_registry_exists(jax_store) is False
    ModelRegistry(store).promote(result.model_artefact_key, day=DAY)
    assert registry_exists(store) is jax_registry_exists(jax_store) is True
    # the port's gated loop left an alias the JAX package sees too
    assert registry_exists(open_store(shared_store)) is jax_registry_exists(
        jax_open_store(str(shared_store))) is True


@pytest.mark.parametrize("wrapped", [False, True])
def test_innermost_backend_label_gives_the_jax_answer(tmp_path, wrapped):
    store, jax_store = open_store(tmp_path), jax_open_store(str(tmp_path))
    if wrapped:
        store, jax_store = ResilientStore(store), JaxResilientStore(jax_store)
    label = innermost_backend_label(store)
    assert label == jax_innermost_backend_label(jax_store)
    assert label is not None


# -- the ScoringApp counters ------------------------------------------------

FAMILIES = ("bodywork_tpu_serve_model_requests_total", "bodywork_tpu_serve_model_errors_total",
            "bodywork_tpu_serve_model_latency_seconds",
            "bodywork_tpu_serve_sanity_violations_total")


def _family_lines(text: str, model_key: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith(FAMILIES) and f'model_key="{model_key}"' in line]


def test_scoring_app_counters_leave_the_jax_metric_text(models):
    jax_app, port_app = _scoring_apps(models)
    key = "models/counter-parity"
    for app in (jax_app, port_app):
        served = app.served_bundle
        assert served is not None and app.model_info == served.model_info
        served.model_key = key
        app.count_stream_request(served, "canary")
        app.count_stream_error(served, "canary")
        for seconds in (0.0004, 0.013, 0.013, 2.5):
            app.observe_stream_latency(served, "production", seconds)
        app.count_sanity_violation(served, "canary", "non_finite")
        app.count_sanity_violation(served, "production", "out_of_range")
    want = _family_lines(jax_app.test_client().get("/metrics").data.decode(), key)
    got = _family_lines(port_app.test_client().get("/metrics").data.decode(), key)
    assert got == want
    assert len(got) > 10 and any(math.isclose(float(line.rsplit(" ", 1)[1]), 2.5264)
                                 for line in got if "_sum" in line)


def test_model_info_is_none_before_the_first_model():
    from bodywork_tpu_torch.serve.app import ScoringApp

    app = ScoringApp(None)
    assert app.served_bundle is None and app.model_info is None
    assert json.loads(app.test_client().get("/healthz").data)["model_info"] is None
