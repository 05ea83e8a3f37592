"""The port's SLO watchdog (``bodywork_tpu_torch.ops.slo``) against the JAX
package's: ``SloPolicy.verdict``, ``policy_from_env`` and
``histogram_quantile`` equal on the same inputs, the service-wide window
deltas, and the watchdog's abort and promote on a live canary with the
same alias documents, the latency streak, the window restart on a
production change, and the flight record it dumps read back by ``cli trace
show``."""
import itertools
import json
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.ops import slo as jax_slo
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import checkpoint as ckpt
from bodywork_tpu_torch.obs.tracing import configured_tracing
from bodywork_tpu_torch.ops import slo
from bodywork_tpu_torch.ops.slo import SloPolicy, SloWatchdog
from bodywork_tpu_torch.registry import ModelRegistry, read_aliases
from bodywork_tpu_torch.registry import records as rec
from bodywork_tpu_torch.serve import PaddedPredictor, create_app
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import model_key

torch.set_num_threads(1)

D1, D2, D3 = date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3)
KEY1, KEY2, KEY3 = model_key(D1), model_key(D2), model_key(D3)
BOUNDS = {"lo": -30.0, "hi": 90.0}


def _windows():
    rng = np.random.default_rng(0)
    for _ in range(300):
        p99 = rng.choice([None, 0.0, 0.001, 0.004, 0.02])
        c99 = rng.choice([None, 0.001, 0.003, 0.01, 0.5])
        yield {
            "requests": int(rng.integers(0, 60)), "errors": int(rng.integers(0, 5)),
            "violations": int(rng.integers(0, 3)) * int(rng.random() < 0.3),
            "canary_p99_s": c99, "production_p99_s": p99,
            "canary_latency_samples": int(rng.integers(0, 160)),
            "production_latency_samples": int(rng.integers(0, 160)),
        }


@pytest.mark.parametrize("knobs", [
    {}, {"min_requests": 5, "max_error_rate": 0.1, "min_latency_samples": 3},
    {"max_sanity_violations": 1, "burn_rate_threshold": 2.0, "max_p99_latency_ratio": 1.5},
])
def test_verdicts_equal_jaxs_over_seeded_windows(knobs):
    port, ref = SloPolicy(**knobs), jax_slo.SloPolicy(**knobs)
    verdicts = [port.verdict(w) for w in _windows()]
    assert verdicts == [ref.verdict(w) for w in _windows()]
    assert {"sanity", "error_budget", "latency", None} >= set(verdicts)
    assert len(set(verdicts)) >= 3


@pytest.mark.parametrize("env", [
    {},
    {"BODYWORK_TPU_SLO_WINDOW_REQUESTS": "300", "BODYWORK_TPU_SLO_MAX_ERROR_RATE": "0.1",
     "BODYWORK_TPU_SLO_MAX_SANITY_VIOLATIONS": "2"},
    {"BODYWORK_TPU_SLO_WINDOW_REQUESTS": "banana", "BODYWORK_TPU_SLO_MAX_ERROR_RATE": "-3",
     "BODYWORK_TPU_SLO_MAX_P99_RATIO": "4.5"},
    {"BODYWORK_TPU_SLO_MAX_ERROR_RATE": "1.5", "BODYWORK_TPU_SLO_MIN_REQUESTS": "7",
     "BODYWORK_TPU_SLO_PROMOTE_AFTER_REQUESTS": "0"},
])
def test_policy_from_env_equals_jaxs(env, monkeypatch):
    for name in ("WINDOW_REQUESTS", "MIN_REQUESTS", "MAX_ERROR_RATE", "MAX_P99_RATIO",
                 "MAX_SANITY_VIOLATIONS", "PROMOTE_AFTER_REQUESTS"):
        monkeypatch.delenv(f"BODYWORK_TPU_SLO_{name}", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert slo.policy_from_env().__dict__ == jax_slo.policy_from_env().__dict__


def test_histogram_quantile_equals_jaxs():
    rng = np.random.default_rng(1)
    bounds = [0.001, 0.005, 0.01, 0.1, 1.0]
    for counts in itertools.chain(
            ([0] * 6, [100, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 5]),
            (list(rng.integers(0, 20, 6)) for _ in range(50))):
        for q in (0.5, 0.9, 0.99):
            assert slo.histogram_quantile(bounds, counts, q) == jax_slo.histogram_quantile(
                bounds, counts, q)


def test_service_window_delta_equals_jaxs():
    base = {"requests": 10.0, "errors": 1.0, "bounds": [0.01, 0.1],
            "buckets": [5, 3, 2], "count": 10}
    now = {"requests": 40.0, "errors": 4.0, "bounds": [0.01, 0.1],
           "buckets": [20, 12, 8], "count": 40}
    assert slo.serve_window_delta(base, now) == jax_slo.serve_window_delta(base, now)
    assert slo.serve_window_delta({}, now) == jax_slo.serve_window_delta({}, now)
    snapshot = slo.serve_window_snapshot()
    assert set(snapshot) == {"requests", "errors", "bounds", "buckets", "count"}


def _linear_bytes(intercept: float, slope: float) -> bytes:
    from bodywork_tpu_torch.models import LinearRegressor

    params = {"w": torch.tensor([[slope]]), "b": torch.tensor([intercept])}
    from bodywork_tpu_torch.models.linear import LinearConfig

    return ckpt.save_model_bytes(LinearRegressor(LinearConfig(), params))


@pytest.fixture
def store(tmp_path):
    """Production KEY1 and a registered candidate KEY2 (KEY3 a second
    production-to-be)."""
    store = FilesystemStore(tmp_path / "store")
    for key, day, data in ((KEY1, D1, _linear_bytes(1.0, 0.5)),
                           (KEY2, D2, _linear_bytes(2.0, 0.4)),
                           (KEY3, D3, _linear_bytes(1.5, 0.45))):
        store.put_bytes(key, data)
        rec.register_candidate(store, key, day=day, prediction_bounds=BOUNDS)
    ModelRegistry(store).promote(KEY1, day=D1)
    return store


def _app(store, canary=True):
    production, _ = ckpt.load_model(store, KEY1, device="cpu")
    app = create_app(production, D1, predictor=PaddedPredictor(production, (1, 8)),
                     model_key=KEY1, model_source="production", model_bounds=BOUNDS)
    if canary:
        model, _ = ckpt.load_model(store, KEY2, device="cpu")
        app.set_canary(model, D2, PaddedPredictor(model, (1, 8)), model_key=KEY2,
                       fraction=1.0, bounds=BOUNDS)
    return app


def _score(app, n):
    for x in range(n):
        status, _h, _b = app.handle("POST", "/score/v1",
                                    json.dumps({"X": float(x)}).encode(), "application/json")
        assert status == 200


def test_a_healthy_canary_promotes_in_one_cas_with_its_flight_record(store, capsys):
    ModelRegistry(store).canary_start(KEY2, fraction=1.0, day=D2)
    app = _app(store)
    watchdog = SloWatchdog(store, [app], policy=SloPolicy(
        window_requests=60, min_requests=5, min_latency_samples=5,
        promote_after_requests=10))
    with configured_tracing(1.0, seed=4):
        assert watchdog.poll() is None
        _score(app, 12)
        assert watchdog.poll() == "promote"
    doc = read_aliases(store)
    assert (doc["production"], doc["previous"], doc["last_op"]) == (
        KEY2, KEY1, "canary_promote")
    assert app.model_key == KEY2 and app.canary_key is None
    state = app.slo_state
    assert state["state"] == "promoted" and state["verdict"] == "healthy"
    dump = state["flight_record"]
    assert dump.startswith("obs/flightrec/flight-") and "-promote-" in dump
    trace_id = json.loads(store.get_bytes(dump))["traces"][0]["trace_id"]
    capsys.readouterr()
    assert cli.main(["trace", "show", trace_id, "--store", str(store.root)]) == 0
    assert json.loads(capsys.readouterr().out)["dump"] == dump


def test_a_latency_verdict_must_persist_before_it_aborts(store, monkeypatch):
    ModelRegistry(store).canary_start(KEY2, fraction=1.0, day=D2)
    app = _app(store)
    watchdog = SloWatchdog(store, [app], policy=SloPolicy(
        min_latency_samples=1, latency_breach_polls=2, min_requests=1))
    breaching = {"requests": 10, "errors": 0, "violations": 0, "canary_p99_s": 1.0,
                 "production_p99_s": 0.001, "canary_latency_samples": 10,
                 "production_latency_samples": 10}
    healthy = {**breaching, "canary_p99_s": 0.001}
    windows = iter([breaching, healthy, breaching, breaching])
    monkeypatch.setattr(SloWatchdog, "_window_deltas",
                        staticmethod(lambda base, now: next(windows)))
    assert watchdog.poll() is None
    assert watchdog.poll() is None
    assert app.slo_state["window"]["latency_breach_streak"] == 1
    assert watchdog.poll() is None
    assert watchdog.poll() is None
    assert watchdog.poll() == "abort"
    assert app.canary_key is None
    record = rec.load_record(store, KEY2)
    assert record["status"] == "rejected"
    assert record["history"][-1]["reason"].startswith("slo breach: latency")


def test_a_production_change_restarts_the_window(store):
    registry = ModelRegistry(store)
    registry.canary_start(KEY2, fraction=1.0, day=D2)
    app = _app(store)
    watchdog = SloWatchdog(store, [app], policy=SloPolicy(min_requests=1,
                                                          promote_after_requests=10_000))
    assert watchdog.poll() is None
    _score(app, 3)
    assert watchdog.poll() is None and len(watchdog._snapshots) >= 2
    registry.promote(KEY3, day=D3)
    model, _ = ckpt.load_model(store, KEY3, device="cpu")
    app.swap_model(model, D3, model_key=KEY3, model_source="production")
    assert watchdog.poll() is None
    assert all(s["production_key"] == KEY3 for s in watchdog._snapshots)


def test_the_watchdog_metric_families_are_jaxs():
    from bodywork_tpu_torch.obs import get_registry

    SloWatchdog(FilesystemStore.__new__(FilesystemStore), [_FakeApp()])
    names = {"bodywork_tpu_slo_watchdog_state", "bodywork_tpu_slo_burn_rate_ratio",
             "bodywork_tpu_slo_p99_latency_ratio", "bodywork_tpu_slo_breaches_total",
             "bodywork_tpu_slo_canary_promotions_total",
             "bodywork_tpu_flight_record_dumps_total"}
    assert all(get_registry().get(n) is not None for n in names)
    assert (slo.REQUESTS_METRIC, slo.ERRORS_METRIC, slo.LATENCY_METRIC,
            slo.VIOLATIONS_METRIC, slo.SERVICE_REQUESTS_METRIC,
            slo.SERVICE_LATENCY_METRIC) == (
        jax_slo.REQUESTS_METRIC, jax_slo.ERRORS_METRIC, jax_slo.LATENCY_METRIC,
        jax_slo.VIOLATIONS_METRIC, jax_slo.SERVICE_REQUESTS_METRIC,
        jax_slo.SERVICE_LATENCY_METRIC)


class _FakeApp:
    canary_key = None
    model_key = None
    slo_state = None
