"""The serving app's prediction-sanity firewall against the JAX app's: the
same verdicts and bounds, a 500 for a non-finite production prediction
that never serialises the value, and an out-of-band prediction served."""
import json
import math
import urllib.error
import urllib.request
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.serve.app import as_bounds as jax_as_bounds
from bodywork_tpu.serve.app import sanity_violation as jax_sanity_violation
from bodywork_tpu_torch.models import LinearConfig, LinearRegressor
from bodywork_tpu_torch.serve import ScoringApp, as_bounds, sanity_violation, serve_model

torch.set_num_threads(1)

BOUNDS = [
    None, {"lo": -1.0, "hi": 2.0}, (0.0, 5.0), [3, 4], {"lo": 2.0, "hi": 1.0},
    {"lo": "x", "hi": 1}, {"lo": float("nan"), "hi": 1.0}, {"hi": 1.0}, (1.0,), "12",
    {"lo": -math.inf, "hi": 0.0}, (7, 7),
]
PREDICTIONS = [
    0.5, [0.0, 1.0, 2.0], [np.nan], [1.0, np.inf], -np.inf, [-5.0, 0.0], [3.5, 9.0],
    np.array([[2.0], [1.0]], np.float32), [],
]


@pytest.mark.parametrize("bounds", BOUNDS, ids=repr)
def test_as_bounds_equals_jaxs(bounds):
    assert as_bounds(bounds) == jax_as_bounds(bounds)


@pytest.mark.parametrize("bounds", BOUNDS[:4], ids=repr)
@pytest.mark.parametrize("predictions", PREDICTIONS, ids=repr)
def test_sanity_violation_equals_jaxs(predictions, bounds):
    pair = as_bounds(bounds)
    assert sanity_violation(predictions, pair) == jax_sanity_violation(predictions, pair)


class _Constant:
    """A predictor answering one value for every row."""

    engine = "torch"
    device = torch.device("cpu")

    def __init__(self, value: float):
        self.value = value

    def predict(self, X):
        return np.full(np.asarray(X).reshape(-1).shape[0], self.value, np.float32)

    def warmup(self):
        pass


def _model():
    params = {"w": torch.zeros(1, 1), "b": torch.zeros(1)}
    return LinearRegressor(LinearConfig(), params)


@pytest.mark.parametrize("path,body", [
    ("/score/v1", {"X": 50}), ("/score/v1/batch", {"X": [1.0, 2.0, 3.0]}),
])
def test_a_nan_model_answers_500_and_never_serialises_the_value(path, body):
    app = ScoringApp(_model(), date(2026, 7, 1), predictor=_Constant(float("nan")),
                     model_key="models/regressor-2026-07-01.npz", model_source="production")
    status, headers, payload = app.handle("POST", path, json.dumps(body).encode(),
                                          "application/json")
    assert status == 500
    assert json.loads(payload) == {"error": "internal server error"}
    assert b"NaN" not in payload and b"nan" not in payload


@pytest.mark.parametrize("value,inside", [(5.0, True), (500.0, False)])
def test_an_out_of_band_prediction_is_served(value, inside, caplog):
    app = ScoringApp(_model(), date(2026, 7, 1), predictor=_Constant(value),
                     model_source="production", model_bounds={"lo": 0.0, "hi": 10.0})
    status, _, payload = app.handle("POST", "/score/v1", b'{"X": 1}', "application/json")
    assert status == 200 and json.loads(payload)["prediction"] == value
    assert ("out of sanity band" in caplog.text) is not inside


def test_a_nan_model_answers_500_over_http():
    handle = serve_model(_model(), date(2026, 7, 1), host="127.0.0.1", port=0, block=False,
                         engine="torch", model_source="production")
    try:
        handle.app.served.predictor = _Constant(float("nan"))
        req = urllib.request.Request(handle.url, data=b'{"X": 50}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 500
        assert json.loads(err.value.read()) == {"error": "internal server error"}
    finally:
        handle.stop()
