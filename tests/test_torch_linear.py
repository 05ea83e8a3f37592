"""The closed-form linear model: the port's fused OLS fit + held-out eval
against ``_ols_fit_eval`` on the same padded splits, the host float64
normal equations, and linear checkpoints across both packages."""
import io
import json
from datetime import date

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.models import linear as jax_linear
from bodywork_tpu.models.base import Regressor as JaxRegressor
from bodywork_tpu.models.base import train_test_split
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.models import linear
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

#: the coefficients' bar: both packages solve the same float32 normal
#: equations, summed in another order
COEF_ATOL = 1e-4
#: the port's own distance from the float64 solution of the same normal
#: equations: it sums each Gram entry as a reduction, not as a long
#: float32 dot product
EXACT_ATOL = 2e-5
#: the held-out metrics: float32 reductions of nearly the same predictions
METRIC_RTOL = 1e-5


def _day_like(seed: int, n: int, features: int = 1):
    """Rows shaped like the generator's: X ~ U(0, 100), y = 1 + 0.5 X + noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (n, features)).astype(np.float32)
    y = (1.0 + 0.5 * X.sum(1) + rng.normal(0, 10, n)).astype(np.float32)
    keep = y >= 0
    return X[keep], y[keep]


def _splits(seed: int, n: int, features: int = 1):
    X, y = _day_like(seed, n, features)
    s = train_test_split(X, y)
    return JaxRegressor._pad_splits(s.X_train, s.y_train, s.X_test, s.y_test)


def _theta(params) -> np.ndarray:
    return np.r_[np.asarray(params["w"], dtype=np.float64).ravel(), float(params["b"])]


def _exact_theta(Xtr, ytr, wtr, fit_intercept: bool) -> np.ndarray:
    A = Xtr.astype(np.float64)
    if fit_intercept:
        A = np.concatenate([A, np.ones((len(A), 1))], axis=1)
    Aw = A * wtr[:, None]
    theta = np.linalg.solve(Aw.T @ A, Aw.T @ ytr.astype(np.float64))
    return theta if fit_intercept else np.r_[theta, 0.0]


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("seed,n,features", [(0, 1440, 1), (1, 7 * 1440, 1), (2, 3000, 3)])
def test_ols_fit_eval_matches_jax(seed, n, features, fit_intercept):
    """One day and seven days of the pipeline's rows, and three features."""
    arrays = _splits(seed, n, features)
    params, m = linear._ols_fit_eval(*(torch.from_numpy(a) for a in arrays), 0.0,
                                     fit_intercept=fit_intercept)
    ref_params, packed = jax_linear._ols_fit_eval(
        *(jnp.asarray(a) for a in arrays), jnp.float32(0.0), fit_intercept=fit_intercept,
    )
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(ref_params["w"]), atol=COEF_ATOL)
    np.testing.assert_allclose(float(params["b"]), float(ref_params["b"]), atol=COEF_ATOL)
    np.testing.assert_allclose([float(v) for v in m], np.asarray(packed)[-3:], rtol=METRIC_RTOL)
    np.testing.assert_allclose(_theta(params), _exact_theta(*arrays[:3], fit_intercept),
                               atol=EXACT_ATOL)


@pytest.mark.parametrize("seed,n,features", [(5, 3000, 2), (8, 30 * 1440, 1)])
def test_ols_against_the_float64_solution(seed, n, features):
    """Where the float32 normal equations are worse conditioned (two
    features, or 30 days of rows), the JAX package's own float32 solution
    drifts by more than 1e-4 from the float64 one (its Gram matrix is one
    long float32 dot product), so the two packages agree to 1e-4 beyond
    that distance, and the port itself stays within 2e-5 of the float64
    solution."""
    arrays = _splits(seed, n, features)
    exact = _exact_theta(*arrays[:3], fit_intercept=True)
    params, _ = linear._ols_fit_eval(*(torch.from_numpy(a) for a in arrays), 0.0)
    ref_params, _ = jax_linear._ols_fit_eval(*(jnp.asarray(a) for a in arrays), jnp.float32(0.0))
    port, ref = _theta(params), _theta(ref_params)
    np.testing.assert_allclose(port, exact, atol=EXACT_ATOL)
    jax_error = float(np.abs(ref - exact).max())
    np.testing.assert_allclose(port, ref, atol=COEF_ATOL + jax_error)


def test_regressor_fit_and_evaluate_match_jax():
    X, y = _day_like(3, 4000)
    s = train_test_split(X, y)
    fitted, got = linear.LinearRegressor().fit_and_evaluate(
        s.X_train, s.y_train, s.X_test, s.y_test, device="cpu")
    ref, want = jax_linear.LinearRegressor().fit_and_evaluate(
        s.X_train, s.y_train, s.X_test, s.y_test)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=METRIC_RTOL)
    np.testing.assert_allclose(fitted.predict(s.X_test), ref.predict(s.X_test),
                               rtol=1e-5, atol=COEF_ATOL)
    # fit alone and the standalone evaluate give the same model and numbers
    alone = linear.LinearRegressor().fit(s.X_train, s.y_train, device="cpu")
    np.testing.assert_array_equal(alone.params["w"].numpy(), fitted.params["w"].numpy())
    np.testing.assert_allclose(list(alone.evaluate(s.X_test, s.y_test).values()),
                               list(got.values()), rtol=METRIC_RTOL)
    assert fitted.info == ref.info == "LinearRegressor(closed_form_ols)"
    assert fitted.n_features == ref.n_features == 1


def test_ridge_term_matches_jax():
    X, y = _day_like(4, 2000, 2)
    cfg = dict(l2=25.0)
    port = linear.LinearRegressor(linear.LinearConfig(**cfg)).fit(X, y, device="cpu")
    ref = jax_linear.LinearRegressor(jax_linear.LinearConfig(**cfg)).fit(X, y)
    np.testing.assert_allclose(port.params["w"].numpy(), np.asarray(ref.params["w"]),
                               atol=COEF_ATOL)


@pytest.mark.parametrize("features", [1, 4])
def test_gram_stats_and_solve_normal_eq_equal(features):
    X, y = _day_like(5, 2500, features)
    G, c = linear.gram_stats(X, y)
    rG, rc = jax_linear.gram_stats(X, y)
    np.testing.assert_array_equal(G, rG)
    np.testing.assert_array_equal(c, rc)
    for cfg in ({}, {"l2": 3.0}, {"fit_intercept": False}):
        got = linear.solve_normal_eq(G, c, linear.LinearConfig(**cfg))
        want = jax_linear.solve_normal_eq(rG, rc, jax_linear.LinearConfig(**cfg))
        np.testing.assert_array_equal(got["w"], want["w"])
        assert got["b"] == want["b"]


def test_jax_linear_checkpoint_loads_and_scores_in_the_port(tmp_path):
    X, y = _day_like(6, 1500)
    ref = jax_linear.LinearRegressor().fit(X, y)
    model = port_ckpt.load_model_bytes(jax_ckpt.save_model_bytes(ref), device="cpu")
    assert isinstance(model, linear.LinearRegressor)
    np.testing.assert_allclose(model.predict(X), ref.predict(X), rtol=1e-6, atol=1e-5)
    # and through one store directory
    jax_ckpt.save_model(JaxStore(tmp_path), ref, date(2026, 7, 1))
    loaded, d = port_ckpt.load_model(FilesystemStore(tmp_path), device="cpu")
    assert d == date(2026, 7, 1) and loaded.info == ref.info


def test_port_linear_checkpoint_loads_and_scores_in_jax():
    X, y = _day_like(7, 1500)
    port = linear.LinearRegressor().fit(X, y, device="cpu")
    data = port_ckpt.save_model_bytes(port)
    back = jax_ckpt.load_model_bytes(data)
    assert isinstance(back, jax_linear.LinearRegressor)
    np.testing.assert_allclose(back.predict(X), port.predict(X), rtol=1e-6, atol=1e-5)
    with np.load(io.BytesIO(data)) as npz, np.load(io.BytesIO(jax_ckpt.save_model_bytes(back))) as ref:
        assert sorted(npz.files) == sorted(ref.files) == ["__meta__", "b", "w"]
        assert npz["b"].shape == ref["b"].shape == ()


def test_linear_checkpoints_serve_across_packages(tmp_path):
    """A JAX-written linear checkpoint serves in the port (the `torch`
    engine, which `auto` picks for it) and a port-written one in the JAX
    package, with the same answers on the same bytes of request."""
    from bodywork_tpu.serve import create_app
    from bodywork_tpu_torch.serve import serve_latest_model

    X, y = _day_like(9, 1500)
    ref = jax_linear.LinearRegressor().fit(X, y)
    jax_ckpt.save_model(JaxStore(tmp_path / "a"), ref, date(2026, 7, 1))
    handle = serve_latest_model(tmp_path / "a", host="127.0.0.1", port=0, block=False,
                                device="cpu")
    try:
        status, _, body = handle.app.handle("POST", "/score/v1/batch",
                                            b'{"X": [0.0, 50.0, 100.0]}', "application/json")
        health = handle.app.healthz_payload()
    finally:
        handle.stop()
    assert status == 200 and health["engine"] == "torch"
    assert health["model_info"] == "LinearRegressor(closed_form_ols)"
    got = json.loads(body)["predictions"]
    np.testing.assert_allclose(got, ref.predict(np.array([0.0, 50.0, 100.0], np.float32)),
                               rtol=1e-6, atol=1e-5)

    port = linear.LinearRegressor().fit(X, y, device="cpu")
    key = port_ckpt.save_model(FilesystemStore(tmp_path / "b"), port, date(2026, 7, 2))
    model, d = jax_ckpt.load_model(JaxStore(tmp_path / "b"))
    client = create_app(model, d, model_key=key).test_client()
    answer = client.post("/score/v1", json={"X": 50}).get_json()
    np.testing.assert_allclose(answer["prediction"], port.predict(np.array([50.0]))[0],
                               rtol=1e-6, atol=1e-5)
    assert answer["model_info"] == "LinearRegressor(closed_form_ols)"
