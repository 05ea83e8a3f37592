"""The held-out metrics, the train/test split and the MLP's scaler: the
port against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models import base as jax_base
from bodywork_tpu.models import fused as jax_fused
from bodywork_tpu.models import metrics as jax_metrics
from bodywork_tpu.models import mlp as jax_mlp
from bodywork_tpu_torch.models import base, metrics, mlp

torch.set_num_threads(1)

#: float32 reductions summed in another order by XLA and by torch: the
#: metrics agree to a few float32 ulps of their scale
RTOL = 2e-6


def _case(seed: int, n: int, minimum: int = 256):
    rng = np.random.default_rng(seed)
    y = rng.normal(20.0, 10.0, n).astype(np.float32)
    pred = (y + rng.normal(0.0, 3.0, n)).astype(np.float32)
    return jax_base.pad_rows(y, pred, minimum=minimum)


def _port(yt, yp, w):
    return [float(v) for v in metrics._metrics(*(torch.from_numpy(a) for a in (yt, yp, w)))]


def _jax(yt, yp, w):
    return [float(v) for v in jax_metrics._metrics(*(jnp.asarray(a) for a in (yt, yp, w)))]


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 37), (2, 256), (3, 1440), (4, 5000)])
def test_masked_metrics_match_jax(seed, n):
    case = _case(seed, n)
    np.testing.assert_allclose(_port(*case), _jax(*case), rtol=RTOL)


def test_non_finite_prediction_on_a_padding_row_poisons_nothing():
    yt, yp, w = _case(5, 100)
    yp[100] = np.inf
    yp[101] = np.nan
    port, ref = _port(yt, yp, w), _jax(yt, yp, w)
    assert np.all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, rtol=RTOL)


def test_regression_metrics_match_jax():
    rng = np.random.default_rng(6)
    y = rng.uniform(1.0, 60.0, 777)
    pred = y + rng.normal(0.0, 2.0, 777)
    port, ref = metrics.regression_metrics(y, pred), jax_metrics.regression_metrics(y, pred)
    assert list(port) == list(ref) == ["MAPE", "r_squared", "max_residual"]
    np.testing.assert_allclose(list(port.values()), list(ref.values()), rtol=RTOL)


def test_metrics_dict_matches_jax():
    tail = np.array([0.5, 0.25, 3.0, 9.0], np.float32)
    assert metrics.metrics_dict(tail) == jax_fused.metrics_dict(tail)


@pytest.mark.parametrize("n,test_size,seed", [(10, 0.2, 42), (1440, 0.2, 42), (4321, 0.3, 7)])
def test_train_test_split_indices_equal(n, test_size, seed):
    X = np.arange(n, dtype=np.float32)[:, None]
    y = np.arange(n, dtype=np.float32)
    port = base.train_test_split(X, y, test_size=test_size, seed=seed)
    ref = jax_base.train_test_split(X, y, test_size=test_size, seed=seed)
    for name in ("X_train", "y_train", "X_test", "y_test"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


def test_pad_splits_match_jax():
    rng = np.random.default_rng(8)
    args = (rng.uniform(0, 100, 900), rng.normal(size=900), rng.uniform(0, 100, 300),
            rng.normal(size=300))
    for got, want in zip(base.Regressor._pad_splits(*args), jax_base.Regressor._pad_splits(*args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("features", [1, 3])
def test_scaled_splits_match_jax(features):
    rng = np.random.default_rng(9 + features)
    X = rng.uniform(0, 100, (1500, features)).astype(np.float32)
    y = (0.5 * X.sum(1) + rng.normal(0, 10, 1500)).astype(np.float32)
    Xp, yp, w = jax_base.pad_rows(X, y)
    Xs, ys, scaler = mlp._scaled_splits(*(torch.from_numpy(a) for a in (Xp, yp, w)))
    rXs, rys, rscaler = jax_mlp._scaled_splits(*(jnp.asarray(a) for a in (Xp, yp, w)))
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        assert tuple(scaler[name].shape) == np.shape(rscaler[name]), name
        np.testing.assert_allclose(scaler[name].numpy(), np.asarray(rscaler[name]), rtol=RTOL)
    np.testing.assert_allclose(Xs.numpy(), np.asarray(rXs), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(rys), rtol=RTOL, atol=1e-6)
