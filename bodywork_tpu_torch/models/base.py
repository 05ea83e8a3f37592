"""Regressor protocol, train/test split and the numpy bucket-padding
helpers (the port of ``bodywork_tpu.models.base``).

A model is a thin wrapper around a nested dict of parameter tensors plus
a static config. ``fit`` returns a NEW fitted model whose parameters live
on the device it trained on; ``predict`` and ``evaluate`` run the class's
pure ``apply`` there. Row counts are padded to power-of-two buckets with
weight-0 padding rows, as in the JAX package, so both packages fit and
score the same padded arrays.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np
import torch


def _bucket_rows(n: int, minimum: int = 1024) -> int:
    """Next power-of-two row count >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(X: np.ndarray, y: np.ndarray, minimum: int = 1024):
    """Zero-pad (X, y) to a bucketed row count; returns (Xp, yp, weights)."""
    n = X.shape[0]
    b = _bucket_rows(n, minimum)
    Xp = np.zeros((b,) + X.shape[1:], dtype=X.dtype)
    yp = np.zeros((b,), dtype=y.dtype)
    w = np.zeros((b,), dtype=np.float32)
    Xp[:n] = X
    yp[:n] = y
    w[:n] = 1.0
    return Xp, yp, w


@dataclasses.dataclass
class TrainSplit:
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray


def train_test_split(
    X: np.ndarray, y: np.ndarray, test_size: float = 0.2, seed: int = 42
) -> TrainSplit:
    """Random 80/20 split with a fixed seed (reference ``stage_1:98-103``,
    ``test_size=0.2, random_state=42``): numpy's ``default_rng(seed)``
    permutation, so both packages split identically."""
    n = X.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_test = int(round(n * test_size))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return TrainSplit(X[train_idx], y[train_idx], X[test_idx], y[test_idx])


def as_features(X) -> np.ndarray:
    """float32 (n, d) features from (n, d) or (n,) input."""
    X = np.asarray(X, dtype=np.float32)
    return X[:, None] if X.ndim == 1 else X


def as_rows(X, y) -> tuple[np.ndarray, np.ndarray]:
    """float32 (n, d) features and float32 (n,) targets."""
    return as_features(X), np.asarray(y, dtype=np.float32).ravel()


class Regressor(abc.ABC):
    """A regression model over a nested dict of parameter tensors; the
    params are None until the model is fitted (or loaded)."""

    #: short registry name, e.g. "linear" / "mlp" (used in checkpoints)
    model_type: str = "base"

    #: the pure apply function ``(params, X (n, d)) -> y (n,)`` behind
    #: ``predict`` and ``evaluate``; set per subclass
    apply = None

    def __init__(self, config: Any = None):
        self.config = config

    @property
    @abc.abstractmethod
    def params(self) -> dict | None:
        """The parameters as a nested dict/list of tensors, in the JAX
        package's pytree layout (checkpoint leaf paths map one to one)."""

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """Where the fitted parameters live."""

    # -- estimator protocol ------------------------------------------------
    @abc.abstractmethod
    def fit(self, X: np.ndarray, y: np.ndarray, seed: int | None = None,
            device=None) -> "Regressor":
        """Return a fitted copy of this model, its params on ``device``
        (the card unless asked for the CPU). ``seed`` overrides the
        config's seed; deterministic models ignore it."""

    def fit_and_evaluate(self, X_train, y_train, X_test, y_test,
                         seed: int | None = None, device=None):
        """Fit on the train split and score the held-out split; returns
        ``(fitted, metrics)``. Subclasses keep both on the device and
        fetch the metrics in one transfer."""
        fitted = self.fit(X_train, y_train, seed=seed, device=device)
        return fitted, fitted.evaluate(X_test, y_test)

    @staticmethod
    def _pad_splits(X_train, y_train, X_test, y_test):
        """Shared input coercion + bucket padding for the fit+eval paths:
        float32, (n, d) features, ravelled targets, train padded to the
        fit bucket and test to the eval bucket (min 256). Returns
        ``(Xtr, ytr, wtr, Xte, yte, wte)``."""
        return pad_rows(*as_rows(X_train, y_train)) + pad_rows(*as_rows(X_test, y_test),
                                                               minimum=256)

    def _fitted_params(self) -> dict:
        if self.params is None:
            raise ValueError(f"{type(self).__name__} is not fitted")
        return self.params

    def host_params(self):
        """The params as host numpy arrays, in their nested layout."""
        from bodywork_tpu_torch.models.mlp import params_to_host

        return params_to_host(self._fitted_params())

    def predict_device(self, X: np.ndarray) -> torch.Tensor:
        """Run the apply on the model's device and return the tensor there,
        without the copy to the host."""
        params = self._fitted_params()
        X = torch.as_tensor(as_features(X), device=self.device)
        with torch.no_grad():
            return type(self).apply(params, X)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predict targets; accepts (n, d) or (n,) arrays."""
        return self.predict_device(X).cpu().numpy()

    def predict_padded(self, X: np.ndarray, minimum: int = 256) -> np.ndarray:
        """Predict through a power-of-two row bucket (zero rows appended,
        their predictions dropped), so a growing held-out split runs at a
        logarithmic number of shapes; serving has the richer
        :class:`~bodywork_tpu_torch.serve.predictor.PaddedPredictor`."""
        X = as_features(X)
        Xp, _, _ = pad_rows(X, np.zeros(X.shape[0], np.float32), minimum)
        return self.predict(Xp)[:X.shape[0]]

    def evaluate(self, X: np.ndarray, y: np.ndarray) -> dict[str, float]:
        """MAPE / R^2 / max-residual of this model on (X, y), computed on
        its device over padded rows and fetched in one transfer."""
        from bodywork_tpu_torch.models.metrics import make_eval_fn, metrics_dict

        params = self._fitted_params()
        Xp, yp, w = pad_rows(*as_rows(X, y), minimum=256)
        dev = self.device
        m = make_eval_fn(type(self).apply)(params, *(torch.as_tensor(a, device=dev)
                                                     for a in (Xp, yp, w)))
        return metrics_dict(torch.stack(m).tolist())

    @property
    def n_features(self) -> int | None:
        return None

    @property
    def info(self) -> str:
        """The ``model_info`` string in the scoring response."""
        return f"{type(self).__name__}()"

    def __repr__(self) -> str:
        return self.info

    def config_dict(self) -> dict:
        return dataclasses.asdict(self.config) if self.config else {}

    @classmethod
    @abc.abstractmethod
    def from_config_dict(cls, cfg: dict, params: Any) -> "Regressor": ...
