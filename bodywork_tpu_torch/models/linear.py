"""Closed-form linear regressor on torch (the port of
``bodywork_tpu.models.linear``).

The replacement for the reference's
``sklearn.linear_model.LinearRegression(fit_intercept=True)``
(``stage_1_train_model.py:105-106``): the weighted normal equations over
``A = [X | 1]``,

    G = A^T diag(w) A,  c = A^T diag(w) y,  theta = solve(G, c)

in float32 with ``torch.linalg.solve``, as the JAX package computes them,
on rows zero-padded to a bucket with weight-0 padding rows. The fit and
the held-out metrics run together on the device and come back in one
transfer. :func:`gram_stats` / :func:`solve_normal_eq` are the host
float64 sufficient statistics, copied from the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bodywork_tpu_torch.device import require_ieee_f32_matmul, resolve_device
from bodywork_tpu_torch.models.base import Regressor, as_rows, pad_rows
from bodywork_tpu_torch.models.metrics import _metrics, metrics_dict


@dataclasses.dataclass
class LinearConfig:
    fit_intercept: bool = True
    #: L2 ridge term added to the Gram diagonal for numerical safety. 0 keeps
    #: exact OLS parity with the reference.
    l2: float = 0.0


def _normal_equations(A: torch.Tensor, y: torch.Tensor, w: torch.Tensor, l2: float):
    """``G = Aᵀ diag(w) A + l2 I`` and ``c = Aᵀ diag(w) y`` in float32,
    each entry a summed column of row products."""
    Aw = A * w[:, None]
    G = torch.sum(Aw[:, :, None] * A[:, None, :], dim=0)
    G = G + l2 * torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return G, torch.sum(Aw * y[:, None], dim=0)


def _ols_core(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, l2: float) -> dict:
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    theta = torch.linalg.solve_ex(*_normal_equations(torch.cat([X, ones], dim=1), y, w, l2))[0]
    return {"w": theta[:-1], "b": theta[-1]}


def _ols_no_intercept_core(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                           l2: float) -> dict:
    theta = torch.linalg.solve_ex(*_normal_equations(X, y, w, l2))[0]
    return {"w": theta, "b": torch.zeros((), dtype=X.dtype, device=X.device)}


def _ols_fit_eval(Xtr, ytr, wtr, Xte, yte, wte, l2: float, fit_intercept: bool = True):
    """Fused fit + held-out metrics; returns (params, (MAPE, r2,
    max_residual)) as device tensors."""
    core = _ols_core if fit_intercept else _ols_no_intercept_core
    params = core(Xtr, ytr, wtr, l2)
    return params, _metrics(yte, linear_apply(params, Xte), wte)


def gram_stats(X: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Float64 sufficient statistics ``(G, c)`` of one row block for the
    normal equations over ``A = [X | 1]``: ``G = AᵀA`` (d+1, d+1) and
    ``c = Aᵀy`` (d+1,). Additive over row blocks: the statistics of a
    history are the sum of each day's. Host float64, so a long sum stays
    exact enough and serializes bit-deterministically."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    y = np.asarray(y, dtype=np.float64).ravel()
    A = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    return A.T @ A, A.T @ y


def solve_normal_eq(G: np.ndarray, c: np.ndarray, config: LinearConfig | None = None) -> dict:
    """Solve summed :func:`gram_stats` statistics into host float32 params
    ``{"w", "b"}``: the math of ``_ols_core`` (l2 on the full augmented
    diagonal, intercept last) in host float64. The no-intercept variant
    drops the augmented row and column."""
    config = config or LinearConfig()
    G = np.asarray(G, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    if config.fit_intercept:
        theta = np.linalg.solve(G + config.l2 * np.eye(G.shape[0]), c)
        w, b = theta[:-1], theta[-1]
    else:
        Gs = G[:-1, :-1] + config.l2 * np.eye(G.shape[0] - 1)
        theta = np.linalg.solve(Gs, c[:-1])
        w, b = theta, 0.0
    return {"w": np.asarray(w, dtype=np.float32), "b": np.float32(b)}


def linear_apply(params: dict, X: torch.Tensor) -> torch.Tensor:
    return X @ params["w"] + params["b"]


class LinearRegressor(Regressor):
    model_type = "linear"
    apply = staticmethod(linear_apply)

    def __init__(self, config: LinearConfig | None = None, params: dict | None = None):
        super().__init__(config or LinearConfig())
        self._params = params

    @property
    def params(self) -> dict | None:
        return self._params

    @property
    def device(self) -> torch.device:
        return self._params["w"].device

    def fit(self, X, y, seed: int | None = None, device=None) -> "LinearRegressor":
        dev = resolve_device(device)
        require_ieee_f32_matmul(dev)
        Xp, yp, w = pad_rows(*as_rows(X, y))
        Xp, yp, w = (torch.as_tensor(a, device=dev) for a in (Xp, yp, w))
        core = _ols_core if self.config.fit_intercept else _ols_no_intercept_core
        return LinearRegressor(self.config, core(Xp, yp, w, float(self.config.l2)))

    def fit_and_evaluate(self, X_train, y_train, X_test, y_test,
                         seed: int | None = None, device=None):
        """Fused fit + held-out metrics on the device; the metrics come
        back in one transfer, the params stay on the device."""
        dev = resolve_device(device)
        require_ieee_f32_matmul(dev)
        arrays = self._pad_splits(X_train, y_train, X_test, y_test)
        params, m = _ols_fit_eval(
            *(torch.as_tensor(a, device=dev) for a in arrays),
            float(self.config.l2), fit_intercept=self.config.fit_intercept,
        )
        return LinearRegressor(self.config, params), metrics_dict(torch.stack(m).tolist())

    @property
    def n_features(self) -> int | None:
        return None if self._params is None else int(self._params["w"].shape[0])

    @property
    def info(self) -> str:
        return "LinearRegressor(closed_form_ols)"

    @classmethod
    def from_config_dict(cls, cfg: dict, params) -> "LinearRegressor":
        return cls(LinearConfig(**cfg), params)
