"""Regressor protocol and the numpy bucket-padding helpers (the port of
``bodywork_tpu.models.base``).

A model is a thin wrapper around a nested dict of parameter tensors plus
a static config. This slice serves models and does not train them, so
the protocol has no ``fit`` yet; the training slice adds it.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np


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


class Regressor(abc.ABC):
    """A fitted regression model over a nested dict of parameter tensors."""

    #: short registry name, e.g. "mlp" (used in checkpoints)
    model_type: str = "base"

    def __init__(self, config: Any = None):
        self.config = config

    @property
    @abc.abstractmethod
    def params(self) -> dict:
        """The parameters as a nested dict/list of tensors, in the JAX
        package's pytree layout (checkpoint leaf paths map one to one)."""

    @abc.abstractmethod
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predict targets; accepts (n, d) or (n,) arrays."""

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
