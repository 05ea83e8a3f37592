"""Regression metrics on torch (the port of ``bodywork_tpu.models.metrics``;
reference ``stage_1_train_model.py:79-90``).

The reference computes sklearn's ``mean_absolute_percentage_error``,
``r2_score`` and ``max_error`` on the held-out split. The same
definitions here, over rows zero-padded to a bucket with a 0/1 weight
mask, on whatever device the tensors live on.
"""
from __future__ import annotations

import numpy as np
import torch

from bodywork_tpu_torch.models.base import pad_rows

# sklearn's MAPE guards the denominator with float64 machine epsilon.
_MAPE_EPS = 2.220446049250313e-16


def _metrics(y_true: torch.Tensor, y_pred: torch.Tensor, w: torch.Tensor):
    """Masked MAPE / R^2 / max-abs-residual as 0-d tensors; padding rows
    carry weight 0."""
    n = torch.clamp(torch.sum(w), min=1.0)
    # Mask with where, not multiplication: a non-finite prediction on a
    # padding row would turn 0 * inf into NaN and poison every reduction.
    resid = torch.where(w > 0, y_true - y_pred, torch.zeros_like(y_true))
    mape = torch.sum(torch.abs(resid) / torch.clamp(torch.abs(y_true), min=_MAPE_EPS)) / n
    mean_y = torch.sum(w * y_true) / n
    ss_res = torch.sum(resid**2)
    ss_tot = torch.sum(w * (y_true - mean_y) ** 2)
    r_squared = 1.0 - ss_res / ss_tot
    max_residual = torch.max(torch.abs(resid))
    return mape, r_squared, max_residual


def metrics_dict(tail) -> dict[str, float]:
    """The first three values are always (MAPE, r_squared, max_residual)
    (``bodywork_tpu.models.fused.metrics_dict``)."""
    return {
        "MAPE": float(tail[0]),
        "r_squared": float(tail[1]),
        "max_residual": float(tail[2]),
    }


def make_eval_fn(apply_fn):
    """Model apply and the masked metrics as one function
    ``eval_fn(params, Xp, yp, w) -> (MAPE, r_squared, max_residual)``
    (0-d tensors on the params' device, fetched by the caller in one
    transfer), as the JAX package fuses them into one program."""

    def eval_fn(params, Xp: torch.Tensor, yp: torch.Tensor, w: torch.Tensor):
        with torch.no_grad():
            return _metrics(yp, apply_fn(params, Xp), w)

    return eval_fn


def regression_metrics(y_true, y_pred) -> dict[str, float]:
    """MAPE / R^2 / max-abs-residual of host arrays, matching the
    reference's metric record columns (``stage_1:85-89``)."""
    y_true = np.asarray(y_true, dtype=np.float32).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float32).ravel()
    yt, yp, w = pad_rows(y_true, y_pred, minimum=256)
    m = _metrics(torch.from_numpy(yt), torch.from_numpy(yp), torch.from_numpy(w))
    return metrics_dict(torch.stack(m).tolist())
