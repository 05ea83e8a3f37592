"""Shadow evaluation: score a candidate next to production, offline (the
port of ``bodywork_tpu.registry.shadow``).

Both checkpoints are loaded in process on the gate's device, the last K
days of persisted datasets are scored through each, and the report
compares their predictions with each other and with the labels. No
request is mirrored, no service started, nothing written; the gate
embeds the report in its decision event.
"""
from __future__ import annotations

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("registry.shadow")

_APE_EPS = 2.220446049250313e-16


def _window_mape(preds, labels) -> float:
    denom = np.maximum(np.abs(labels), _APE_EPS)
    return float(np.mean(np.abs(preds - labels) / denom))


def shadow_compare(store: ArtefactStore, predict_candidate, predict_production,
                   days: int = 7, max_rows_per_day: int | None = None) -> dict:
    """Score two ``predict(X) -> y`` callables over the last ``days``
    persisted dataset days and compare them (the report of
    :func:`shadow_evaluate`)."""
    from bodywork_tpu_torch.data.io import load_dataset

    hist = store.history(DATASETS_PREFIX)
    if not hist:
        raise ValueError("no dataset history to shadow-evaluate over")
    window = hist[-days:]
    cand_all, prod_all, labels_all = [], [], []
    for key, _d in window:
        ds = load_dataset(store, key)
        X, y = ds.X, ds.y
        if max_rows_per_day is not None:
            X, y = X[:max_rows_per_day], y[:max_rows_per_day]
        cand_all.append(np.asarray(predict_candidate(X), dtype=np.float64))
        prod_all.append(np.asarray(predict_production(X), dtype=np.float64))
        labels_all.append(np.asarray(y, dtype=np.float64))
    cand_pred = np.concatenate(cand_all)
    prod_pred = np.concatenate(prod_all)
    labels = np.concatenate(labels_all)
    delta = cand_pred - prod_pred
    return {
        "days": len(window),
        "rows": int(delta.size),
        "mean_abs_delta": float(np.mean(np.abs(delta))),
        "max_abs_delta": float(np.max(np.abs(delta))),
        "candidate_mape": _window_mape(cand_pred, labels),
        "production_mape": _window_mape(prod_pred, labels),
    }


def shadow_evaluate(store: ArtefactStore, candidate_key: str, production_key: str,
                    days: int = 7, max_rows_per_day: int | None = None,
                    device=None) -> dict:
    """Load both checkpoints on ``device`` (the card unless asked for the
    CPU), score them over the last ``days`` dataset days and compare::

        {"days": n, "rows": n,
         "mean_abs_delta": …,  "max_abs_delta": …,   # candidate vs production
         "candidate_mape": …,  "production_mape": …} # each vs the labels

    ``max_rows_per_day`` caps each day's rows (its head). Raises when a
    checkpoint or the window cannot be loaded; the gate records that as a
    failed check."""
    from bodywork_tpu_torch.models.checkpoint import load_model_bytes

    candidate = load_model_bytes(store.get_bytes(candidate_key), device=device)
    production = load_model_bytes(store.get_bytes(production_key), device=device)
    report = shadow_compare(store, candidate.predict, production.predict,
                            days=days, max_rows_per_day=max_rows_per_day)
    log.info(
        f"shadow eval {candidate_key} vs {production_key}: "
        f"mean|Δ|={report['mean_abs_delta']:.4f} over {report['days']} day(s), "
        f"candidate MAPE {report['candidate_mape']:.4f} vs production "
        f"{report['production_mape']:.4f}"
    )
    return report
