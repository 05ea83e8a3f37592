"""Longitudinal drift analytics without pandas (the port of
``drift_report`` and ``detect_drift`` from
``bodywork_tpu.monitor.analytics``; reference C12).

:func:`drift_report` joins the train stage's held-out metrics
(``model-metrics/``) and the live test stage's metrics
(``test-metrics/``) by date: one row a day, a dict with ``date`` (a
``date``) and every other column suffixed ``_train`` or ``_live``, None
where that side has no record (the JAX report's NaN). :func:`detect_drift`
turns it into the same verdict as the JAX function, with the same rules
and thresholds; the registry gate reads it for its production-has-drifted
override. The CSVs are read with the ``csv`` module and numpy, so the
gate's process needs no pandas. The dashboard and ``cli report`` are a
later slice (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import csv
import io
import math

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import MODEL_METRICS_PREFIX, TEST_METRICS_PREFIX
from bodywork_tpu_torch.utils.dates import parse_date

__all__ = ["detect_drift", "drift_report"]


def _field(value: str):
    """One CSV field as pandas reads it: empty is missing, else a number."""
    if value == "":
        return None
    try:
        return float(value)
    except ValueError:
        return value


def _load_history(store: ArtefactStore, prefix: str) -> list[dict]:
    """Every metrics row under ``prefix``, oldest first."""
    rows = []
    for key, _d in store.history(prefix):
        text = store.get_bytes(key).decode("utf-8")
        for row in csv.DictReader(io.StringIO(text)):
            rec = {k: _field(v) for k, v in row.items() if k != "date"}
            rec["date"] = parse_date(row["date"][:10])
            rows.append(rec)
    rows.sort(key=lambda r: r["date"])
    return rows


def _suffixed(rows: list[dict], suffix: str) -> dict:
    """date -> that day's columns, suffixed (a later record of a date
    wins where a side holds two)."""
    out = {}
    for row in rows:
        out[row["date"]] = {f"{k}{suffix}": v for k, v in row.items() if k != "date"}
    return out


def drift_report(store: ArtefactStore) -> list[dict]:
    """Train-time against live-test metrics, joined by date, oldest first
    (the outer join of the JAX report; empty when neither side has a
    record). The gap between ``MAPE_train`` and ``MAPE_live`` over days
    is the concept-drift signal."""
    train = _suffixed(_load_history(store, MODEL_METRICS_PREFIX), "_train")
    live = _suffixed(_load_history(store, TEST_METRICS_PREFIX), "_live")
    columns = sorted({c for side in (train, live) for cols in side.values() for c in cols})
    report = []
    for d in sorted(set(train) | set(live)):
        row = dict.fromkeys(columns)
        row.update(train.get(d, {}))
        row.update(live.get(d, {}))
        row["date"] = d
        report.append(row)
    return report


def _present(value) -> bool:
    return value is not None and not (isinstance(value, float) and math.isnan(value))


def _bias_hits(report: list[dict], bias_z: float, bias_window: int,
               bias_baseline: int) -> list[bool]:
    """The bias rule over the whole report: the trailing ``bias_window``
    days' pooled live residual mean against the first ``bias_baseline``
    days', in combined standard errors (per-day SE = ``error_std_live /
    sqrt(n_scored_live)``); a day is flagged past ``bias_z``. The
    baseline days themselves never flag."""
    n = len(report)
    needed = ("mean_error_live", "error_std_live", "n_scored_live")
    if not report or any(c not in report[0] for c in needed):
        return [False] * n
    me = np.full(n, np.nan)
    se2 = np.full(n, np.nan)
    for i, row in enumerate(report):
        std, count, mean = (row[c] for c in ("error_std_live", "n_scored_live",
                                             "mean_error_live"))
        if not (_present(std) and _present(count) and _present(mean)):
            continue
        var = (float(std) / math.sqrt(max(float(count), 1.0))) ** 2
        if math.isfinite(float(mean)) and math.isfinite(var):
            me[i], se2[i] = float(mean), var
    valid = ~np.isnan(me)
    base_idx = np.flatnonzero(valid)[:int(bias_baseline)]
    hits = [False] * n
    if len(base_idx) == 0:
        return hits
    base_mean = float(me[base_idx].mean())
    base_var = float(se2[base_idx].mean()) / len(base_idx)
    me0, se0 = np.nan_to_num(me), np.nan_to_num(se2)
    for i in range(n):
        lo = max(0, i - int(bias_window) + 1)
        cnt = float(valid[lo:i + 1].sum())
        denom = max(cnt, 1.0)
        trail_mean = float(me0[lo:i + 1].sum()) / denom
        trail_var = float(se0[lo:i + 1].sum()) / denom ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            # a zero spread gives an infinite z (or NaN at no change), as in pandas
            z = np.float64(trail_mean - base_mean) / np.sqrt(np.float64(trail_var + base_var))
        hits[i] = bool(abs(z) > bias_z and cnt > 0 and valid[i])
    for i in base_idx:
        hits[i] = False
    return hits


def detect_drift(report: list[dict], mape_ratio: float | None = None,
                 corr_floor: float = 0.5, window: int | None = None,
                 bias_z: float = 4.0, bias_window: int = 7,
                 bias_baseline: int = 14) -> dict:
    """The drift verdict over a :func:`drift_report`, by the JAX
    package's three rules (``bodywork_tpu/monitor/analytics.py``, where
    their calibration against the generator is written down):

    - the bias rule (:func:`_bias_hits`), a change detector on the live
      residual mean against the report's first ``bias_baseline`` days;
    - ``MAPE_live > mape_ratio * MAPE_train``, opt-in (``mape_ratio=None``
      disables it: day-level MAPE is unbounded tail noise when labels
      touch zero); a perfect train fit with any live error flags;
    - ``r_squared_live < corr_floor``.

    ``window`` restricts the verdict to the last ``window`` days (the
    bias rule's windows still read the whole report). Returns
    ``{drifted, first_flagged_date, flagged_dates, n_days, thresholds}``;
    a day without a rule's inputs is not flagged by that rule."""
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = {
        "drifted": False,
        "first_flagged_date": None,
        "flagged_dates": [],
        "n_days": 0,
        "thresholds": {
            "mape_ratio": mape_ratio,
            "corr_floor": corr_floor,
            "window": window,
            "bias_z": bias_z,
            "bias_window": bias_window,
            "bias_baseline": bias_baseline,
        },
    }
    if not report:
        return out
    full = sorted(report, key=lambda r: r["date"])
    hits = _bias_hits(full, bias_z, bias_window, bias_baseline)
    start = max(0, len(full) - int(window)) if window is not None else 0
    out["n_days"] = len(full) - start
    flagged = []
    for row, hit in zip(full[start:], hits[start:]):
        mape_t, mape_l = row.get("MAPE_train"), row.get("MAPE_live")
        corr_l = row.get("r_squared_live")
        if (not hit and mape_ratio is not None
                and _present(mape_t) and _present(mape_l)):
            hit = (mape_l > mape_ratio * mape_t) if mape_t > 0 else mape_l > 0
        if not hit and _present(corr_l):
            hit = corr_l < corr_floor
        if hit:
            flagged.append(str(row["date"]))
    if flagged:
        out.update(drifted=True, first_flagged_date=flagged[0], flagged_dates=flagged)
    return out
