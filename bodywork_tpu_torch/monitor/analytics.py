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
gate's process needs no pandas. :func:`format_drift_report` prints the
report as the JAX command prints its DataFrame
(``to_string(index=False)``), and :func:`render_drift_dashboard` draws
the JAX package's three panels, with matplotlib imported only there.
"""
from __future__ import annotations

import csv
import io
import math
import re

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import MODEL_METRICS_PREFIX, TEST_METRICS_PREFIX
from bodywork_tpu_torch.utils.dates import parse_date
from bodywork_tpu_torch.utils.logging import get_logger

__all__ = ["detect_drift", "drift_report", "format_drift_report", "render_drift_dashboard"]

log = get_logger("monitor.analytics")

_INT_FIELD = re.compile(r"^[+-]?[0-9]+$")


def _field(value: str):
    """One CSV field as pandas reads it: empty is missing, an integer
    literal an int, else a float (or the text)."""
    if value == "":
        return None
    if _INT_FIELD.match(value):
        return int(value)
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


def _columns(rows: list[dict]) -> list[str]:
    """The metric columns of ``rows`` in order of first appearance (a
    day's CSV order; a column a later day adds comes after)."""
    columns: dict = {}
    for row in rows:
        columns.update(dict.fromkeys(k for k in row if k != "date"))
    return list(columns)


def drift_report(store: ArtefactStore) -> list[dict]:
    """Train-time against live-test metrics, joined by date, oldest first:
    the outer join of the JAX report, its columns in the JAX DataFrame's
    order (``date``, the train metrics suffixed ``_train``, the live ones
    suffixed ``_live``), None where a side has no value; empty when
    neither side has a record. The gap between ``MAPE_train`` and
    ``MAPE_live`` over days is the concept-drift signal."""
    sides = []
    for prefix, suffix in ((MODEL_METRICS_PREFIX, "_train"), (TEST_METRICS_PREFIX, "_live")):
        rows = _load_history(store, prefix)
        # a later record of a date wins where a side holds two
        by_date = {row["date"]: row for row in rows}
        sides.append((by_date, [(c, c + suffix) for c in _columns(rows)]))
    report = []
    for d in sorted(set(sides[0][0]) | set(sides[1][0])):
        row = {"date": d}
        for by_date, columns in sides:
            record = by_date.get(d, {})
            row.update((out, record.get(c)) for c, out in columns)
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


# -- the report table, as pandas' DataFrame.to_string(index=False) --------

_PRECISION = 6  # pandas' display.precision
_DECIMAL = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _trim_zeros(cells: list[str]) -> list[str]:
    """Trailing zeros trimmed equally from every decimal, leaving one."""
    def should_trim(values):
        numbers = [x for x in values if _DECIMAL.match(x)]
        return bool(numbers) and all(x.endswith("0") for x in numbers)

    while should_trim(cells):
        cells = [x[:-1] if _DECIMAL.match(x) else x for x in cells]
    return [x + "0" if _DECIMAL.match(x) and x.endswith(".") else x for x in cells]


def _float_cells(values: list) -> list[str]:
    """A float column's cells: fixed at 6 decimals with the zeros trimmed,
    or scientific when a value would print as 0 or a large one is long."""
    def cells_as(spec):
        return ["NaN" if _missing(v) else format(float(v), spec) for v in values]

    cells = _trim_zeros(cells_as(f".{_PRECISION}f"))
    magnitudes = [abs(float(v)) for v in values if not _missing(v)]
    too_long = max((len(c) for c in cells), default=0) > _PRECISION + 6
    has_large = any(m > 1e6 for m in magnitudes)
    has_small = any(0 < m < 10 ** (-_PRECISION) for m in magnitudes)
    if has_small or (too_long and has_large):
        cells = cells_as(f".{_PRECISION}e")
    return cells


def format_drift_report(report: list[dict]) -> str:
    """The report as the JAX command prints it (``to_string(index=False)``
    of its DataFrame): right-aligned columns one space apart; a column of
    ints (every value an integer literal, none missing) as ints, a numeric
    column with a missing value or a fraction as pandas' floats with
    ``NaN``, the dates as ISO text. Empty string for an empty report."""
    if not report:
        return ""
    columns = []
    for name in report[0]:
        values = [row.get(name) for row in report]
        present = [v for v in values if not _missing(v)]
        numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
        if numeric and present and all(type(v) is int for v in values):
            header, cells = " " + name, [str(v) for v in values]
        elif numeric and name != "date":
            header, cells = " " + name, _float_cells(values)
        else:
            header, cells = name, ["NaN" if _missing(v) else str(v) for v in values]
        width = max(len(header), *(len(c) for c in cells))
        columns.append([header.rjust(width), *(c.rjust(width) for c in cells)])
    return "\n".join(" ".join(line) for line in zip(*columns))


# -- the dashboard ---------------------------------------------------------

# categorical slots 1-2 of the reference palette, as the JAX dashboard's
_TRAIN_COLOR = "#2a78d6"  # blue: train-time metrics
_LIVE_COLOR = "#eb6834"   # orange: live-test metrics
_SURFACE = "#fcfcfb"
_INK = "#0b0b0b"
_INK_2 = "#52514e"
_GRID = "#e4e3df"


def render_drift_dashboard(store: ArtefactStore, out_path, report: list[dict] | None = None):
    """Render the longitudinal drift dashboard to a PNG (the JAX package's
    ``render_drift_dashboard``; reference C12's visual half): three
    stacked panels over the days, one y-scale each: MAPE train vs live;
    train R^2 vs live score/label correlation; mean scoring-service
    response time (ms). ``report`` skips the store read when the caller
    just computed :func:`drift_report`. Returns the written path.

    matplotlib is imported here (the Agg backend); without it this raises
    ``RuntimeError``."""
    from datetime import datetime, time
    from pathlib import Path

    try:
        import matplotlib

        matplotlib.use("Agg")  # headless: never require a display
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise RuntimeError(
            "rendering the drift dashboard requires matplotlib "
            "(pip install matplotlib)"
        ) from exc

    if report is None:
        report = drift_report(store)
    if not report:
        raise ValueError("no metric history to plot (run some days first)")

    days = np.array([datetime.combine(row["date"], time()) for row in report],
                    dtype="datetime64[ns]")

    def column(name, scale=1.0):
        return np.array([math.nan if _missing(row.get(name)) else float(row[name]) * scale
                         for row in report])

    fig, axes = plt.subplots(3, 1, figsize=(9, 9), sharex=True, facecolor=_SURFACE)

    def _style(ax, title, ylabel):
        ax.set_facecolor(_SURFACE)
        ax.set_title(title, color=_INK, fontsize=11, loc="left", pad=8)
        ax.set_ylabel(ylabel, color=_INK_2, fontsize=9)
        ax.grid(True, color=_GRID, linewidth=0.8)
        ax.tick_params(colors=_INK_2, labelsize=8)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(_GRID)

    line_kw = dict(linewidth=2, marker="o", markersize=5, clip_on=False)

    def _series(ax, name, color, label=None, scale=1.0):
        values = column(name, scale)
        if name in report[0] and not np.isnan(values).all():
            kw = {"label": label} if label else {}
            ax.plot(days, values, color=color, **kw, **line_kw)

    _series(axes[0], "MAPE_train", _TRAIN_COLOR, "train (held-out)")
    _series(axes[0], "MAPE_live", _LIVE_COLOR, "live service")
    _style(axes[0], "MAPE per simulated day — the drift gap", "MAPE")

    _series(axes[1], "r_squared_train", _TRAIN_COLOR, "train R²")
    _series(axes[1], "r_squared_live", _LIVE_COLOR, "live score/label corr")
    _style(axes[1], "Fit quality per day", "R² / corr")

    _series(axes[2], "mean_response_time_live", _TRAIN_COLOR, scale=1000.0)
    _style(axes[2], "Mean scoring-service response time", "ms")

    for ax in axes[:2]:
        if ax.has_data():
            legend = ax.legend(loc="best", fontsize=8, frameon=False, labelcolor=_INK)
            for line in legend.get_lines():
                line.set_linewidth(2)
    axes[2].tick_params(axis="x", rotation=30)
    fig.align_ylabels(axes)
    fig.tight_layout()

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=144, facecolor=_SURFACE, bbox_inches="tight")
    plt.close(fig)
    log.info(f"drift dashboard rendered to {out}")
    return out
