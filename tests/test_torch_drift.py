"""The port's pandas-free drift analytics against the JAX package's on
the same store: the joined report row for row, and ``detect_drift``'s
verdict (the registry gate's production-has-drifted override reads it)."""
import math
from datetime import date, timedelta

import numpy as np
import pytest

from bodywork_tpu.monitor.analytics import detect_drift as jax_detect_drift
from bodywork_tpu.monitor.analytics import drift_report as jax_drift_report
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.monitor.analytics import detect_drift, drift_report
from bodywork_tpu_torch.store import FilesystemStore

START = date(2026, 1, 1)
LIVE_COLUMNS = ("date,MAPE,r_squared,max_residual,mean_response_time,n_failures,"
                "mean_error,error_std,n_scored")


def _write(root, days: int, *, shift_from: int | None = None, shift: float = 0.0,
           corr_dip: int | None = None, train: bool = True, live: bool = True,
           nan_day: int | None = None, seed: int = 0):
    """``days`` days of train and live metrics: live residual means near 0
    (sd 10 / sqrt(1300)), shifted by ``shift`` from day ``shift_from``."""
    rng = np.random.default_rng(seed)
    store = JaxStore(root)
    for i in range(days):
        d = START + timedelta(days=i)
        if train:
            store.put_text(f"model-metrics/regressor-{d}.csv",
                           f"date,MAPE,r_squared,max_residual\n{d},"
                           f"{0.7 + 0.01 * rng.normal()!r},{0.65 + 0.01 * rng.normal()!r},40.5\n")
        if live:
            mean_error = rng.normal(0, 10 / math.sqrt(1300))
            if shift_from is not None and i >= shift_from:
                mean_error += shift
            r2 = 0.3 if i == corr_dip else 0.62 + 0.01 * rng.normal()
            mape = "" if i == nan_day else repr(0.9 + 0.05 * rng.normal())
            store.put_text(f"test-metrics/regressor-test-results-{d}.csv",
                           f"{LIVE_COLUMNS}\n{d},{mape},{r2!r},41.0,0.002,0,"
                           f"{mean_error!r},10.0,1300\n")


def _same_report(got, want):
    assert len(got) == len(want)
    if not got:
        assert want.empty
        return
    assert set(got[0]) == set(want.columns)
    for row, (_, ref) in zip(got, want.iterrows()):
        for col in want.columns:
            a, b = row[col], ref[col]
            if isinstance(b, float) and math.isnan(b):
                assert a is None or (isinstance(a, float) and math.isnan(a)), col
            elif isinstance(b, (float, np.floating, int, np.integer)):
                # pandas' default CSV float parser is not correctly rounded:
                # it keeps about 15 significant digits of a 17-digit field
                assert math.isclose(a, float(b), rel_tol=1e-12, abs_tol=0.0), (col, a, b)
            else:
                assert a == b, (col, a, b)


SCENARIOS = {
    "empty": dict(days=0),
    "train-only": dict(days=10, live=False),
    "live-only": dict(days=10, train=False),
    "no-drift": dict(days=40),
    "bias-shift": dict(days=40, shift_from=25, shift=1.5),
    "small-shift": dict(days=40, shift_from=25, shift=0.5),
    "corr-collapse": dict(days=20, corr_dip=17),
    "nan-live-mape": dict(days=20, nan_day=5),
}


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("kwargs", [
    {}, {"window": 1}, {"window": 7}, {"mape_ratio": 1.2}, {"bias_z": 2.0, "bias_baseline": 7},
], ids=["default", "window-1", "window-7", "mape-ratio", "bias-z-2"])
def test_drift_verdicts_equal_jaxs(tmp_path, name, kwargs):
    _write(tmp_path, **SCENARIOS[name])
    got_report = drift_report(FilesystemStore(tmp_path))
    want_report = jax_drift_report(JaxStore(tmp_path))
    _same_report(got_report, want_report)
    assert detect_drift(got_report, **kwargs) == jax_detect_drift(want_report, **kwargs)


def test_the_shifted_scenario_flags_and_the_flat_one_does_not(tmp_path):
    """The scenarios exercise both verdicts."""
    _write(tmp_path / "a", days=40, shift_from=25, shift=1.5)
    _write(tmp_path / "b", days=40)
    assert detect_drift(drift_report(FilesystemStore(tmp_path / "a")), window=7)["drifted"]
    assert not detect_drift(drift_report(FilesystemStore(tmp_path / "b")), window=7)["drifted"]


def test_window_must_be_positive():
    with pytest.raises(ValueError, match="window"):
        detect_drift([{"date": START}], window=0)
