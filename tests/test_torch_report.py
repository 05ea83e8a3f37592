"""``cli report`` and the drift dashboard of the port against the JAX
package's on the same stores: the table's stdout bytes, the DRIFT line on
stderr, the exit codes, and the series the dashboard draws."""
from __future__ import annotations

from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu_torch import cli
from bodywork_tpu_torch.store import open_store

torch.set_num_threads(1)


def _jax_main(argv):
    from bodywork_tpu.cli import main

    return main(argv)


def _run(main, argv, capsys):
    capsys.readouterr()
    code = main(argv)
    out, err = capsys.readouterr()
    # the JAX command logs to stdout, the port to stderr: results only
    def keep(text):
        return [line for line in text.splitlines()
                if not any(f" - {lvl} - " in line for lvl in ("INFO", "WARNING", "ERROR"))]

    return code, keep(out), keep(err)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A 4-day linear history written by each package's run-sim."""
    root = tmp_path_factory.mktemp("report")
    port, jax = str(root / "port"), str(root / "jax")
    assert cli.main(["run-sim", "--store", port, "--days", "4", "--date", "2026-02-01",
                     "--model", "linear", "--device", "cpu", "--samples-per-day", "96"]) == 0
    assert _jax_main(["run-sim", "--store", jax, "--days", "4", "--date", "2026-02-01",
                      "--samples-per-day", "96"]) == 0
    return {"port": port, "jax": jax}


_FLAGS = [
    [],
    ["--fail-on-drift"],
    ["--fail-on-drift", "--corr-floor", "2.0"],
    ["--corr-floor", "2.0"],
    ["--fail-on-drift", "--corr-floor", "2.0", "--window", "1", "--mape-ratio", "1000"],
    ["--fail-on-drift", "--mape-ratio", "1000", "--corr-floor", "-10"],
    ["--fail-on-drift", "--mape-ratio", "0.5", "--window", "2"],
    ["--fail-on-drift", "--bias-z", "0.1", "--bias-window", "2", "--bias-baseline", "1"],
]


@pytest.mark.parametrize("flags", _FLAGS, ids=lambda f: " ".join(f) or "plain")
@pytest.mark.parametrize("which", ["port", "jax"])
def test_report_prints_and_exits_as_the_jax_command(stores, which, flags, capsys):
    """Both commands on the same store: the table's bytes on stdout, the
    DRIFT line's bytes on stderr, and the exit code (0, or 4)."""
    argv = ["report", "--store", stores[which], *flags]
    got = _run(cli.main, argv, capsys)
    want = _run(_jax_main, argv, capsys)
    assert got == want
    code, out, err = got
    assert "MAPE_train" in out[0] and len(out) == 6  # 4 train days + the 5th live one
    assert code in (0, cli.DRIFT_EXIT)
    assert (code == cli.DRIFT_EXIT) == ("--fail-on-drift" in flags and bool(err))
    assert all(line.startswith("DRIFT: ") for line in err)


def test_report_fail_on_drift_exit_code(tmp_path, capsys):
    """tests/test_cli.py:18 on the port: a flagged day exits 4 with the
    verdict on stderr, never on stdout; without --fail-on-drift it exits 0."""
    store = str(tmp_path / "s")
    assert cli.main(["run-day", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    code, out, err = _run(cli.main, ["report", "--store", store, "--fail-on-drift",
                                     "--mape-ratio", "1000", "--corr-floor", "-10"], capsys)
    assert code == 0 and not any("DRIFT" in line for line in out + err)
    code, out, err = _run(cli.main, ["report", "--store", store, "--fail-on-drift",
                                     "--corr-floor", "2.0"], capsys)
    assert code == cli.DRIFT_EXIT == 4
    assert any("DRIFT:" in line for line in err) and not any("DRIFT:" in line for line in out)
    code, _out, err = _run(cli.main, ["report", "--store", store, "--corr-floor", "2.0"], capsys)
    assert code == 0 and any("DRIFT:" in line for line in err)
    assert _run(_jax_main, ["report", "--store", store, "--fail-on-drift",
                            "--corr-floor", "2.0"], capsys)[0] == 4


def test_generate_then_train_then_report(tmp_path, capsys):
    """tests/test_cli.py:7: a store with train metrics only (ints and
    floats, no NaN) prints the same table in both packages; an empty
    store prints "no metric history yet" and exits 0."""
    store = str(tmp_path / "s")
    for main in (cli.main, _jax_main):
        assert _run(main, ["report", "--store", store], capsys) == (
            0, ["no metric history yet"], [])
    assert cli.main(["generate", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    assert cli.main(["train", "--store", store, "--device", "cpu"]) == 0
    got = _run(cli.main, ["report", "--store", store], capsys)
    assert got == _run(_jax_main, ["report", "--store", store], capsys)
    assert got[0] == 0 and "MAPE" in got[1][0]


def test_report_table_formats_as_pandas_to_string():
    """Columns pandas prints differently: ints, NaN, tiny and huge floats,
    inf, trailing zeros, a column every value of which is missing."""
    import pandas as pd

    from bodywork_tpu_torch.monitor.analytics import format_drift_report

    rows = [
        {"date": date(2026, 1, 1), "a": 1e-7, "b": 12345678.5, "c": 1, "d": 0.5,
         "e": float("inf"), "f": None, "g": 0.25, "h": -0.0, "i": 3.0},
        {"date": date(2026, 1, 2), "a": 2.0, "b": 1.0, "c": 22, "d": None,
         "e": 1.0, "f": None, "g": 0.125, "h": 1e16, "i": 4.5},
    ]
    frame = pd.DataFrame([{k: (np.nan if v is None else v) for k, v in r.items()} for r in rows])
    assert format_drift_report(rows) == frame.to_string(index=False)
    assert format_drift_report([]) == ""


def test_report_plot_failure_honours_exit_code_contract(tmp_path, monkeypatch, capsys):
    """tests/test_cli.py:276: --plot without matplotlib logs and exits 1,
    the JAX command's contract."""
    import bodywork_tpu_torch.monitor.analytics as analytics

    store = str(tmp_path / "s")
    assert cli.main(["generate", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    assert cli.main(["train", "--store", store, "--device", "cpu"]) == 0

    def _boom(*a, **k):
        raise RuntimeError("matplotlib is not installed")

    monkeypatch.setattr(analytics, "render_drift_dashboard", _boom)
    assert cli.main(["report", "--store", store, "--plot", str(tmp_path / "out.png")]) == 1


def test_render_without_matplotlib_raises_the_jax_runtime_error(tmp_path, monkeypatch):
    import sys

    from bodywork_tpu_torch.monitor.analytics import render_drift_dashboard

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="requires matplotlib"):
        render_drift_dashboard(open_store(str(tmp_path / "s")), tmp_path / "x.png")


def _drawn(render, store, out, monkeypatch):
    """What ``render`` drew: per panel its title, y label, legend texts and
    each line's color, label and (x as matplotlib date numbers, y)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.dates as mdates
    import matplotlib.pyplot as plt

    figures = []
    close = plt.close
    monkeypatch.setattr(plt, "close", lambda fig=None: (figures.append(fig), close(fig)))
    render(store, out)
    monkeypatch.setattr(plt, "close", close)
    (fig,) = figures
    panels = []
    for ax in fig.axes:
        legend = ax.get_legend()
        panels.append({
            "title": ax.get_title(loc="left"), "ylabel": ax.get_ylabel(),
            "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
            "lines": [(line.get_color(), line.get_label(),
                       mdates.date2num(np.asarray(line.get_xdata())).tolist(),
                       np.asarray(line.get_ydata(), dtype=float))
                      for line in ax.get_lines()],
        })
    return panels


@pytest.mark.parametrize("which", ["port", "jax"])
def test_the_dashboard_draws_the_jax_packages_series(stores, which, tmp_path, monkeypatch):
    """tests/test_monitor.py:369 on the port: the same three panels from
    the same store, series for series (NaN where a side has no value);
    the PNG is a real drawing."""
    from bodywork_tpu.monitor import render_drift_dashboard as jax_render
    from bodywork_tpu.store import open_store as jax_open_store

    from bodywork_tpu_torch.monitor.analytics import render_drift_dashboard

    path = stores[which]
    got = _drawn(render_drift_dashboard, open_store(path), tmp_path / "p" / "d.png", monkeypatch)
    want = _drawn(jax_render, jax_open_store(path), tmp_path / "j" / "d.png", monkeypatch)
    assert len(got) == len(want) == 3
    for ours, theirs in zip(got, want):
        assert {k: ours[k] for k in ("title", "ylabel", "legend")} == {
            k: theirs[k] for k in ("title", "ylabel", "legend")}
        assert len(ours["lines"]) == len(theirs["lines"]) > 0
        for (c1, l1, x1, y1), (c2, l2, x2, y2) in zip(ours["lines"], theirs["lines"]):
            assert (c1, l1, x1) == (c2, l2, x2)
            np.testing.assert_allclose(y1, y2, rtol=1e-12, equal_nan=True)
    data = (tmp_path / "p" / "d.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000


def test_render_drift_dashboard_empty_store_raises(tmp_path):
    from bodywork_tpu_torch.monitor.analytics import render_drift_dashboard

    with pytest.raises(ValueError, match="no metric history"):
        render_drift_dashboard(open_store(str(tmp_path / "s")), tmp_path / "drift.png")


def test_cli_report_plot_flag(tmp_path, capsys):
    """tests/test_monitor.py:416 on the port: ``report --plot`` writes the
    PNG and prints its path after the table."""
    store = str(tmp_path / "s")
    assert cli.main(["generate", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    assert cli.main(["train", "--store", store, "--device", "cpu"]) == 0
    out = tmp_path / "dash.png"
    code, lines, _err = _run(cli.main, ["report", "--store", store, "--plot", str(out)], capsys)
    assert code == 0 and lines[-1] == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
