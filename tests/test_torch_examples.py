"""The port's examples (``examples_torch/``) held to the JAX package's
(``examples/``): each pair runs on identical stores, seeded with the JAX
generator's days through numpy, the port's scripts with ``--device cpu``,
and the port's output must land in the JAX test's golden regime
(``tests/test_examples.py``) and agree with the JAX script's. The npz +
``__meta__`` checkpoint is the packages' shared currency: a checkpoint
either package trains is served and tested by the other's scripts.
"""
from __future__ import annotations

import importlib.util
import math
import re
import shutil
import sys
from datetime import date, timedelta
from pathlib import Path

import numpy as np
import pytest
import requests
import torch

from tests.helpers import live_scoring_service, serve_subprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"jax": ROOT / "examples", "port": ROOT / "examples_torch"}
#: the linear model's metrics in both packages on the same rows: float32
#: reductions in another order (``tests/test_torch_trainer.py``'s bar)
METRIC_RTOL = 1e-5
_METRICS = re.compile(r"'MAPE': ([\d.]+).*'r_squared': ([\d.]+)")


@pytest.fixture(autouse=True)
def _own_registries(monkeypatch):
    """The scripts serve and score in this process, and each package's
    metrics registry (its latency exemplars included) and its tracer's
    cached counter are process-wide: each test runs on empty registries
    of its own, so no later test in the worker reads this file's requests
    (``tests/test_torch_counters.py``'s isolation)."""
    from bodywork_tpu.obs import registry as jax_registry
    from bodywork_tpu.obs import tracing as jax_tracing
    from bodywork_tpu_torch.obs import registry, tracing

    monkeypatch.setattr(registry, "_DEFAULT", registry.Registry())
    monkeypatch.setattr(jax_registry, "_DEFAULT", jax_registry.Registry())
    monkeypatch.setattr(tracing.get_tracer(), "_m_sampled", None)
    monkeypatch.setattr(jax_tracing.get_tracer(), "_m_sampled", None)


def _load(pkg: str, name: str):
    spec = importlib.util.spec_from_file_location(f"{pkg}_{name}", SCRIPTS[pkg] / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(pkg: str, *argv: str) -> list[str]:
    """The port's scripts run on the card unless told otherwise."""
    return [*argv, "--device", "cpu"] if pkg == "port" else list(argv)


def _run(monkeypatch, capsys, pkg: str, name: str, *argv: str):
    """``(stdout, main()'s return)`` of one script run in this process."""
    mod = _load(pkg, name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *_argv(pkg, *argv)])
    result = mod.main()
    return capsys.readouterr().out, result


def _twin_stores(tmp_path, days: int, start=date(2026, 1, 1)) -> dict:
    """The JAX generator's first ``days`` days from ``start`` in two
    store directories, byte for byte: ``{"jax": path, "port": path}``."""
    from bodywork_tpu.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu.store import open_store

    store = open_store(str(tmp_path / "jax"))
    for i in range(days):
        d = start + timedelta(days=i)
        X, y = generate_day(d)
        persist_dataset(store, Dataset(np.asarray(X), np.asarray(y), d))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return {pkg: str(tmp_path / pkg) for pkg in ("jax", "port")}


def _train(pkg: str, path: str):
    if pkg == "jax":
        from bodywork_tpu.store import open_store
        from bodywork_tpu.train import train_on_history

        return train_on_history(open_store(path))
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.train import train_on_history

    return train_on_history(open_store(path), device="cpu")


def _predict_50(pkg: str, path: str) -> float:
    """The store's newest checkpoint's prediction at X = 50, loaded by
    ``pkg``."""
    if pkg == "jax":
        from bodywork_tpu.models import load_model
        from bodywork_tpu.store import open_store

        model, _ = load_model(open_store(path))
    else:
        from bodywork_tpu_torch.models import load_model
        from bodywork_tpu_torch.store import open_store

        model, _ = load_model(open_store(path), device="cpu")
    return float(np.asarray(model.predict(np.array([50.0], np.float32)))[0])


def _table(out: str, first: str) -> tuple[list[str], list[list[str]]]:
    """The fixed-width table whose header starts with column ``first``:
    (column names, rows of cells), cells split on whitespace."""
    lines = out.splitlines()
    at = next(i for i, line in enumerate(lines) if line.split()[:1] == [first])
    header = lines[at].split()
    rows = []
    for line in lines[at + 1:]:
        cells = line.split()
        if len(cells) != len(header):
            break
        rows.append(cells)
    return header, rows


def _close(a: float, b: float, rtol: float = METRIC_RTOL) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=rtol)


def test_example_01_train_matches_the_jax_example(tmp_path, monkeypatch, capsys):
    stores = _twin_stores(tmp_path, days=2)
    outs = {pkg: _run(monkeypatch, capsys, pkg, "01_train_model", "--store", stores[pkg])[0]
            for pkg in ("jax", "port")}
    metrics = {}
    for pkg, out in outs.items():
        m = _METRICS.search(out)
        assert m, out
        metrics[pkg] = (float(m.group(1)), float(m.group(2)))
        assert "models/regressor-2026-01-02" in out
    mape, r2 = metrics["port"]
    # the JAX test's golden regime (the reference's 1-train-model.ipynb)
    assert 0.5 < mape < 1.2 and 0.55 < r2 < 0.75
    assert mape == pytest.approx(metrics["jax"][0], rel=METRIC_RTOL)
    assert r2 == pytest.approx(metrics["jax"][1], rel=METRIC_RTOL)
    trained = [re.search(r"trained on \d+ rows to \S+", out).group(0) for out in outs.values()]
    assert trained[0] == trained[1]
    # deterministic: retraining on the same history reproduces the metrics
    again = _run(monkeypatch, capsys, "port", "01_train_model", "--store", stores["port"])[0]
    assert _METRICS.search(again).groups() == _METRICS.search(outs["port"]).groups()


def test_example_03_generates_the_jax_example_day(tmp_path, monkeypatch, capsys):
    from bodywork_tpu.data.generator import alpha as jax_alpha
    from bodywork_tpu.data.io import load_latest_dataset as jax_latest
    from bodywork_tpu.store import open_store as jax_open
    from bodywork_tpu_torch.data.generator import alpha, day_of_year
    from bodywork_tpu_torch.data.io import load_latest_dataset
    from bodywork_tpu_torch.store import open_store

    stores = _twin_stores(tmp_path, days=1)
    seen = {}
    for pkg in ("jax", "port"):
        out = _run(monkeypatch, capsys, pkg, "03_generate_next_dataset", "--store", stores[pkg])[0]
        m = re.search(r"generated (\d+) rows for 2026-01-02 \(alpha = ([\d.]+)\)", out)
        assert m, out
        seen[pkg] = (int(m.group(1)), float(m.group(2)))
    n_rows, printed_alpha = seen["port"]
    assert 1200 <= n_rows <= 1440 and n_rows == seen["jax"][0]
    assert printed_alpha == pytest.approx(seen["jax"][1], abs=1e-6)
    assert printed_alpha == pytest.approx(
        1.0 + 0.5 * math.sin(2 * math.pi * 6 * (2 - 1) / 364), abs=1e-3)
    doy = day_of_year(date(2026, 1, 2))
    assert float(alpha(doy)) == pytest.approx(float(jax_alpha(doy)), abs=1e-6)
    got, want = load_latest_dataset(open_store(stores["port"])), jax_latest(jax_open(stores["jax"]))
    assert got.date == want.date == date(2026, 1, 2)
    assert got.X.tobytes() == want.X.tobytes()


def test_example_04_and_05_match_the_jax_examples(tmp_path, monkeypatch, capsys):
    from bodywork_tpu.monitor import drift_report as jax_drift_report
    from bodywork_tpu.store import open_store as jax_open
    from bodywork_tpu_torch.monitor import drift_report
    from bodywork_tpu_torch.serve import serve_latest_model
    from bodywork_tpu_torch.store import open_store

    stores = _twin_stores(tmp_path, days=2)
    for pkg in ("jax", "port"):
        _train(pkg, stores[pkg])
    with live_scoring_service(jax_open(stores["jax"])) as base:
        tested = {"jax": _run(monkeypatch, capsys, "jax", "04_test_model_scoring_service",
                              "--store", stores["jax"], "--url", base)[0]}
    handle = serve_latest_model(stores["port"], host="127.0.0.1", port=0, block=False,
                                device="cpu")
    try:
        tested["port"] = _run(monkeypatch, capsys, "port", "04_test_model_scoring_service",
                              "--store", stores["port"], "--url", handle.base_url)[0]
    finally:
        handle.stop()
    tables = {pkg: _table(out, "date") for pkg, out in tested.items()}
    assert tables["port"][0] == tables["jax"][0]
    assert {"MAPE", "mean_response_time", "n_failures"} <= set(tables["port"][0])
    mape = tables["port"][0].index("MAPE")
    assert float(tables["port"][1][0][mape]) == pytest.approx(
        float(tables["jax"][1][0][mape]), rel=METRIC_RTOL)

    # the stores' reports: the same columns, the same MAPEs (times apart)
    report = drift_report(open_store(stores["port"]))
    want = jax_drift_report(jax_open(stores["jax"]))
    assert list(report[0]) == list(want.columns)
    for column in ("MAPE_train", "MAPE_live", "r_squared_train", "r_squared_live"):
        got = [float("nan") if r[column] is None else r[column] for r in report]
        assert all(map(_close, got, want[column].astype(float))), column

    analytics = {pkg: _run(monkeypatch, capsys, pkg, "05_model_performance_analytics",
                           "--store", stores[pkg])[0] for pkg in ("jax", "port")}
    headers = {pkg: _table(out, "date")[0] for pkg, out in analytics.items()}
    assert headers["port"] == headers["jax"]
    assert "MAPE_train" in headers["port"] and "MAPE_live" in headers["port"]
    gaps = {pkg: float(re.search(r"mean live-vs-train MAPE gap over 1 day\(s\): ([-+\d.]+)",
                                 out).group(1)) for pkg, out in analytics.items()}
    assert gaps["port"] == pytest.approx(gaps["jax"], abs=1e-4)


def test_example_06_ab_comparison_matches_the_jax_example(tmp_path, monkeypatch, capsys):
    pairs = {}
    for pkg in ("jax", "port"):
        out = _run(monkeypatch, capsys, pkg, "06_ab_model_comparison",
                   "--root", str(tmp_path / pkg), "--days", "2", "--models", "linear,linear",
                   "--start", "2026-01-01")[0]
        assert "a-linear" in out and "b-linear" in out
        assert "s/day steady-state" in out
        assert "FAILED" not in out
        header, rows = _table(out, "variant")
        assert header == ["variant", "date", "MAPE_train", "MAPE_live", "r_squared_live"]
        pairs[pkg] = {(r[0], r[1]): [float(v) for v in r[2:]] for r in rows}
    assert pairs["port"].keys() == pairs["jax"].keys()
    assert {d for _, d in pairs["port"]} == {"2026-01-01", "2026-01-02", "2026-01-03"}
    # each package generates its own days here: y is within a few ulps of
    # the JAX day's (tests/test_torch_prng.py), and a label near zero turns
    # that into ~5e-5 of the live MAPE (max APE ~600), so MAPE_live is held
    # at 1e-3; the train MAPE and the live correlation at METRIC_RTOL
    for key, (mape_train, mape_live, r2_live) in pairs["port"].items():
        want = pairs["jax"][key]
        assert _close(mape_train, want[0]) and _close(r2_live, want[2]), key
        assert _close(mape_live, want[1], rtol=1e-3), key


def test_example_07_wide_model_matches_the_jax_example(tmp_path, monkeypatch, capsys):
    # sized down (128-wide, 4 steps) as the JAX test runs it: fused
    # fit+eval, checkpoint round-trip, batch serving, each kernel's
    # cross-check (here on the CPU, each kernel's plain version)
    args = ("--rows", "256", "--steps", "4", "--hidden", "128")
    out, result = _run(monkeypatch, capsys, "port", "07_wide_model",
                       "--store", str(tmp_path / "port"), *args)
    jax_out = _run(monkeypatch, capsys, "jax", "07_wide_model",
                   "--store", str(tmp_path / "jax"), *args)[0]
    for line in ("trained MLPRegressor(hidden=[128, 128, 128])",
                 "checkpoint round-trip: models/regressor-2026-01-01.npz (2026-01-01)",
                 "served 8 rows via /score/v1/batch (MLPRegressor(hidden=[128, 128, 128]))"):
        assert line in out and line in jax_out
    delta = float(out.rsplit("delta on 8 rows: ", 1)[1].split()[0])
    assert delta < 0.01
    assert "kernel-vs-torch max abs delta on 8 rows" in out and "(plain version)" in out
    # the JAX test's bf16 bar (a 4-step model is barely trained, so the
    # relative error runs hotter than on a converged one)
    for line in ("torch-bf16  max rel delta", "kernel-bf16 max rel delta"):
        rel = float(out.rsplit(line + " vs f32: ", 1)[1].split()[0])
        assert rel < 0.05
    # auto resolves to the kernel only on the card; the CPU serves torch
    assert result["engine"] == "torch"
    assert set(result["answers"]) == {"kernel", "kernel-bf16"}
    assert all(a.shape == (8,) and bool(torch.isfinite(a).all())
               for a in result["answers"].values())


def test_example_08_drift_gate_flags_the_jax_example_day(tmp_path, monkeypatch, capsys):
    verdicts = {}
    for pkg in ("jax", "port"):
        out = _run(monkeypatch, capsys, pkg, "08_drift_gate", "--store", str(tmp_path / pkg))[0]
        assert "retraining now STOPS" in out
        m = re.search(r"DRIFT detected: (\d+)/(\d+) day\(s\) flagged, first "
                      r"(\S+) \(live day (\d+)\)", out)
        assert m, out
        verdicts[pkg] = m.groups()
        assert "drifted=False" in out
        assert "last 7 days: drifted=True" in out
    assert 35 <= int(verdicts["port"][3]) <= 53
    # the same generator days, the same OLS fit and the same bias rule:
    # the same flagged days, exactly
    assert verdicts["port"] == verdicts["jax"]


def test_example_02_serves_over_http(tmp_path):
    stores = _twin_stores(tmp_path, days=1)
    _train("port", stores["port"])
    _train("jax", stores["jax"])
    with serve_subprocess(
        [str(SCRIPTS["port"] / "02_serve_model.py"),
         *_argv("port", "--store", stores["port"], "--host", "127.0.0.1", "--port", "0")]
    ) as url:
        body = requests.post(url + "/score/v1", json={"X": 50}, timeout=5).json()
    assert set(body) == {"prediction", "model_info", "model_date"}
    # alpha(1)=1.0, beta=0.5 => E[y|X=50] ~= 26
    assert body["prediction"] == pytest.approx(26.0, abs=3.0)
    assert body["prediction"] == pytest.approx(_predict_50("jax", stores["jax"]), rel=METRIC_RTOL)


@pytest.mark.parametrize("trainer,server", [("jax", "port"), ("port", "jax")])
def test_a_checkpoint_crosses_packages_through_the_examples(tmp_path, monkeypatch, capsys,
                                                            trainer, server):
    """One package's 01 trains, the other's 02 serves the checkpoint
    over HTTP and its 04 black-box tests the service."""
    store = _twin_stores(tmp_path, days=2)[trainer]
    _run(monkeypatch, capsys, trainer, "01_train_model", "--store", store)
    with serve_subprocess(
        [str(SCRIPTS[server] / "02_serve_model.py"),
         *_argv(server, "--store", store, "--host", "127.0.0.1", "--port", "0")]
    ) as url:
        body = requests.post(url + "/score/v1", json={"X": 50}, timeout=5).json()
        out = _run(monkeypatch, capsys, server, "04_test_model_scoring_service",
                   "--store", store, "--url", url)[0]
    assert body["model_date"] == "2026-01-02"
    assert body["prediction"] == pytest.approx(_predict_50(trainer, store), rel=METRIC_RTOL)
    header, rows = _table(out, "date")
    row = dict(zip(header, rows[0]))
    assert row["date"] == "2026-01-02" and row["n_failures"] == "0"
    assert 0.5 < float(row["MAPE"]) < 1.2
