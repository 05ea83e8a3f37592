"""The train stage over a store: the port's ``train_on_history`` and the
JAX package's on the same JAX-generated days, with the same artefacts."""
import json
import shutil
from datetime import date, timedelta

import numpy as np
import pandas as pd
import pytest
import torch

from bodywork_tpu.data.generator import generate_day as jax_generate_day
from bodywork_tpu.data.io import Dataset as JaxDataset
from bodywork_tpu.data.io import load_all_datasets as jax_load_all_datasets
from bodywork_tpu.data.io import persist_dataset as jax_persist_dataset
from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.train import trainer as jax_trainer
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data import load_all_datasets
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.store import ArtefactNotFound, FilesystemStore
from bodywork_tpu_torch.train import trainer

torch.set_num_threads(1)

DAYS = [date(2026, 7, 1) + timedelta(days=i) for i in range(3)]
#: metrics of the same linear fit on the same rows (float32 reductions)
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_days(tmp_path_factory):
    """Three JAX-generated days in a store directory (the template)."""
    root = tmp_path_factory.mktemp("days")
    store = JaxStore(root)
    for d in DAYS:
        X, y = jax_generate_day(d)
        jax_persist_dataset(store, JaxDataset(np.asarray(X), np.asarray(y), d))
    return root


@pytest.fixture
def twin_stores(jax_days, tmp_path):
    """The same days in two store directories: (JAX store, port store)."""
    shutil.copytree(jax_days, tmp_path / "jax")
    shutil.copytree(jax_days, tmp_path / "port")
    return JaxStore(tmp_path / "jax"), FilesystemStore(tmp_path / "port")


def test_load_all_datasets_is_the_jax_dataset(twin_stores):
    jax_store, port_store = twin_stores
    got, want = load_all_datasets(port_store), jax_load_all_datasets(jax_store)
    assert got.date == want.date == DAYS[-1]
    assert got.X.dtype == want.X.dtype and got.y.dtype == want.y.dtype
    assert got.X.tobytes() == want.X.tobytes() and got.y.tobytes() == want.y.tobytes()


def test_load_all_datasets_refuses_an_empty_store(tmp_path):
    with pytest.raises(ArtefactNotFound):
        load_all_datasets(FilesystemStore(tmp_path))


def _csv(root, key):
    return (root / key).read_text()


def test_linear_train_on_history_matches_jax(twin_stores):
    jax_store, port_store = twin_stores
    got = trainer.train_on_history(port_store, "linear", device="cpu")
    want = jax_trainer.train_on_history(jax_store, "linear")
    assert got.model_artefact_key == want.model_artefact_key == "models/regressor-2026-07-03.npz"
    assert got.metrics_artefact_key == want.metrics_artefact_key
    assert got.n_rows == want.n_rows == got.rows_touched
    assert got.mode == "full" and got.data_date == want.data_date
    assert got.prediction_bounds == want.prediction_bounds
    np.testing.assert_allclose(list(got.metrics.values()), list(want.metrics.values()),
                               rtol=METRIC_RTOL)
    # the metrics CSV: the reference's schema, read back by pandas the same
    key = got.metrics_artefact_key
    port_csv = pd.read_csv(port_store.root / key)
    jax_csv = pd.read_csv(jax_store.root / key)
    assert list(port_csv.columns) == list(jax_csv.columns) == [
        "date", "MAPE", "r_squared", "max_residual"]
    assert port_csv["date"][0] == jax_csv["date"][0] == "2026-07-03"
    np.testing.assert_allclose(port_csv.iloc[0, 1:].to_numpy(float),
                               jax_csv.iloc[0, 1:].to_numpy(float), rtol=METRIC_RTOL)
    # each package loads the other's checkpoint and scores alike
    X = np.linspace(0, 100, 11, dtype=np.float32)[:, None]
    port_model, _ = port_ckpt.load_model(port_store, device="cpu")
    jax_model = jax_ckpt.load_model_bytes(port_store.get_bytes(key.replace(
        "model-metrics/", "models/").replace(".csv", ".npz")))
    np.testing.assert_allclose(jax_model.predict(X), want.model.predict(X), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port_model.predict(X), want.model.predict(X), rtol=1e-5, atol=1e-4)


def test_mlp_train_on_history_lands_beside_jax(twin_stores):
    """The two packages draw the MLP's init and minibatches from different
    generators, so the held-out metrics agree within the fit's spread, not
    bit for bit (the loop itself is held to 1e-4 on shared draws in
    test_torch_mlp_train.py)."""
    jax_store, port_store = twin_stores
    kwargs = {"hidden": [16, 16], "n_steps": 300}
    got = trainer.train_on_history(port_store, "mlp", model_kwargs=dict(kwargs), device="cpu")
    want = jax_trainer.train_on_history(jax_store, "mlp", model_kwargs=dict(kwargs))
    assert got.model.info == want.model.info == "MLPRegressor(hidden=[16, 16])"
    assert got.model.config.n_steps == 300
    assert abs(got.metrics["r_squared"] - want.metrics["r_squared"]) < 0.05, (got, want)
    assert abs(got.metrics["MAPE"] - want.metrics["MAPE"]) < 0.25 * want.metrics["MAPE"]
    assert port_store.exists("model-metrics/regressor-2026-07-03.csv")
    # both register the checkpoint as a candidate, under the same key
    assert port_store.list_keys("registry/") == jax_store.list_keys("registry/") == [
        "registry/records/regressor-2026-07-03.json"]
    record = json.loads(port_store.get_text("registry/records/regressor-2026-07-03.json"))
    assert record["status"] == "candidate"
    assert record["prediction_bounds"] == got.prediction_bounds


def test_persist_false_defers_the_artefacts(twin_stores):
    _, store = twin_stores
    result = trainer.train_on_history(store, "linear", persist=False, device="cpu")
    assert result.model_artefact_key is None and not store.list_keys("models/")
    done = trainer.persist_train_result(store, result)
    assert store.exists(done.model_artefact_key) and store.exists(done.metrics_artefact_key)


@pytest.mark.parametrize("kwargs,match", [
    # ported since: incremental runs, and without a donor checkpoint it
    # degrades to a full refit as the JAX package's does (the mesh cases
    # went with the refusal they tested; tests/test_torch_parallel.py
    # holds the sharded fit against the JAX package's)
    ({"mode": "incremental"}, None),
])
def test_unported_modes_raise_naming_their_roadmap_entry(twin_stores, kwargs, match):
    jax_store, store = twin_stores
    if match is None:
        small = {"hidden": [8, 8], "n_steps": 20}
        got = trainer.train_on_history(store, "mlp", device="cpu", model_kwargs=small, **kwargs)
        want = jax_trainer.train_on_history(jax_store, "mlp", model_kwargs=small, **kwargs)
        assert (got.mode, got.fallback_reason) == (want.mode, want.fallback_reason) \
            == ("full", "no_donor")
        assert store.exists(got.model_artefact_key)
    else:
        with pytest.raises(NotImplementedError, match=match):
            trainer.train_on_history(store, "mlp", device="cpu", **kwargs)
    with pytest.raises(ValueError, match="unknown train mode"):
        trainer.train_on_history(store, "linear", mode="lookahead", device="cpu")


@pytest.mark.parametrize("model_type,kwargs", [
    ("linear", {}), ("linear", {"l2": 0.5}), ("mlp", {}),
    ("mlp", {"hidden": [32, 8], "n_steps": 7, "learning_rate": 1e-3}),
])
def test_make_model_takes_flat_kwargs_as_jax_does(model_type, kwargs):
    got = trainer.make_model(model_type, **dict(kwargs))
    want = jax_trainer.make_model(model_type, **dict(kwargs))
    assert got.config_dict() == want.config_dict()
    assert got.info == want.info


def test_cli_train_writes_the_artefacts(twin_stores, capsys):
    _, store = twin_stores
    assert cli.main(["train", "--store", str(store.root), "--model", "mlp", "--mlp-hidden",
                     "8,8", "--mlp-steps", "20", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("models/regressor-2026-07-03.npz MAPE=")
    model, _ = jax_ckpt.load_model(JaxStore(store.root))
    assert model.info == "MLPRegressor(hidden=[8, 8])"
    with pytest.raises(SystemExit):
        cli.main(["train", "--store", str(store.root), "--mlp-steps", "20", "--device", "cpu"])


def test_cli_train_modes_are_the_trainers(twin_stores, capsys):
    """``train --mode incremental`` runs (ported since): the first run on a
    store builds the linear trainstate, reporting the bootstrap's reason."""
    _, store = twin_stores
    assert cli.TRAIN_MODES == trainer.TRAIN_MODES == jax_trainer.TRAIN_MODES
    assert cli.main(["train", "--store", str(store.root), "--mode", "incremental",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mode=incremental rows_touched=" in out and out.rstrip().endswith(
        "fallback=trainstate_absent")
    assert store.exists("trainstate/linear-suffstats.json")
