"""The port's fleet soak (``bodywork_tpu_torch.tenancy.fleet``) against the
JAX package's (``bodywork_tpu.tenancy.fleet``): the same scenario-zoo
tenants, days and sabotage give the same summary, every healthy tenant's
fleet namespace is byte-identical to its solo twin, and the sabotaged
tenant's gate rejects its NaN candidate with production held. Linear
models on the CPU, 2 days, 64 rows a day."""
import json
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu import tenancy as jax_tenancy
from bodywork_tpu.tenancy.fleet import run_fleet_sim as jax_run_fleet_sim
from bodywork_tpu_torch.tenancy import SCENARIOS, TenantSpec
from bodywork_tpu_torch.tenancy.fleet import run_fleet_sim, sabotage_dataset_nan

torch.set_num_threads(1)

START = date(2026, 3, 2)


def _fast_zoo(n, spec_cls=TenantSpec, days_samples=64):
    return tuple(
        spec_cls(tenant_id=f"tenant-{i:02d}", scenario=SCENARIOS[i % 3], base_seed=11,
                 n_samples=days_samples)
        for i in range(n))


@pytest.mark.parametrize("sabotage", [None, "tenant-01"])
def test_the_fleet_soak_gives_the_jax_summary(tmp_path, sabotage):
    """Two tenants in one shared store against their solo twins, with and
    without one NaN-sabotaged: each package's summary is the other's, every
    healthy twin byte-identical, the sabotaged gate rejecting."""
    port = run_fleet_sim(tmp_path / "port", START, days=2, specs=_fast_zoo(2),
                         sabotage_tenant=sabotage, device="cpu")
    jax = jax_run_fleet_sim(tmp_path / "jax", START, days=2,
                            specs=_fast_zoo(2, jax_tenancy.TenantSpec),
                            sabotage_tenant=sabotage)
    assert port == jax
    assert port["ok"], port
    healthy = {"tenant-00", "tenant-01"} - {sabotage}
    assert set(port["comparisons"]) == healthy
    for c in port["comparisons"].values():
        assert c["ok"] and not c["mismatched"] and not c["missing"] and not c["extra"]
    if sabotage:
        assert port["gate_rejected"] is True and port["production_held"] is True
    else:
        assert port["gate_rejected"] is None and port["production_held"] is None


def test_the_fleet_soak_of_three_tenants_keeps_zero_blast_radius(tmp_path):
    summary = run_fleet_sim(tmp_path, START, days=2, specs=_fast_zoo(3),
                            sabotage_tenant="tenant-01", device="cpu")
    assert summary["gate_rejected"] is True and summary["production_held"] is True
    assert set(summary["comparisons"]) == {"tenant-00", "tenant-02"}
    assert all(c["ok"] for c in summary["comparisons"].values())
    assert summary["ok"]
    # the tenants live under tenants/<id>/ of the one fleet store
    assert sorted(p.name for p in (tmp_path / "fleet" / "tenants").iterdir()) == [
        "tenant-00", "tenant-01", "tenant-02"]


def test_fleet_sim_refuses_unknown_sabotage_and_dirty_store(tmp_path):
    with pytest.raises(ValueError, match="not in the fleet"):
        run_fleet_sim(tmp_path, START, 1, _fast_zoo(1), sabotage_tenant="ghost", device="cpu")
    (tmp_path / "fleet").mkdir()
    (tmp_path / "fleet" / "stale.txt").write_text("x")
    with pytest.raises(ValueError, match="already holds artefacts"):
        run_fleet_sim(tmp_path, START, 1, _fast_zoo(1), device="cpu")


def test_a_sabotaged_day_parses_to_the_jax_packages_nans(tmp_path):
    """``sabotage_dataset_nan`` rewrites each row as its first field and
    ``nan`` (the JAX function's bytes), and the port's CSV reader reads the
    short rows as pandas does: every label and feature NaN."""
    from bodywork_tpu.data import load_dataset as jax_load_dataset
    from bodywork_tpu.store import FilesystemStore as JaxStore
    from bodywork_tpu.tenancy.fleet import sabotage_dataset_nan as jax_sabotage
    from bodywork_tpu_torch.data import Dataset, load_dataset, persist_dataset
    from bodywork_tpu_torch.store import FilesystemStore

    stores = {}
    for name in ("port", "jax"):
        store = FilesystemStore(tmp_path / name)
        X = np.arange(6, dtype=np.float32)[:, None]
        key = persist_dataset(store, Dataset(X, 2 * X[:, 0], START))
        stores[name] = (store, key)
    sabotage_dataset_nan(*stores["port"])
    jax_sabotage(JaxStore(tmp_path / "jax"), stores["jax"][1])
    port_store, key = stores["port"]
    assert port_store.get_bytes(key) == stores["jax"][0].get_bytes(key)
    got = load_dataset(port_store, key)
    want = jax_load_dataset(JaxStore(tmp_path / "jax"), key)
    assert got.X.shape == np.asarray(want.X).shape and np.isnan(got.X).all()
    assert np.isnan(got.y).all() and np.isnan(np.asarray(want.y)).all()
    with pytest.raises(ValueError):
        Dataset.from_csv("date,y,X\n2026-03-02,abc,1.0\n")


def test_cli_fleet_sim_smoke(tmp_path, capsys):
    """``fleet-sim`` runs the zoo fleet and its twins and prints one JSON
    document, the JAX command's."""
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    flags = ["--date", "2026-03-02", "--days", "1", "--tenants", "2",
             "--samples-per-day", "48", "--json"]
    assert main(["fleet-sim", "--store", str(tmp_path / "port"), *flags, "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert jax_main(["fleet-sim", "--store", str(tmp_path / "jax"), *flags]) == 0
    assert doc == json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["tenants"] == ["tenant-00", "tenant-01"]
    assert main(["fleet-sim", "--store", "gs://bucket/x", *flags, "--device", "cpu"]) == 1


def test_the_fleet_soak_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fleet_sim(tmp_path, START, 1, _fast_zoo(1))


@pytest.mark.parametrize("X,y", [
    (np.zeros(50, np.float32), np.arange(50, dtype=np.float32)),          # singular
    (np.arange(50, dtype=np.float32), np.full(50, np.nan, np.float32)),  # a sabotaged day
])
def test_a_degenerate_linear_fit_gives_jaxs_params_and_raises_nothing(X, y):
    """A singular or non-finite normal-equation system solves to the JAX
    package's non-finite parameters instead of raising (on the card the
    solver raised on the sabotaged day, and the train stage failed where
    the JAX gate rejects the candidate)."""
    from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
    from bodywork_tpu_torch.models import LinearRegressor

    port = LinearRegressor().fit(X, y, device="cpu").params
    jax = JaxLinearRegressor().fit(X, y).params
    for name in ("w", "b"):
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(jax[name]))
