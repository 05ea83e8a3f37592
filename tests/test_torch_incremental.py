"""Incremental training: the port's ``train/incremental.py`` against the
JAX package's on twin stores of the same JAX-generated days (the
scenarios of ``tests/test_incremental.py``).

Bars: ``day_split_indices`` identical; trainstate documents byte-identical
for the same store, and each package reads and folds onto the other's;
linear coefficients within 1e-4 of a float64 full refit and within 1e-6
of JAX's incremental solution; every fallback reason JAX's; the same-day
``gate_rejected`` full refit through the port's ``LocalRunner``."""
import itertools
import logging
import os
import threading
from datetime import date, timedelta
from unittest.mock import patch

import numpy as np
import pytest
import torch

from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.data.drift_config import DriftConfig as JaxDriftConfig
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.train import incremental as jax_inc
from bodywork_tpu.train import train_on_history as jax_train
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data.io import Dataset, load_dataset
from bodywork_tpu_torch.pipeline import stages
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, dataset_key, trainstate_key
from bodywork_tpu_torch.train import TRAIN_MODES, train_on_history
from bodywork_tpu_torch.train import incremental as inc

torch.set_num_threads(1)

START = date(2026, 3, 1)
DRIFT = JaxDriftConfig(n_samples=50)
TS_KEY = trainstate_key("linear")
MLP_KW = {"hidden": [8, 8], "n_steps": 60}
#: the port's solution against a float64 lstsq refit (``bench.py:2548``)
REFIT_ATOL = 1e-4
#: the port's incremental solution against JAX's: both solve the same
#: float64 sums in float64 and round to float32
JAX_ATOL = 1e-6


def _seed(root, days: int, start=START, drift=DRIFT):
    """JAX-generated days written by the JAX package into ``root``."""
    store = JaxStore(root)
    for i in range(days):
        d = start + timedelta(days=i)
        X, y = jax_generate_day(d, drift)
        jax_persist_dataset(store, JaxDataset(np.asarray(X), np.asarray(y), d))


@pytest.fixture
def twins(tmp_path):
    """``(jax_store, port_store, seed)``: two store directories that get
    the same days; ``seed(n, start)`` writes n days into both."""
    roots = tmp_path / "jax", tmp_path / "port"

    def seed(days, start=START, drift=DRIFT):
        for root in roots:
            _seed(root, days, start, drift)

    return JaxStore(roots[0]), FilesystemStore(roots[1]), seed


def _union_train_rows(store):
    Xs, ys = [], []
    for key, d in store.history(DATASETS_PREFIX):
        ds = load_dataset(store, key)
        train_idx, _ = inc.day_split_indices(len(ds), d, 0.2, 42)
        Xs.append(np.asarray(ds.X, np.float64)[train_idx])
        ys.append(np.asarray(ds.y, np.float64)[train_idx])
    return np.concatenate(Xs), np.concatenate(ys)


def _lstsq_theta(X, y):
    A = np.concatenate([X, np.ones((len(y), 1))], axis=1)
    return np.linalg.lstsq(A, y, rcond=None)[0]


def _theta(model) -> np.ndarray:
    p = model.params
    return np.concatenate([p["w"].cpu().numpy().ravel(), [float(p["b"])]])


def _jax_theta(model) -> np.ndarray:
    host = model.host_params()
    return np.concatenate([np.asarray(host["w"]).ravel(), [float(host["b"])]])


@pytest.mark.parametrize("n,offset,test_size,seed", [
    (100, 0, 0.2, 42), (1440, 5, 0.2, 42), (7, 30, 0.2, 3), (50, 400, 0.5, 0), (1, 2, 0.2, 42),
])
def test_day_split_indices_are_jaxs(n, offset, test_size, seed):
    d = START + timedelta(days=offset)
    got = inc.day_split_indices(n, d, test_size, seed)
    want = jax_inc.day_split_indices(n, d, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_constants_are_jaxs():
    for name in ("TRAINSTATE_SCHEMA", "TAIL_DAYS", "INCREMENTAL_SHADOW_DAYS",
                 "FINE_TUNE_STEPS_FRACTION", "MIN_FINE_TUNE_STEPS", "CORRUPT_READ_RETRIES"):
        assert getattr(inc, name) == getattr(jax_inc, name), name
    assert trainstate_key("mlp") == jax_inc.trainstate_key("mlp")


def test_trainstate_bytes_are_jaxs_and_each_folds_onto_the_other(twins):
    """Day by day on twin stores: the same document bytes every day; then
    each package folds a new day onto the other's document and the
    solutions stay within 1e-6 of each other."""
    jax_store, port_store, seed = twins
    for i in range(4):
        seed(1, START + timedelta(days=i))
        got = train_on_history(port_store, "linear", mode="incremental", device="cpu")
        want = jax_train(jax_store, "linear", mode="incremental")
        assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)
        assert got.fallback_reason == want.fallback_reason
        assert got.rows_touched == want.rows_touched and got.n_rows == want.n_rows
        np.testing.assert_allclose(_theta(got.model), _jax_theta(want.model), atol=JAX_ATOL)
        assert got.prediction_bounds == pytest.approx(want.prediction_bounds)
        for k in want.metrics:
            assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-5), k
    # swap the documents: each package folds day 5 onto the other's
    jax_doc, port_doc = jax_store.get_bytes(TS_KEY), port_store.get_bytes(TS_KEY)
    jax_store.put_bytes(TS_KEY, port_doc)
    port_store.put_bytes(TS_KEY, jax_doc)
    seed(1, START + timedelta(days=4))
    got = train_on_history(port_store, "linear", mode="incremental", device="cpu")
    want = jax_train(jax_store, "linear", mode="incremental")
    assert got.fallback_reason is None and want.fallback_reason is None
    assert got.rows_touched == want.rows_touched
    assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)
    doc, _t, reason = jax_inc.read_trainstate(jax_store, "linear")
    assert reason is None and len(doc["days"]) == 5


def test_linear_coefficients_hold_the_float64_refit_and_jax(twins):
    jax_store, port_store, seed = twins
    seed(6)
    got = train_on_history(port_store, "linear", mode="incremental", device="cpu")
    want = jax_train(jax_store, "linear", mode="incremental")
    theta = _lstsq_theta(*_union_train_rows(port_store))
    np.testing.assert_allclose(_theta(got.model), theta, atol=REFIT_ATOL)
    np.testing.assert_allclose(_theta(got.model), _jax_theta(want.model), atol=JAX_ATOL)
    assert got.trainstate_artefact_key == TS_KEY and got.pending_trainstate is None
    assert got.model.params["w"].device.type == "cpu"


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_suffstats_solution_order_independent_property():
    """Hypothesis: folding random days in any order (and any subset)
    solves to the float64 refit on those days' train splits, and to the
    JAX package's solution from the same entries."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(min_value=5, max_value=40), min_size=1, max_size=5),
           st.randoms(use_true_random=False))
    def run(sizes, pyrandom):
        entries, union_X, union_y = {}, [], []
        for i, n in enumerate(sizes):
            d = START + timedelta(days=i)
            rng = np.random.default_rng(1000 + i)
            X = rng.uniform(0, 100, (n, 1))
            ds = Dataset(X, 2.0 + 0.5 * X[:, 0] + rng.normal(0, 3, n), d)
            entries[str(d)] = inc._day_entry(ds, 0.2, 42)
            assert entries[str(d)] == jax_inc._day_entry(ds, 0.2, 42)
            train_idx, _ = inc.day_split_indices(n, d, 0.2, 42)
            union_X.append(np.asarray(ds.X, np.float64)[train_idx])
            union_y.append(np.asarray(ds.y, np.float64)[train_idx])
        if sum(e["n_train"] for e in entries.values()) < 3:
            return  # an underdetermined system is not the claim
        keys = list(entries)
        pyrandom.shuffle(keys)
        params = inc.solve_from_days({k: entries[k] for k in keys})
        got = np.concatenate([np.asarray(params["w"], np.float64).ravel(), [float(params["b"])]])
        theta = _lstsq_theta(np.concatenate(union_X), np.concatenate(union_y))
        np.testing.assert_allclose(got, theta, atol=REFIT_ATOL)
        want = jax_inc.solve_from_days(entries)
        np.testing.assert_array_equal(params["w"], want["w"])
        assert params["b"] == want["b"]

    run()


def test_suffstats_every_permutation_solves_identically():
    entries = {}
    for i, n in enumerate((12, 30, 21)):
        d = START + timedelta(days=i)
        rng = np.random.default_rng(2000 + i)
        X = rng.uniform(0, 100, (n, 1))
        entries[str(d)] = inc._day_entry(Dataset(X, 2.0 + 0.5 * X[:, 0], d), 0.2, 42)
    solutions = {np.concatenate([p["w"].ravel(), [p["b"]]]).tobytes()
                 for p in (inc.solve_from_days({k: entries[k] for k in perm})
                           for perm in itertools.permutations(entries))}
    assert len(solutions) == 1


# -- fallback reasons ---------------------------------------------------------


def _absent(jax_store, port_store, seed):
    seed(3)


def _corrupt(jax_store, port_store, seed):
    seed(2)
    train_on_history(port_store, "linear", mode="incremental", device="cpu")
    jax_train(jax_store, "linear", mode="incremental")
    for store in (jax_store, port_store):
        store.put_bytes(TS_KEY, b"\x00garbage not json")
    seed(1, START + timedelta(days=2))


def _deleted_day(jax_store, port_store, seed):
    seed(3)
    train_on_history(port_store, "linear", mode="incremental", device="cpu")
    jax_train(jax_store, "linear", mode="incremental")
    for store in (jax_store, port_store):
        os.remove(os.path.join(store.root, dataset_key(START)))


def _overwritten_day(jax_store, port_store, seed):
    seed(3)
    train_on_history(port_store, "linear", mode="incremental", device="cpu")
    jax_train(jax_store, "linear", mode="incremental")
    seed(1, START + timedelta(days=1), JaxDriftConfig(n_samples=70, seed=9))


@pytest.mark.parametrize("setup,reason", [
    (_absent, "trainstate_absent"),
    (_corrupt, "trainstate_corrupt"),
    (_deleted_day, "trainstate_stale"),
    (_overwritten_day, "trainstate_stale"),
])
def test_linear_fallback_reasons_are_jaxs(twins, setup, reason):
    jax_store, port_store, seed = twins
    setup(*twins)
    got = train_on_history(port_store, "linear", mode="incremental", device="cpu")
    want = jax_train(jax_store, "linear", mode="incremental")
    assert got.fallback_reason == want.fallback_reason == reason
    assert got.mode == want.mode == "incremental"
    assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)
    np.testing.assert_allclose(_theta(got.model), _lstsq_theta(*_union_train_rows(port_store)),
                               atol=REFIT_ATOL)


def test_linear_split_change_is_stale_as_in_jax(twins):
    jax_store, port_store, seed = twins
    seed(2)
    train_on_history(port_store, "linear", mode="incremental", device="cpu")
    jax_train(jax_store, "linear", mode="incremental")
    got = inc.incremental_train_linear(port_store, split_seed=7, device="cpu")
    want = jax_inc.incremental_train_linear(jax_store, split_seed=7)
    assert got.fallback_reason == want.fallback_reason == "trainstate_stale"
    assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)
    assert inc.read_trainstate(port_store, "linear")[0]["split"] == {"test_size": 0.2, "seed": 7}


def _no_donor(jax_store, port_store, seed):
    seed(2)
    return MLP_KW


def _linear_donor(jax_store, port_store, seed):
    seed(2)
    jax_train(jax_store, "linear")
    train_on_history(port_store, "linear", device="cpu")
    return MLP_KW


def _other_architecture(jax_store, port_store, seed):
    seed(2)
    jax_train(jax_store, "mlp", model_kwargs=MLP_KW)
    train_on_history(port_store, "mlp", model_kwargs=MLP_KW, device="cpu")
    return {"hidden": [4], "n_steps": 60}


@pytest.mark.parametrize("setup,reason", [
    (_no_donor, "no_donor"),
    (_linear_donor, "donor_incompatible"),
    (_other_architecture, "donor_incompatible"),
])
def test_mlp_fallback_reasons_are_jaxs(twins, setup, reason):
    jax_store, port_store, seed = twins
    kwargs = setup(*twins)
    got = train_on_history(port_store, "mlp", mode="incremental", model_kwargs=kwargs,
                           device="cpu")
    want = jax_train(jax_store, "mlp", mode="incremental", model_kwargs=kwargs)
    assert got.fallback_reason == want.fallback_reason == reason
    assert got.mode == want.mode == "full"
    assert port_store.exists(got.model_artefact_key)


def test_unsupported_model_falls_back_as_in_jax(twins, caplog):
    """No incremental path for the model type: both packages log
    ``unsupported_model`` and fall back to the full refit, whose model
    registry then refuses the unknown type."""
    jax_store, port_store, seed = twins
    seed(1)
    caplog.set_level(logging.WARNING)
    with pytest.raises(ValueError, match="unknown model type"):
        inc.train_incremental(port_store, "tree", device="cpu")
    with pytest.raises(ValueError, match="unknown model type"):
        jax_inc.train_incremental(jax_store, "tree")
    port_lines = [r.message for r in caplog.records if r.name.startswith("bodywork_tpu_torch")]
    jax_lines = [r.message for r in caplog.records
                 if r.name.startswith("bodywork_tpu.") or r.name == "bodywork_tpu"]
    assert any("unsupported_model" in m for m in port_lines)
    assert any("unsupported_model" in m for m in jax_lines)


def test_mlp_warm_start_is_jaxs(twins):
    """The same donor, fine-tuned by each package on the same replay with
    the same seeded draws: the donor's scaler kept, and the two tuned
    nets within Adam's float32 drift of each other."""
    jax_store, port_store, seed = twins
    seed(2)
    donor = jax_train(jax_store, "mlp", model_kwargs=MLP_KW)
    port_store.put_bytes(donor.model_artefact_key, jax_store.get_bytes(donor.model_artefact_key))
    seed(1, START + timedelta(days=2))
    got = train_on_history(port_store, "mlp", mode="incremental", model_kwargs=MLP_KW,
                           device="cpu")
    want = jax_train(jax_store, "mlp", mode="incremental", model_kwargs=MLP_KW)
    assert (got.mode, got.fallback_reason) == (want.mode, want.fallback_reason) \
        == ("incremental", None)
    assert got.rows_touched == want.rows_touched <= DRIFT.n_samples * inc.TAIL_DAYS
    for k, v in donor.model.host_params()["scaler"].items():
        np.testing.assert_array_equal(got.model.scaler[k].numpy(), np.asarray(v))
    X = np.linspace(0.0, 100.0, 64, dtype=np.float32)
    np.testing.assert_allclose(got.model.predict(X), want.model.predict(X), rtol=1e-3, atol=1e-2)
    assert got.prediction_bounds == pytest.approx(want.prediction_bounds)


# -- CAS ----------------------------------------------------------------------


def _doc_for(day_strs, scale):
    meta = {"n_rows": 1, "n_train": 1, "y_min": 0.0, "y_max": 1.0}
    return inc._build_doc("linear", 1, {"test_size": 0.2, "seed": 42},
                          {d: dict(meta) for d in day_strs}, [[scale] * 2] * 2, [scale] * 2)


def test_persist_trainstate_last_writer_wins_and_converges(twins):
    """A later writer with fewer days overwrites (no merge); the next
    incremental train folds every day back in, through the overwritten-day
    check, to JAX's document."""
    jax_store, port_store, seed = twins
    days = [str(START + timedelta(days=i)) for i in range(3)]
    assert inc._build_doc("linear", 1, {"test_size": 0.2, "seed": 42}, {}, [[1.0]], [1.0]) \
        == jax_inc._build_doc("linear", 1, {"test_size": 0.2, "seed": 42}, {}, [[1.0]], [1.0])
    inc.persist_trainstate(port_store, "linear", _doc_for(days, 2.0))
    jax_inc.persist_trainstate(jax_store, "linear", _doc_for(days, 2.0))
    inc.persist_trainstate(port_store, "linear", _doc_for(days[:1], 1.0))
    jax_inc.persist_trainstate(jax_store, "linear", _doc_for(days[:1], 1.0),
                               expected_token="stale-token")
    assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)
    doc, _t, reason = inc.read_trainstate(port_store, "linear")
    assert reason is None and sorted(doc["days"]) == days[:1] and doc["cum_c"] == [1.0, 1.0]
    seed(3)
    got = train_on_history(port_store, "linear", mode="incremental", device="cpu")
    want = jax_train(jax_store, "linear", mode="incremental")
    assert got.fallback_reason == want.fallback_reason == "trainstate_stale"
    assert sorted(inc.read_trainstate(port_store, "linear")[0]["days"]) == days
    assert port_store.get_bytes(TS_KEY) == jax_store.get_bytes(TS_KEY)


def test_concurrent_writers_of_both_packages_never_tear_the_document(tmp_path):
    """Writers of both packages race on one store: every write lands
    through the shared CAS lock, and the document left is one writer's,
    whole."""
    port_store, jax_store = FilesystemStore(tmp_path), JaxStore(tmp_path)
    docs = [_doc_for([str(START + timedelta(days=i))], float(i + 1)) for i in range(8)]
    errors = []

    def write(i):
        try:
            for _ in range(5):
                if i % 2:
                    jax_inc.persist_trainstate(jax_store, "linear", docs[i], attempts=50)
                else:
                    inc.persist_trainstate(port_store, "linear", docs[i], attempts=50)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(len(docs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    doc, _t, reason = inc.read_trainstate(port_store, "linear")
    assert reason is None and doc in docs


# -- the runner's gate fallback, knobs and the cli ------------------------------


def _train_only_spec(package: str, args: dict):
    if package == "jax":
        from bodywork_tpu.pipeline.spec import PipelineSpec, StageSpec
    else:
        from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec
    name = "stage-1-train-model"
    stage = StageSpec(name=name, kind="batch",
                      executable=f"{package}.pipeline.stages:train_stage",
                      args={"model_type": "mlp", **args}, max_completion_time_s=120.0)
    return PipelineSpec(name="inc-test", dag=[[name]], stages={name: stage})


def test_gate_rejected_incremental_refits_the_same_day(twins, monkeypatch):
    """A degraded incremental fine-tune is rejected by the shadow-armed
    gate; the port's runner refits in full the same day, re-gates and
    promotes the refit, as the JAX runner does on the twin store."""
    from bodywork_tpu.models.mlp import MLPRegressor as JaxMLP
    from bodywork_tpu.pipeline import LocalRunner as JaxRunner
    from bodywork_tpu.registry.records import load_record, resolve_alias
    from bodywork_tpu_torch.models.mlp import MLPRegressor
    from bodywork_tpu_torch.pipeline import LocalRunner
    from bodywork_tpu_torch.registry import ModelRegistry

    jax_store, port_store, seed = twins
    drift = JaxDriftConfig(n_samples=80)
    seed(2, drift=drift)
    args = {"mode": "incremental", **MLP_KW}
    port = LocalRunner(_train_only_spec("bodywork_tpu_torch", args), port_store, device="cpu")
    ref = JaxRunner(_train_only_spec("bodywork_tpu", args), jax_store, drift=drift)
    day1, day2 = START + timedelta(days=1), START + timedelta(days=2)
    assert port.run_day(day1).stage_results["registry-gate"].promote
    assert ref.run_day(day1, resume=False).stage_results["registry-gate"].promote

    def sabotaged(original):
        def fine_tune(self, X, y, n_steps, seed=None):
            return original(self, X, np.zeros_like(np.asarray(y)), n_steps, seed=seed)
        return fine_tune

    policies = []
    real_gate = ModelRegistry.gate

    def spy_gate(self, *a, **k):
        policies.append(self.policy.shadow_days)
        return real_gate(self, *a, **k)

    monkeypatch.setattr(MLPRegressor, "fine_tune", sabotaged(MLPRegressor.fine_tune))
    monkeypatch.setattr(JaxMLP, "fine_tune", sabotaged(JaxMLP.fine_tune))
    monkeypatch.setattr(ModelRegistry, "gate", spy_gate)
    seed(1, day2, drift)
    got = port.run_day(day2)
    want = ref.run_day(day2, resume=False)
    final, ref_final = (r.stage_results["stage-1-train-model"] for r in (got, want))
    assert (final.mode, final.fallback_reason) == (ref_final.mode, ref_final.fallback_reason) \
        == ("full", "gate_rejected")
    decision = got.stage_results["registry-gate"]
    assert decision.promote and want.stage_results["registry-gate"].promote
    assert resolve_alias(port_store, "production") == final.model_artefact_key
    # the incremental candidate was gated with the shadow armed, the refit without
    assert policies == [inc.INCREMENTAL_SHADOW_DAYS, 0]
    # the day's record tells the same story in both stores
    events = [[e["event"] for e in load_record(s, final.model_artefact_key)["history"]]
              for s in (port_store, jax_store)]
    assert events[0] == events[1] == ["registered", "gate_decision",  # the fine-tune, rejected
                                      "registered", "gate_decision", "promoted"]


def test_train_mode_knob_and_cli_choices_are_jaxs(monkeypatch):
    from bodywork_tpu.cli import build_parser as jax_parser
    from bodywork_tpu.pipeline.stages import _train_env_mode as jax_env_mode

    def mode_action(parser):
        sub = next(a for a in parser._subparsers._group_actions)
        return next(a for a in sub.choices["train"]._actions if "--mode" in a.option_strings)

    assert tuple(mode_action(cli.build_parser()).choices) \
        == tuple(mode_action(jax_parser()).choices) == TRAIN_MODES
    for raw in ("full", "incremental", "bogus", " incremental ", ""):
        with patch.dict(os.environ, {"BODYWORK_TPU_TRAIN_MODE": raw}):
            assert stages._train_env_mode() == jax_env_mode(), raw
            assert mode_action(cli.build_parser()).default == mode_action(jax_parser()).default
    monkeypatch.delenv("BODYWORK_TPU_TRAIN_MODE", raising=False)
    assert stages._train_env_mode() == "full"


def test_env_knob_drives_the_train_stage(twins, monkeypatch):
    _jax_store, port_store, seed = twins
    seed(2)
    monkeypatch.setenv("BODYWORK_TPU_TRAIN_MODE", "incremental")
    ctx = stages.StageContext(store=port_store, today=START, device=torch.device("cpu"))
    result = stages.train_stage(ctx, "linear")
    assert result.mode == "incremental" and port_store.exists(TS_KEY)
    # an explicit spec arg beats the knob
    assert stages.train_stage(ctx, "linear", mode="full").mode == "full"


def test_cli_train_incremental_prints_the_jax_line(twins, capsys):
    """``train --mode incremental`` prints the JAX command's line shape,
    fallback included; the second day folds with no fallback."""
    _jax_store, port_store, seed = twins
    seed(2)
    argv = ["train", "--store", str(port_store.root), "--mode", "incremental", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.rstrip()
    assert " mode=incremental rows_touched=" in out
    assert out.endswith(" fallback=trainstate_absent")
    seed(1, START + timedelta(days=2))
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert " mode=incremental rows_touched=" in out and "fallback" not in out
