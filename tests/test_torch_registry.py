"""The port's model registry against the JAX package's, on one store.

Both packages write the same bytes for the same checkpoint bytes and
metrics (records and the alias document), each reads what the other
wrote, both serialise their compare-and-swap writes on the same sidecar
lock, and the gate reaches the same decision event. The daily loop: a
store the JAX ``run-sim`` wrote is gated by the port's day-4 ``run-day``
as by the JAX package's."""
import dataclasses
import shutil
import threading
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu import cli as jax_cli
from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.models import LinearRegressor as JaxLinear
from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.pipeline import LocalRunner as JaxRunner
from bodywork_tpu.pipeline.spec import default_pipeline as jax_default_pipeline
from bodywork_tpu.registry import GatePolicy as JaxPolicy
from bodywork_tpu.registry import ModelRegistry as JaxRegistry
from bodywork_tpu.registry import evaluate_candidate as jax_evaluate
from bodywork_tpu.registry.gates import evaluate_quantization as jax_evaluate_quantization
from bodywork_tpu.store.base import DelegatingStore as JaxDelegatingStore
from bodywork_tpu.registry import records as jax_rec
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.registry import (
    GateDecision,
    GatePolicy,
    ModelRegistry,
    PromotionConflict,
    RegistryError,
    RollbackBlocked,
    evaluate_candidate,
)
from bodywork_tpu_torch.registry import records as rec
from bodywork_tpu_torch.registry.gates import evaluate_quantization
from bodywork_tpu_torch.store import CasConflict, FilesystemStore
from bodywork_tpu_torch.store.base import DelegatingStore
from bodywork_tpu_torch.store.epoch import EpochGuardedStore, WriteEpochRevoked

torch.set_num_threads(1)

D = [date(2026, 7, d) for d in range(1, 8)]


def _model_bytes(slope: float, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    y = (1.0 + slope * X + rng.normal(0, 1, 400)).astype(np.float32)
    return jax_ckpt.save_model_bytes(JaxLinear().fit(X, y))


def _metrics_csv(d: date, mape, r2) -> str:
    return f"date,MAPE,r_squared,max_residual\n{d},{mape},{r2},1.0\n"


def _live_csv(d: date, r2: float, mean_error: float = 0.0) -> str:
    return ("date,MAPE,r_squared,max_residual,mean_response_time,n_failures,"
            "mean_error,error_std,n_scored\n"
            f"{d},3.0,{r2},9.0,0.001,0,{mean_error},1.0,100\n")


def _put_model(root, i: int, slope: float = 0.5, metrics=(0.05, 0.95)) -> str:
    """Checkpoint (and, unless ``metrics`` is None, metrics) for day ``i``,
    written as raw bytes so both packages see the same files."""
    store = JaxStore(root)
    key = f"models/regressor-{D[i]}.npz"
    store.put_bytes(key, _model_bytes(slope, seed=i))
    if metrics is not None:
        store.put_text(f"model-metrics/regressor-{D[i]}.csv", _metrics_csv(D[i], *metrics))
    return key


def _registry_bytes(root) -> dict:
    store = FilesystemStore(root)
    return {k: store.get_bytes(k) for k in store.list_keys("registry/")}


@pytest.fixture
def days_root(tmp_path):
    """A store holding three generated days (the shadow window)."""
    root = tmp_path / "jax"
    for d in D[:3]:
        X, y = jax_generate_day(d)
        jax_persist_dataset(JaxStore(root), JaxDataset(X, y, d))
    return root


def _twin(root, tmp_path):
    port_root = tmp_path / "port"
    shutil.copytree(root, port_root)
    return JaxStore(root), FilesystemStore(port_root)


# -- records and aliases: the same bytes, read both ways ---------------------

def test_records_and_aliases_are_byte_identical(days_root, tmp_path):
    keys = [_put_model(days_root, i) for i in range(3)]
    jax_store, port_store = _twin(days_root, tmp_path)
    bounds = {"lo": -12.5, "hi": 88.25}
    for store, r, registry in ((jax_store, jax_rec, JaxRegistry(jax_store)),
                               (port_store, rec, ModelRegistry(port_store))):
        for i, key in enumerate(keys):
            r.register_candidate(store, key, day=D[i], prediction_bounds=bounds)
        registry.promote(keys[0], day=D[0])
        registry.promote(keys[1], day=D[1])
        registry.demote(keys[2], day=D[2], reason="operator")
        registry.rollback(day=D[2])
        # a re-register of the same bytes is a no-op in both
        r.register_candidate(store, keys[0], day=D[0], prediction_bounds=bounds)
    got, want = _registry_bytes(port_store.root), _registry_bytes(jax_store.root)
    assert sorted(got) == sorted(want) == sorted(
        ["registry/aliases.json"] + [f"registry/records/regressor-{D[i]}.json" for i in range(3)])
    assert got == want


def test_jax_writes_and_the_port_reads(days_root, tmp_path):
    a, b = _put_model(days_root, 0), _put_model(days_root, 1)
    store = JaxStore(days_root)
    for key, d in ((a, D[0]), (b, D[1])):
        jax_rec.register_candidate(store, key, day=d)
        JaxRegistry(store).gate(day=d)
    port_store = FilesystemStore(days_root)
    assert rec.read_aliases(port_store) == jax_rec.read_aliases(store)
    assert rec.list_records(port_store) == jax_rec.list_records(store)
    assert port_ckpt.resolve_serving_key(port_store) == jax_ckpt.resolve_serving_key(store) \
        == (b, "production")
    # the port moves the JAX registry and the JAX package reads it back
    ModelRegistry(port_store).rollback(day=D[2])
    assert jax_rec.resolve_alias(store) == a
    assert jax_rec.load_record(store, b)["status"] == "rejected"


def test_port_writes_and_jax_reads(days_root, tmp_path):
    a, b = _put_model(days_root, 0), _put_model(days_root, 1, metrics=(0.05, 0.1))
    port_store = FilesystemStore(days_root)
    for key, d in ((a, D[0]), (b, D[1])):
        rec.register_candidate(port_store, key, day=d)
        ModelRegistry(port_store).gate(day=d)
    store = JaxStore(days_root)
    assert jax_rec.read_aliases(store) == rec.read_aliases(port_store)
    assert jax_rec.list_records(store) == rec.list_records(port_store)
    assert [r["status"] for r in jax_rec.list_records(store)] == ["production", "rejected"]
    assert jax_ckpt.resolve_serving_key(store) == port_ckpt.resolve_serving_key(port_store) \
        == (a, "production")
    assert JaxRegistry(store).gate(day=D[2]) is None  # nothing left to gate


def test_rejected_bootstrap_candidate_is_skipped_like_jax(days_root, tmp_path):
    """No promotion ever: the latest-checkpoint fallback skips what the
    gate rejected, in both packages."""
    a = _put_model(days_root, 0)
    b = _put_model(days_root, 1, metrics=(0.05, 0.1))
    jax_store, port_store = _twin(days_root, tmp_path)
    jax_rec.register_candidate(jax_store, b, day=D[1])
    rec.register_candidate(port_store, b, day=D[1])
    assert not JaxRegistry(jax_store).gate(day=D[1]).promote
    assert not ModelRegistry(port_store).gate(day=D[1]).promote
    assert port_ckpt.resolve_serving_key(port_store) \
        == jax_ckpt.resolve_serving_key(jax_store) == (a, "latest")


# -- compare-and-swap ---------------------------------------------------------

def _race(monkeypatch, modules, promote_for, keys):
    """Run one promoter per entry of ``modules`` on threads, each paused
    after its alias read until every one has read the same revision."""
    barrier = threading.Barrier(len(modules))
    for module in set(modules):
        original = module.read_aliases

        def paused(store, with_token=False, _original=original):
            out = _original(store, with_token=with_token)
            if with_token:
                barrier.wait(timeout=10)
            return out

        monkeypatch.setattr(module, "read_aliases", paused)
    results = [None] * len(modules)

    def racer(i):
        try:
            promote_for(i)(keys[i])
            results[i] = "won"
        except Exception as exc:  # noqa: BLE001 - the outcome is the test
            results[i] = type(exc).__name__

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(len(modules))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    return results


def test_two_promoting_threads_exactly_one_wins(days_root, monkeypatch):
    keys = [_put_model(days_root, i) for i in range(2)]
    store = FilesystemStore(days_root)
    for i, key in enumerate(keys):
        rec.register_candidate(store, key, day=D[i])
    registry = ModelRegistry(store)
    results = _race(monkeypatch, [rec, rec], lambda i: registry.promote, keys)
    assert sorted(results) == [PromotionConflict.__name__, "won"]
    doc = rec.read_aliases(store)
    assert doc["production"] == keys[results.index("won")] and doc["rev"] == 1


def test_a_jax_promoter_and_a_port_promoter_exactly_one_wins(days_root, monkeypatch):
    """Both packages' CAS writers take the same sidecar flock and compare
    the same version token."""
    keys = [_put_model(days_root, i) for i in range(2)]
    jax_store, port_store = JaxStore(days_root), FilesystemStore(days_root)
    for i, key in enumerate(keys):
        rec.register_candidate(port_store, key, day=D[i])
    promoters = [JaxRegistry(jax_store).promote, ModelRegistry(port_store).promote]
    results = _race(monkeypatch, [jax_rec, rec], lambda i: promoters[i], keys)
    assert sorted(results) == ["PromotionConflict", "won"]
    assert jax_rec.read_aliases(jax_store)["production"] == keys[results.index("won")]


def test_cas_semantics_and_the_epoch_fence(tmp_path):
    store = FilesystemStore(tmp_path)
    token = store.put_bytes_if_match("registry/aliases.json", b"a", None)
    assert token == store.version_token("registry/aliases.json")
    with pytest.raises(CasConflict, match="create-only"):
        store.put_bytes_if_match("registry/aliases.json", b"b", None)
    with pytest.raises(CasConflict, match="token changed"):
        store.put_bytes_if_match("registry/aliases.json", b"b", (0, 0, 0))
    store.put_bytes_if_match("registry/aliases.json", b"c", token)
    assert store.get_bytes("registry/aliases.json") == b"c"
    assert not store.list_keys("registry/.tmp")  # the lock file stays unlisted
    fenced = EpochGuardedStore(store, label="stage-x")
    fenced.revoke()
    with pytest.raises(WriteEpochRevoked):
        fenced.put_bytes_if_match("registry/aliases.json", b"d",
                                  store.version_token("registry/aliases.json"))
    with pytest.raises(WriteEpochRevoked):
        fenced.delete("registry/aliases.json")
    assert store.get_bytes("registry/aliases.json") == b"c"


def _corrupting(base):
    class Corrupting(base):
        """Hands out the first ``n`` reads of registry records cut in half."""

        def __init__(self, inner, n):
            super().__init__(inner)
            self.remaining = n

        def get_bytes(self, key):
            data = self._inner.get_bytes(key)
            if key.startswith("registry/records/") and self.remaining > 0:
                self.remaining -= 1
                return data[: max(1, len(data) // 2)]
            return data

    return Corrupting


@pytest.mark.parametrize("corrupt_reads,loads", [(2, True), (10, False)],
                         ids=["within-retries", "past-retries"])
def test_a_corrupt_record_is_retried_then_flagged_like_jax(corrupt_reads, loads, days_root):
    """Corrupt reads within the retry budget still load the record; past
    it the record reads as absent and the store's registry state is
    flagged for repair, in both packages."""
    key = _put_model(days_root, 0)
    JaxRegistry(JaxStore(days_root)).register(key)
    flags = []
    for module, store, base in ((jax_rec, JaxStore(days_root), JaxDelegatingStore),
                                (rec, FilesystemStore(days_root), DelegatingStore)):
        wrapped = _corrupting(base)(store, corrupt_reads)
        assert (module.load_record(wrapped, key) is not None) == loads
        flags.append(wrapped.mutable_cache("_registry_state").get("repair_needed"))
        assert store.mutable_cache("_registry_state") is wrapped.mutable_cache(
            "_registry_state")
    assert flags == ([None, None] if loads else [True, True])


@pytest.mark.parametrize("report,policy", [
    ({"mean_abs_delta": 0.01, "days": 3, "rows": 900,
      "candidate_mape": 0.051, "production_mape": 0.05}, {}),
    ({"mean_abs_delta": 0.5, "days": 3, "rows": 900,
      "candidate_mape": 0.05, "production_mape": 0.05}, {}),
    ({"mean_abs_delta": 0.01, "days": 3, "rows": 900,
      "candidate_mape": 0.09, "production_mape": 0.05}, {}),
    ({"mean_abs_delta": 0.01, "days": 1, "rows": 300,
      "candidate_mape": float("nan"), "production_mape": 0.05}, {}),
    ({"mean_abs_delta": 0.01, "days": 1, "rows": 300,
      "candidate_mape": None, "production_mape": None}, {}),
    ({"mean_abs_delta": 0.01, "days": 2, "rows": 600,
      "candidate_mape": 0.2, "production_mape": None}, {}),
    ({"mean_abs_delta": 0.3, "days": 3, "rows": 900,
      "candidate_mape": 0.09, "production_mape": 0.05},
     {"shadow_max_mean_abs_delta": None, "shadow_max_mape_ratio": 2.0,
      "quantized_shadow_days": 5}),
], ids=["within", "delta", "mape-ceiling", "nan-mape", "no-mape", "no-production-mape",
        "custom-policy"])
def test_quantization_verdicts_equal_jaxs(report, policy):
    """The quantized-serving verdict over a shadow report, with the
    default policy and with one that moves the ceilings (the policies'
    defaults, ``quantized_shadow_days`` included, are the same too)."""
    assert dataclasses.asdict(GatePolicy()) == dataclasses.asdict(JaxPolicy())
    assert (evaluate_quantization(report, GatePolicy(**policy))
            == jax_evaluate_quantization(report, JaxPolicy(**policy)))


# -- the gate: the same decision events ----------------------------------------

def _scenario(name, root):
    """Set up one gate scenario on ``root``; returns (candidate key,
    production key or None, policy kwargs)."""
    prod = None
    if name != "bootstrap":
        prod = _put_model(root, 0, metrics=(0.05, 0.95 if name != "pass" else 0.9))
        jax_rec.register_candidate(JaxStore(root), prod, day=D[0])
        JaxRegistry(JaxStore(root)).promote(prod, day=D[0])
    cand_metrics = {
        "bootstrap": (0.05, 0.95), "pass": (0.06, 0.85), "min_r2": (0.05, 0.1),
        "r2_drop": (0.5, 0.5), "drift_override": (0.5, 0.5), "missing_metrics": None,
        "non_finite": (0.05, "nan"), "opt_in_mape": (0.5, 0.9), "shadow": (0.05, 0.95),
    }[name]
    cand = _put_model(root, 1, slope=2.0 if name == "shadow" else 0.5, metrics=cand_metrics)
    jax_rec.register_candidate(JaxStore(root), cand, day=D[1])
    if name == "drift_override":
        for d in D[:2]:
            JaxStore(root).put_text(f"test-metrics/regressor-test-results-{d}.csv",
                                    _live_csv(d, r2=0.05, mean_error=5.0))
    policy = {"opt_in_mape": {"max_mape": 0.1, "max_mape_vs_production": 1.2},
              "shadow": {"shadow_days": 2, "shadow_max_mean_abs_delta": 1.0}}.get(name, {})
    return cand, prod, policy


SCENARIOS = ["bootstrap", "pass", "min_r2", "r2_drop", "drift_override",
             "missing_metrics", "non_finite", "opt_in_mape", "shadow"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_gate_decisions_equal_jaxs(name, days_root, tmp_path):
    cand, prod, policy = _scenario(name, days_root)
    jax_store, port_store = _twin(days_root, tmp_path)
    want = jax_evaluate(jax_store, jax_rec.load_record(jax_store, cand),
                        jax_rec.load_record(jax_store, prod) if prod else None,
                        policy=JaxPolicy(**policy), day=D[1])
    got = evaluate_candidate(port_store, rec.load_record(port_store, cand),
                             rec.load_record(port_store, prod) if prod else None,
                             policy=GatePolicy(**policy), day=D[1], device="cpu")
    assert isinstance(got, GateDecision)
    expect_promote = name in ("bootstrap", "pass", "drift_override")
    assert got.promote is want.promote is expect_promote
    JaxRegistry(jax_store, policy=JaxPolicy(**policy)).gate(day=D[1])
    ModelRegistry(port_store, policy=GatePolicy(**policy), device="cpu").gate(day=D[1])
    if name != "shadow":
        assert got.to_event() == want.to_event()
        # applied through the registry: the same records and alias bytes
        assert _registry_bytes(port_store.root) == _registry_bytes(jax_store.root)
        return
    # the shadow scores both models through each package's own predict:
    # XLA fuses the linear model's multiply-add, torch rounds twice, so
    # the report's means agree to float32 rounding, not bit for bit
    got_event, want_event = got.to_event(), want.to_event()
    got_shadow, want_shadow = got_event.pop("shadow"), want_event.pop("shadow")
    assert got_shadow.keys() == want_shadow.keys()
    for k, v in want_shadow.items():
        assert got_shadow[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    assert [(c["name"], c["ok"]) for c in got_event.pop("checks")] == \
        [(c["name"], c["ok"]) for c in want_event.pop("checks")]
    assert len(got_event.pop("reasons")) == len(want_event.pop("reasons")) == 1
    assert got_event == want_event
    assert rec.read_aliases(port_store) == jax_rec.read_aliases(jax_store)
    assert [r["status"] for r in rec.list_records(port_store)] == \
        [r["status"] for r in jax_rec.list_records(jax_store)]


def test_gate_dry_run_writes_nothing(days_root):
    _put_model(days_root, 0)
    store = FilesystemStore(days_root)
    rec.register_candidate(store, "models/regressor-2026-07-01.npz", day=D[0])
    before = _registry_bytes(days_root)
    decision = ModelRegistry(store).gate(day=D[0], dry_run=True)
    assert decision.promote and _registry_bytes(days_root) == before
    with pytest.raises(RegistryError, match="unregistered"):
        ModelRegistry(store).promote("models/regressor-2026-07-05.npz")


# -- rollback refusals ------------------------------------------------------------

@pytest.fixture
def rolled(days_root):
    """Two promotions: production day 2, previous day 1."""
    store = FilesystemStore(days_root)
    keys = [_put_model(days_root, i) for i in range(2)]
    for i, key in enumerate(keys):
        rec.register_candidate(store, key, day=D[i])
        ModelRegistry(store).promote(key, day=D[i])
    return store, keys


@pytest.mark.parametrize("damage,reason", [
    ("delete", "missing"), ("flip", "no longer matches"),
])
def test_rollback_refuses_a_damaged_previous(rolled, damage, reason, capsys):
    store, (a, b) = rolled
    if damage == "delete":
        store.delete(a)
    else:
        data = bytearray(store.get_bytes(a))
        data[len(data) // 2] ^= 0xFF
        store.put_bytes(a, bytes(data))
    with pytest.raises(RollbackBlocked, match=reason):
        ModelRegistry(store).rollback(day=D[2])
    assert rec.resolve_alias(store) == b  # the alias did not move
    refused = rec.load_record(store, a)["history"][-1]
    assert refused["event"] == "rollback_refused"
    rc = cli.main(["registry", "rollback", "--store", str(store.root), "--date", str(D[2])])
    assert rc == cli.ROLLBACK_REFUSED_EXIT == jax_cli.ROLLBACK_REFUSED_EXIT == 8
    assert rec.resolve_alias(store) == b


def test_rollback_flips_when_the_previous_is_sound(rolled, capsys):
    store, (a, b) = rolled
    assert cli.main(["registry", "rollback", "--store", str(store.root),
                     "--date", str(D[2])]) == 0
    assert capsys.readouterr().out.strip() == f"production -> {a} (previous: {b})"
    assert rec.load_record(store, b)["status"] == "rejected"
    # a stale token: another writer moved the alias since this read
    doc, token = rec.read_aliases(store, with_token=True)
    ModelRegistry(store).promote(b)
    with pytest.raises(CasConflict):
        rec.write_aliases(store, doc, token)
    assert rec.resolve_alias(store) == b


# -- the command line, against the JAX command's output ---------------------------

@pytest.mark.parametrize("argv", [
    ["registry", "list"],
    ["registry", "show", "production"],
    ["registry", "show", "2026-07-01"],
    ["registry", "show", "aliases"],
    ["registry", "show", "prodution"],
    ["registry", "gate", "--date", "2026-07-03", "--dry-run"],
    ["registry", "promote", "--model", "2026-07-03", "--date", "2026-07-03"],
], ids=lambda a: "-".join(a[1:3]))
def test_cli_output_and_exit_codes_equal_jaxs(argv, days_root, tmp_path, capsys):
    keys = [_put_model(days_root, i) for i in range(3)]
    store = JaxStore(days_root)
    for i, key in enumerate(keys[:2]):
        jax_rec.register_candidate(store, key, day=D[i])
        JaxRegistry(store).gate(day=D[i])
    jax_rec.register_candidate(store, keys[2], day=D[2])
    jax_store, port_store = _twin(days_root, tmp_path)
    rc_jax = jax_cli.main(argv + ["--store", str(jax_store.root)])
    out_jax = capsys.readouterr().out
    rc = cli.main(argv + ["--store", str(port_store.root)])
    assert (rc, capsys.readouterr().out) == (rc_jax, out_jax)
    assert _registry_bytes(port_store.root) == _registry_bytes(jax_store.root)


# -- the daily loop: a JAX run-sim store gated by the port --------------------------

def test_port_run_day_gates_a_jax_run_sim_store_like_jax(tmp_path):
    """The JAX package's 3-day linear run-sim, then day 4 of ``run-day``
    by each package on its own copy: the same verdict and checks, and the
    port serves the ``production`` alias."""
    root = tmp_path / "jax"
    JaxRunner(jax_default_pipeline("linear"), JaxStore(root)).run_simulation(D[0], 3)
    port_root = tmp_path / "port"
    shutil.copytree(root, port_root)
    want = JaxRunner(jax_default_pipeline("linear"), JaxStore(root)).run_day(D[3])
    got = LocalRunner(default_pipeline("linear"), FilesystemStore(port_root),
                      device="cpu").run_day(D[3])
    jd, pd_ = want.stage_results["registry-gate"], got.stage_results["registry-gate"]
    assert isinstance(pd_, GateDecision) and pd_.model_key == jd.model_key
    assert pd_.promote == jd.promote
    assert [(c["name"], c["ok"]) for c in pd_.checks] == [(c["name"], c["ok"]) for c in jd.checks]
    assert got.gate_seconds is not None and got.gate_seconds > 0
    health = got.stage_results["stage-2-serve-model"].app.healthz_payload()
    assert health["model_source"] == "production"
    assert health["model_key"] == rec.resolve_alias(FilesystemStore(port_root))
    assert [r["status"] for r in rec.list_records(FilesystemStore(port_root))] == \
        [r["status"] for r in jax_rec.list_records(JaxStore(root))]
