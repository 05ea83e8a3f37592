"""The port's multi-tenancy layer (``bodywork_tpu_torch.tenancy``) against
the JAX package's (``bodywork_tpu.tenancy``), on the same inputs: the
contracts of ``tests/test_tenancy.py`` (the fleet soak's are in
``tests/test_torch_fleet.py``).

1. ``TenantStore`` rebases every key under ``tenants/<id>/`` and the
   ``default`` tenant is the identity; each package reads what the other
   wrote through its view.
2. Tenant-id validation is one function: the cli ``--tenant`` flag, the
   ``BODYWORK_TPU_TENANT`` knob and the key charset accept and reject the
   same ids in both packages.
3. ``StackedMLPPredictor``: ``scan`` bytes equal to each tenant's solo
   ``torch`` predictor and within 2e-4 of JAX's stacked outputs; ``vmap``
   within its stated tolerance; LRU residency with canary slots; the
   sub-budget before any device work; residency churn that builds no
   program.
4. The zoo, the generated days and the scheduler equal the JAX package's.
5. Listings stay prefix-bounded on the backend.
6. The journal and the day report carry ``tenant`` as JAX's do.
"""
import dataclasses
import json
from datetime import date
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bodywork_tpu import tenancy as jax_tenancy
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.tenancy import stacked as jax_stacked
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import (
    ALL_PREFIXES,
    DEFAULT_TENANT,
    REGISTRY_RECORDS_PREFIX,
    TENANTS_PREFIX,
    tenant_prefix,
    validate_tenant_id,
)
from bodywork_tpu_torch.tenancy import (
    SCENARIOS,
    TRAFFIC_SHAPES,
    FairScheduler,
    TenantSpec,
    TenantStore,
    list_tenants,
    scoped_store,
    tenant_from_env,
    traffic_profile,
    zoo,
)
from bodywork_tpu_torch.tenancy.namespace import TENANT_ENV, tenant_of
from bodywork_tpu_torch.tenancy.stacked import (
    DEFAULT_STACK_BUCKETS,
    STACK_MODES,
    VMAP_RTOL,
    StackedMLPPredictor,
    StackNotCompatible,
    TenantNotResident,
    TenantOverBudget,
)
from tests.test_torch_snapshot import CountingStore

torch.set_num_threads(1)


# --- namespacing ------------------------------------------------------------


def test_tenant_store_rebases_every_op_and_the_jax_view_reads_it(tmp_path):
    backend = FilesystemStore(tmp_path)
    view = scoped_store(backend, "acme")
    assert isinstance(view, TenantStore)
    view.put_bytes("datasets/2026-01-01.csv", b"x,y\n1,2\n")
    assert backend.list_keys() == ["tenants/acme/datasets/2026-01-01.csv"]
    assert view.list_keys() == ["datasets/2026-01-01.csv"]
    assert view.get_bytes("datasets/2026-01-01.csv") == b"x,y\n1,2\n"
    assert view.exists("datasets/2026-01-01.csv")
    assert not backend.exists("datasets/2026-01-01.csv")
    assert view.get_many(["datasets/2026-01-01.csv"]) == {"datasets/2026-01-01.csv": b"x,y\n1,2\n"}
    toks = view.version_tokens(["datasets/2026-01-01.csv"])
    assert toks["datasets/2026-01-01.csv"] == view.version_token("datasets/2026-01-01.csv")
    jax_view = jax_tenancy.scoped_store(JaxStore(tmp_path), "acme")
    assert jax_view.list_keys() == view.list_keys()
    assert jax_view.get_bytes("datasets/2026-01-01.csv") == b"x,y\n1,2\n"
    view.delete("datasets/2026-01-01.csv")
    assert backend.list_keys() == []


def test_default_tenant_is_identity(tmp_path):
    backend = FilesystemStore(tmp_path)
    assert scoped_store(backend, DEFAULT_TENANT) is backend
    assert tenant_of(backend) == DEFAULT_TENANT
    assert tenant_prefix(DEFAULT_TENANT) == ""
    assert tenant_prefix("acme") == "tenants/acme/"


def test_two_tenants_share_key_names_not_content(tmp_path):
    backend = FilesystemStore(tmp_path)
    a, b = scoped_store(backend, "acme"), scoped_store(backend, "bravo")
    a.put_bytes("registry/aliases.json", b'{"production": "a"}')
    b.put_bytes("registry/aliases.json", b'{"production": "b"}')
    assert a.get_bytes("registry/aliases.json") != b.get_bytes("registry/aliases.json")
    a.mutable_cache("parsed")["k"] = "from-a"
    assert "k" not in b.mutable_cache("parsed")
    assert "k" not in backend.mutable_cache("parsed")


def test_tenant_of_walks_wrapper_chain(tmp_path):
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.store.base import DelegatingStore

    backend = FilesystemStore(tmp_path)
    view = scoped_store(backend, "acme")
    assert tenant_of(view) == "acme"
    assert tenant_of(DelegatingStore(view)) == "acme"
    assert tenant_of(DelegatingStore(backend)) == DEFAULT_TENANT
    assert tenant_of(scoped_store(open_store(str(tmp_path)), "acme")) == "acme"


def test_list_tenants_skips_invalid_segments_as_jax_does(tmp_path):
    backend = FilesystemStore(tmp_path)
    scoped_store(backend, "bravo").put_bytes("a.txt", b"1")
    scoped_store(backend, "acme").put_bytes("a.txt", b"1")
    backend.put_bytes(f"{TENANTS_PREFIX}Bad_Tenant/a.txt", b"1")
    backend.put_bytes("datasets/2026-01-01.csv", b"x,y\n")
    assert list_tenants(backend) == ["acme", "bravo"]
    assert list_tenants(backend) == jax_tenancy.list_tenants(JaxStore(tmp_path))


# --- validation: one source of truth (cli flag == env == key charset) -------


@pytest.mark.parametrize("candidate, valid", [
    ("acme", True), ("tenant-00", True), ("a", True), ("0numeric-start", True),
    ("a" * 63, True), ("", False), ("Upper", False), ("under_score", False),
    ("-leading", False), ("trailing-", False), ("dou--ble", False), ("a" * 64, False),
    ("dots.not.ok", False), ("slash/attack", False), ("../escape", False),
])
def test_tenant_validation_single_source_of_truth(candidate, valid):
    """The charset, the port's ``--tenant`` flag and its env knob accept
    and reject exactly what the JAX package's do."""
    from bodywork_tpu.cli import _tenant_id as jax_tenant_id
    from bodywork_tpu_torch.cli import _tenant_id

    if valid:
        assert validate_tenant_id(candidate) == candidate
        assert _tenant_id(SimpleNamespace(tenant=candidate)) == candidate
        assert tenant_from_env({TENANT_ENV: candidate}) == candidate
    else:
        with pytest.raises(ValueError):
            validate_tenant_id(candidate)
        if candidate:
            with pytest.raises(ValueError):
                _tenant_id(SimpleNamespace(tenant=candidate))
            with pytest.raises(ValueError):
                jax_tenant_id(SimpleNamespace(tenant=candidate))
        assert tenant_from_env({TENANT_ENV: candidate}) == DEFAULT_TENANT
    assert tenant_from_env({TENANT_ENV: candidate}) == jax_tenancy.tenant_from_env(
        {TENANT_ENV: candidate})


def test_tenant_env_unset_is_default():
    assert tenant_from_env({}) == DEFAULT_TENANT
    assert tenant_from_env({TENANT_ENV: "  "}) == DEFAULT_TENANT
    assert TENANT_ENV == jax_tenancy.TENANT_ENV


def test_tenants_prefix_is_schema_covered():
    from bodywork_tpu_torch.audit.fsck import CHECKERS

    assert TENANTS_PREFIX in ALL_PREFIXES
    assert TENANTS_PREFIX in CHECKERS


def _parser_tree(parser):
    import argparse

    yield parser
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            seen = set()
            for child in action.choices.values():
                if id(child) not in seen:
                    seen.add(id(child))
                    yield from _parser_tree(child)


def test_every_store_command_grows_a_tenant_flag():
    from bodywork_tpu_torch.cli import build_parser

    with_store = 0
    for p in _parser_tree(build_parser()):
        options = {s for a in p._actions for s in a.option_strings}
        if "--store" in options:
            with_store += 1
            assert "--tenant" in options, p.prog
    assert with_store >= 10


def test_cli_rejects_malformed_tenant_flag(tmp_path, capsys):
    """A typo'd ``--tenant`` fails the command (exit 1, the JAX command's),
    never reading or writing the root namespace."""
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    assert main(["fsck", "--store", str(tmp_path / "s"), "--tenant", "Bad_Id"]) == 1
    assert jax_main(["fsck", "--store", str(tmp_path / "j"), "--tenant", "Bad_Id"]) == 1
    assert not (tmp_path / "s").exists()


def test_tenancy_metric_names_are_the_jax_names():
    from bodywork_tpu_torch.obs.registry import METRIC_NAME_RE
    from bodywork_tpu_torch.tenancy.stacked import _tenancy_metrics

    instruments = _tenancy_metrics()
    assert len(instruments) == 5
    assert [i.name for i in instruments] == [i.name for i in jax_stacked._tenancy_metrics()]
    for inst in instruments:
        assert METRIC_NAME_RE.match(inst.name), inst.name


# --- scenario zoo, generated days and the fair scheduler ---------------------


def test_tenant_spec_validates_its_fields():
    with pytest.raises(ValueError):
        TenantSpec(tenant_id="Bad_Id")
    with pytest.raises(ValueError):
        TenantSpec(tenant_id="ok", scenario="mystery")
    with pytest.raises(ValueError):
        TenantSpec(tenant_id="ok", traffic="tsunami")


def test_tenant_seeds_and_configs_are_the_jax_packages():
    a1, b = TenantSpec(tenant_id="acme", base_seed=42), TenantSpec(tenant_id="bravo", base_seed=42)
    assert a1.seed == TenantSpec(tenant_id="acme", base_seed=42).seed
    assert a1.seed != b.seed != TenantSpec(tenant_id="acme", base_seed=43).seed
    for scenario in SCENARIOS:
        for tid, seed in (("acme", 42), ("tenant-07", 11)):
            port = TenantSpec(tenant_id=tid, scenario=scenario, base_seed=seed)
            jax = jax_tenancy.TenantSpec(tenant_id=tid, scenario=scenario, base_seed=seed)
            assert port.seed == jax.seed
            assert port.effective_label_delay == jax.effective_label_delay
            assert dataclasses.asdict(port.drift_config()) == dataclasses.asdict(
                jax.drift_config())
    configs = {s: TenantSpec(tenant_id="acme", scenario=s).drift_config() for s in SCENARIOS}
    assert configs["baseline"] == configs["label-delay"]
    assert configs["covariate-shift"].x_low > configs["baseline"].x_low
    assert configs["heteroscedastic"].hetero > 0.0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_a_tenants_generated_day_is_the_jax_packages(scenario):
    """Each scenario's day through ``data/prng.py``'s threefry: the same
    kept rows, ``X`` bit for bit, and ``y`` within two ulps of the day's
    largest label, the generator's recorded bar (``tests/test_torch_prng.py``:
    the normal draws differ from ``jax.random.normal`` in their last bits)."""
    from bodywork_tpu.data import generate_day as jax_generate_day
    from bodywork_tpu_torch.data import generate_day

    spec = TenantSpec(tenant_id="tenant-03", scenario=scenario, base_seed=11, n_samples=64)
    jax_spec = jax_tenancy.TenantSpec(tenant_id="tenant-03", scenario=scenario, base_seed=11,
                                      n_samples=64)
    X, y = generate_day(date(2026, 3, 2), spec.drift_config(), device="cpu")
    jX, jy = jax_generate_day(date(2026, 3, 2), jax_spec.drift_config())
    np.testing.assert_array_equal(np.asarray(X).view(np.int32), np.asarray(jX).view(np.int32))
    atol = 2 * float(np.spacing(np.float32(np.abs(np.asarray(jy)).max())))
    np.testing.assert_allclose(np.asarray(y), np.asarray(jy), rtol=0, atol=atol)


def test_traffic_profiles_are_shaped_and_the_jax_packages():
    n = 40
    assert set(traffic_profile(TenantSpec(tenant_id="acme", traffic="steady"), n)) == {100.0}
    flash = TenantSpec(tenant_id="acme", traffic="flash-crowd", burst_x=4.0)
    prof = traffic_profile(flash, n)
    assert prof.count(400.0) == max(1, int(n * 0.15)) and set(prof) == {100.0, 400.0}
    storm = traffic_profile(TenantSpec(tenant_id="acme", traffic="retry-storm", burst_x=4.0), n)
    trigger = n // 3
    assert set(storm[:trigger]) == {100.0} and storm[trigger] == 400.0
    assert all(storm[i] > storm[i + 1] for i in range(trigger, n - 1)) and storm[-1] < 110.0
    dp = traffic_profile(TenantSpec(tenant_id="acme", traffic="diurnal"), n)
    assert max(dp) > 100.0 > min(dp) and abs(sum(dp) / n - 100.0) < 2.0
    for shape in TRAFFIC_SHAPES:
        for tid in ("acme", "tenant-02"):
            assert traffic_profile(TenantSpec(tenant_id=tid, traffic=shape), 37, 55.0) == \
                jax_tenancy.traffic_profile(
                    jax_tenancy.TenantSpec(tenant_id=tid, traffic=shape), 37, 55.0)


def test_zoo_cycles_the_catalogues_as_jax_does():
    specs = zoo(len(SCENARIOS) + 3, base_seed=7, n_samples=48)
    assert [s.scenario for s in specs[:len(SCENARIOS)]] == list(SCENARIOS)
    assert specs[0].tenant_id == "tenant-00"
    assert specs[0].scenario == "baseline" and specs[0].traffic == "steady"
    for s in specs:
        assert s.traffic in TRAFFIC_SHAPES
        assert s.effective_label_delay == (1 if s.scenario == "label-delay" else 0)
    assert [dataclasses.asdict(s) for s in specs] == [
        dataclasses.asdict(s) for s in jax_tenancy.zoo(len(SCENARIOS) + 3, base_seed=7,
                                                       n_samples=48)]


def test_fair_scheduler_rotates_the_head_as_jax_does():
    sched, jax_sched = FairScheduler(), jax_tenancy.FairScheduler()
    tenants = ["c", "a", "b"]
    heads = [sched.order(tenants)[0] for _ in range(6)]
    assert heads == ["a", "b", "c", "a", "b", "c"]
    for _ in range(6):
        jax_sched.order(tenants)
    for ring in (tenants, tenants, [], tenants + ["d"], ["d", "b"], tenants):
        assert sched.peek(ring) == jax_sched.peek(ring)
        assert sched.order(ring) == jax_sched.order(ring)
    nxt = sched.peek(tenants)
    assert sched.order(tenants) == nxt


# --- stacked multi-tenant serving -------------------------------------------


def _train_mlps(n, hidden=(8,), n_steps=25):
    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor

    rng = np.random.default_rng(0)
    X = rng.uniform(0.0, 100.0, size=(96, 1)).astype(np.float32)
    models = []
    for i in range(n):
        y = (1.5 + 0.1 * i) * X[:, 0] + rng.normal(0, 2.0, size=96)
        models.append(MLPRegressor(MLPConfig(hidden=hidden, n_steps=n_steps, seed=100 + i))
                      .fit(X, y.astype(np.float32), device="cpu"))
    return models


def _jax_twin(model):
    """The JAX package's MLP with the port model's parameters."""
    from bodywork_tpu.models.mlp import MLPConfig, MLPRegressor

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return tree.detach().cpu().numpy()

    return MLPRegressor(MLPConfig(hidden=tuple(model.config.hidden)), host(model.params))


@pytest.fixture(scope="module")
def fleet_models():
    return _train_mlps(5)


def _stack(**kw):
    return StackedMLPPredictor(device="cpu", **kw)


def test_stacked_scan_byte_identical_to_solo_and_close_to_jax(fleet_models):
    """Scan mode's bar: each tenant's rows through the stacked dispatch are
    exactly its solo ``torch`` predictor's bytes, and within 2e-4 of the
    JAX package's stacked outputs on the same parameters and rows."""
    from bodywork_tpu_torch.serve.predictor import PaddedPredictor

    stack = _stack(capacity=4, buckets=(8, 64))
    jax_stack = jax_stacked.StackedMLPPredictor(capacity=4, buckets=(8, 64))
    tenants = [f"t-{i}" for i in range(3)]
    for tid, model in zip(tenants, fleet_models):
        stack.admit(tid, model)
        jax_stack.admit(tid, _jax_twin(model))
    rng = np.random.default_rng(7)
    batches = {tid: rng.uniform(0, 100, size=(5 + 3 * i, 1)).astype(np.float32)
               for i, tid in enumerate(tenants)}
    out = stack.predict_multi(batches)
    jax_out = jax_stack.predict_multi(batches)
    for tid, model in zip(tenants, fleet_models):
        solo = PaddedPredictor(model, buckets=(8, 64)).predict(batches[tid])
        np.testing.assert_array_equal(np.asarray(out[tid]).ravel(), np.asarray(solo).ravel())
        np.testing.assert_allclose(np.asarray(out[tid]).ravel(),
                                   np.asarray(jax_out[tid]).ravel(), rtol=2e-4, atol=2e-4)


def test_stacked_vmap_close_but_opt_in(fleet_models):
    """``vmap`` is the batched form: within :data:`VMAP_RTOL` of the
    outputs' scale from the solo program, and from JAX's own vmap stack."""
    from bodywork_tpu_torch.serve.predictor import PaddedPredictor

    assert STACK_MODES == jax_stacked.STACK_MODES == ("scan", "vmap")
    assert _stack(capacity=2).stack_mode == "scan"
    stack = _stack(capacity=2, buckets=(8,), stack_mode="vmap")
    jax_stack = jax_stacked.StackedMLPPredictor(capacity=2, buckets=(8,), stack_mode="vmap")
    stack.admit("t-0", fleet_models[0])
    jax_stack.admit("t-0", _jax_twin(fleet_models[0]))
    X = np.linspace(0, 100, 8, dtype=np.float32)[:, None]
    got = np.asarray(stack.predict("t-0", X)).ravel()
    solo = np.asarray(PaddedPredictor(fleet_models[0], buckets=(8,)).predict(X)).ravel()
    scale = float(np.abs(solo).max())
    np.testing.assert_allclose(got, solo, rtol=0, atol=VMAP_RTOL * scale)
    np.testing.assert_allclose(got, np.asarray(jax_stack.predict("t-0", X)).ravel(),
                               rtol=0, atol=VMAP_RTOL * scale)


def test_stacked_lru_eviction_under_pressure(fleet_models):
    stack = _stack(capacity=2, buckets=(8,))
    m = fleet_models
    stack.admit("t-a", m[0])
    stack.admit("t-b", m[1])
    assert stack.resident() == ("t-a", "t-b")
    stack.predict("t-a", np.ones((2, 1), np.float32))  # t-a becomes most recent
    stack.admit("t-c", m[2])  # full: evicts LRU-oldest = t-b
    assert stack.resident() == ("t-a", "t-c")
    assert not stack.is_resident("t-b")
    stack.admit("t-a", m[0])  # refreshed in place
    assert set(stack.resident()) == {"t-a", "t-c"}
    stack.evict("t-c")
    assert stack.resident() == ("t-a",)
    stack.evict("t-c")  # idempotent


def test_stacked_canary_slots_are_reserved(fleet_models):
    m = fleet_models
    stack = _stack(capacity=3, buckets=(8,), canary_slots=1)
    stack.admit("canary-x", m[0], canary=True)
    stack.admit("t-a", m[1])
    stack.admit("t-b", m[2])
    stack.admit("t-c", m[3])  # regular slots full: evicts t-a, not the canary
    assert stack.is_resident("canary-x") and not stack.is_resident("t-a")
    stack.admit("canary-y", m[4], canary=True)
    assert not stack.is_resident("canary-x") and stack.is_resident("canary-y")
    with pytest.raises(ValueError):
        _stack(capacity=2, canary_slots=2)


def test_stacked_admission_budget_enforced_before_dispatch(fleet_models):
    stack = _stack(capacity=2, buckets=(8,), row_budget=4)
    stack.admit("t-a", fleet_models[0])
    with pytest.raises(TenantNotResident):
        stack.predict("ghost", np.ones((2, 1), np.float32))
    before, replays = stack._obs()[1].value(), stack.stats()
    with pytest.raises(TenantOverBudget):
        stack.predict_multi({"t-a": np.ones((5, 1), np.float32)})
    assert stack._obs()[1].value() == before and stack.stats() == replays
    stack.predict("t-a", np.ones((4, 1), np.float32))


def test_stacked_same_arch_only(fleet_models):
    from bodywork_tpu_torch.models import LinearRegressor

    stack = _stack(capacity=2, buckets=(8,))
    stack.admit("t-a", fleet_models[0])
    X = np.linspace(0, 10, 8, dtype=np.float32)
    with pytest.raises(StackNotCompatible):
        stack.admit("t-lin", LinearRegressor().fit(X, 2 * X, device="cpu"))
    with pytest.raises(StackNotCompatible):
        stack.admit("t-wide", _train_mlps(1, hidden=(16,), n_steps=5)[0])


def test_stacked_rejects_unfitted_model():
    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor

    with pytest.raises(StackNotCompatible, match="unfitted"):
        _stack(capacity=2, buckets=(8,)).admit("t-a", MLPRegressor(MLPConfig(hidden=(8,))))


def test_residency_churn_never_builds(fleet_models):
    """Programs are built at the fixed ``[capacity, bucket, features]``
    shape over tensors written in place, so eviction, a never-seen
    tenant's admission and re-admission build nothing (on the card:
    capture nothing)."""
    stack = _stack(capacity=2, buckets=(8, 64))
    stack.admit("t-0", fleet_models[0])
    stack.admit("t-1", fleet_models[1])
    stack.warmup()
    before = stack.stats()
    assert before["builds"] == 2
    tensors = [t.data_ptr() for t in jax_free_leaves(stack._stacked)]
    X = np.ones((3, 1), np.float32)
    stack.predict_multi({"t-0": X, "t-1": X})
    stack.evict("t-1")
    stack.admit("t-2", fleet_models[2])  # never seen before
    stack.admit("t-3", fleet_models[3])  # evicts t-0
    stack.admit("t-0", fleet_models[0])  # re-admitted, evicts t-2
    stack.predict_multi({"t-3": X, "t-0": X * 2})
    stack.predict("t-3", np.ones((40, 1), np.float32))  # second bucket
    after = stack.stats()
    assert (after["builds"], after["captures"]) == (before["builds"], before["captures"])
    assert [t.data_ptr() for t in jax_free_leaves(stack._stacked)] == tensors
    assert DEFAULT_STACK_BUCKETS == jax_stacked.DEFAULT_STACK_BUCKETS == (8, 64, 512)


def jax_free_leaves(tree):
    from bodywork_tpu_torch.serve.predictor import _leaves

    return list(_leaves(tree))


def test_a_free_slot_is_zero_filled(fleet_models):
    stack = _stack(capacity=2, buckets=(8,))
    slot = stack.admit("t-a", fleet_models[0])
    stack.evict("t-a")
    assert all(float(t[slot].abs().sum()) == 0.0 for t in jax_free_leaves(stack._stacked))


def test_stacked_nan_sabotage_is_isolated(fleet_models):
    from bodywork_tpu_torch.models.mlp import MLPRegressor
    from bodywork_tpu_torch.serve.predictor import _tree_map

    stack = _stack(capacity=3, buckets=(8,))
    tenants = ["t-a", "t-b", "t-c"]
    for tid, model in zip(tenants, fleet_models):
        stack.admit(tid, model)
    X = np.linspace(0, 100, 6, dtype=np.float32)[:, None]
    healthy = {t: np.asarray(stack.predict(t, X)).copy() for t in tenants}
    assert all(np.all(np.isfinite(v)) for v in healthy.values())
    poisoned = _tree_map(lambda t: torch.full_like(t, float("nan")), fleet_models[1].params)
    stack.admit("t-b", MLPRegressor(fleet_models[1].config, poisoned))
    out = stack.predict_multi({t: X for t in tenants})
    assert np.all(np.isnan(np.asarray(out["t-b"])))
    np.testing.assert_array_equal(np.asarray(out["t-a"]), healthy["t-a"])
    np.testing.assert_array_equal(np.asarray(out["t-c"]), healthy["t-c"])


def test_the_stack_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StackedMLPPredictor(capacity=2)


# --- prefix-bounded listings -------------------------------------------------


def test_tenant_listing_is_prefix_bounded(tmp_path):
    backend = CountingStore(FilesystemStore(tmp_path))
    a, b = scoped_store(backend, "acme"), scoped_store(backend, "bravo")
    for i in range(3):
        a.put_bytes(f"{REGISTRY_RECORDS_PREFIX}2026-01-0{i + 1}.json", b"{}")
    for i in range(7):
        b.put_bytes(f"{REGISTRY_RECORDS_PREFIX}2026-01-0{i + 1}.json", b"{}")
    backend.reset_counts()
    assert len(a.history(REGISTRY_RECORDS_PREFIX)) == 3
    assert backend.ops == {"list_keys": 1}
    assert backend.by_key == {("list_keys", f"tenants/acme/{REGISTRY_RECORDS_PREFIX}"): 1}


def test_fsck_scrubs_tenant_subtrees(tmp_path):
    from bodywork_tpu_torch.audit.fsck import run_fsck

    backend = FilesystemStore(tmp_path / "s")
    acme = scoped_store(backend, "acme")
    acme.put_bytes("models/regressor-2026-01-01.joblib", b"truncated")
    report = run_fsck(backend)
    rebased = [f for f in report["findings"] if f["key"].startswith("tenants/acme/models/")]
    assert rebased, report["findings"]
    assert all(f["prefix"] == TENANTS_PREFIX for f in rebased)
    assert all("[tenant acme]" in f["detail"] for f in rebased)
    assert any(f["key"] == "models/regressor-2026-01-01.joblib"
               for f in run_fsck(acme)["findings"])


# --- the cli, the journal and the day report ---------------------------------


def test_cli_store_scopes_by_flag_and_env(tmp_path, monkeypatch):
    from bodywork_tpu_torch.cli import _store

    args = SimpleNamespace(store=str(tmp_path / "s"), tenant="acme")
    view = _store(args)
    assert isinstance(view, TenantStore) and view.tenant_id == "acme"
    monkeypatch.setenv(TENANT_ENV, "bravo")
    assert _store(args).tenant_id == "acme"  # the flag wins
    args.tenant = None
    assert _store(args).tenant_id == "bravo"
    monkeypatch.delenv(TENANT_ENV)
    assert not isinstance(_store(args), TenantStore)


def test_open_scoped_store_reads_the_env_and_degrades_a_malformed_one(tmp_path, monkeypatch):
    from bodywork_tpu_torch.store import open_scoped_store

    monkeypatch.setenv(TENANT_ENV, "acme")
    assert tenant_of(open_scoped_store(str(tmp_path))) == "acme"
    monkeypatch.setenv(TENANT_ENV, "Bad_Id")
    assert tenant_of(open_scoped_store(str(tmp_path))) == DEFAULT_TENANT


@pytest.mark.parametrize("tenant", [None, "acme"])
def test_the_journal_carries_tenant_as_jaxs_does(tmp_path, tenant):
    """A tenant's journal records ``tenant``; the root's omits the field,
    so its documents are byte-identical to pre-tenancy ones. The port's
    document equals the JAX journal's for the same day and scope, outside
    the lease's owner and expiry."""
    from bodywork_tpu.pipeline.journal import RunJournal as JaxJournal
    from bodywork_tpu_torch.pipeline.journal import RunJournal

    docs = {}
    for name, journal_cls, store_cls, scope in (
            ("port", RunJournal, FilesystemStore, scoped_store),
            ("jax", JaxJournal, JaxStore, jax_tenancy.scoped_store)):
        store = store_cls(tmp_path / name)
        if tenant is not None:
            store = scope(store, tenant)
        journal = journal_cls(store, date(2026, 3, 2))
        journal.acquire()
        key = journal.key
        doc = json.loads(store.get_bytes(key))
        doc.pop("lease")
        doc.pop("doc_digest", None)
        docs[name] = doc
    assert docs["port"] == docs["jax"]
    assert docs["port"].get("tenant") == tenant


@pytest.mark.parametrize("tenant", [None, "default", "acme"])
def test_the_day_report_carries_tenant_as_jaxs_does(tenant):
    from bodywork_tpu.obs.spans import day_report as jax_day_report
    from bodywork_tpu_torch.obs.spans import day_report

    result = SimpleNamespace(day=date(2026, 3, 2), wall_clock_s=1.25,
                             stage_seconds={"stage-1-train-model": 0.5}, spans=[])
    port, jax = day_report(result, tenant=tenant), jax_day_report(result, tenant=tenant)
    assert port == jax
    assert ("tenant" in port) == (tenant == "acme")


def test_a_tenants_run_sim_writes_the_jax_packages_keys(tmp_path):
    """``run-sim --tenant acme`` of each package: the same keys, all under
    ``tenants/acme/``, the journals carrying ``tenant``, and the root
    untouched."""
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    flags = ["--days", "2", "--date", "2026-03-02", "--tenant", "acme"]
    assert main(["run-sim", "--store", str(tmp_path / "port"), *flags, "--device", "cpu"]) == 0
    assert jax_main(["run-sim", "--store", str(tmp_path / "jax"), *flags]) == 0
    port_keys = FilesystemStore(tmp_path / "port").list_keys()
    assert port_keys == JaxStore(tmp_path / "jax").list_keys()
    assert port_keys and all(k.startswith("tenants/acme/") for k in port_keys)
    journals = [k for k in port_keys if k.endswith("journal.json")]
    assert journals
    for key in journals:
        assert json.loads(FilesystemStore(tmp_path / "port").get_bytes(key))["tenant"] == "acme"
