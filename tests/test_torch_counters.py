"""The counter and gauge families of the port's non-serving layers against
the JAX package's: after the same operations in each package, on copies
of one store, the ``/metrics`` text of the runner's journal counters
(``runner_journal_corrupt_total``, ``runner_resumes_total``,
``runner_lease_events_total``), the snapshot's (``snapshot_loads_total``,
``snapshot_writes_total``, ``snapshot_rows``), the registry's
(promotions, rollbacks, rollback refusals, corrupt records), training's
(the ``train_*`` family, ``train_fallbacks_total``,
``train_trainstate_corrupt_total``), the tester's (the ``live_*`` family,
``scoring_client_retries_total``), the store's (``store_ops_total``,
``store_op_seconds``) and the tracer's (``trace_sampled_total``) are
equal. The operations: journalled days (one crashed and resumed, one a
no-op, one under a foreign lease, one over a corrupt journal), snapshot
loads that hit, go stale, meet corrupt snapshots and miss, a promotion
by the gate, a rollback and a refused one, corrupt registry records,
incremental fallbacks, a live test and a test against a service with no
model.

Tolerances, stated: samples whose value is a time (``*_seconds`` series:
histogram buckets and sums, the round-trip gauge) are masked, their
counts kept; the held-out and live quality gauges (``*_ratio``) are each
package's own float32 fit and answers, held at rtol 1e-4; every other
sample, every name, label set, HELP and TYPE line is compared exactly."""
import re
import shutil
import time
import types
from datetime import date, timedelta

import numpy as np
import pytest
import torch

import bodywork_tpu.chaos.kill as jax_kill
import bodywork_tpu.data as jax_data
import bodywork_tpu.models as jax_models
import bodywork_tpu.monitor as jax_monitor
import bodywork_tpu.obs.registry as jax_registry
import bodywork_tpu.obs.tracing as jax_tracing
import bodywork_tpu.pipeline as jax_pipeline
import bodywork_tpu.pipeline.journal as jax_journal
import bodywork_tpu.registry as jax_reg
import bodywork_tpu.serve as jax_serve
import bodywork_tpu.store as jax_store
import bodywork_tpu.store.epoch as jax_epoch
import bodywork_tpu.store.schema as jax_schema
import bodywork_tpu.train as jax_train
import bodywork_tpu_torch.chaos.kill as kill
import bodywork_tpu_torch.data as data
import bodywork_tpu_torch.models as models
import bodywork_tpu_torch.monitor as monitor
import bodywork_tpu_torch.obs.registry as registry
import bodywork_tpu_torch.obs.tracing as tracing
import bodywork_tpu_torch.pipeline as pipeline
import bodywork_tpu_torch.pipeline.journal as journal
import bodywork_tpu_torch.registry as reg
import bodywork_tpu_torch.serve as serve
import bodywork_tpu_torch.store as store_mod
import bodywork_tpu_torch.store.epoch as epoch
import bodywork_tpu_torch.store.schema as schema
import bodywork_tpu_torch.train as train
from bodywork_tpu.data.drift_config import DriftConfig as JaxDrift
from bodywork_tpu_torch.data.drift_config import DriftConfig

torch.set_num_threads(1)

START = date(2026, 8, 1)
N_SAMPLES = 60

PORT = types.SimpleNamespace(
    kill=kill, data=data, models=models, monitor=monitor, registry=registry,
    tracing=tracing, pipeline=pipeline, journal=journal, reg=reg, serve=serve,
    store=store_mod, schema=schema, train=train, epoch=epoch, drift=DriftConfig(n_samples=N_SAMPLES),
    cpu={"device": "cpu"})
JAX = types.SimpleNamespace(
    kill=jax_kill, data=jax_data, models=jax_models, monitor=jax_monitor,
    registry=jax_registry, tracing=jax_tracing, pipeline=jax_pipeline, journal=jax_journal,
    reg=jax_reg, serve=jax_serve, store=jax_store, schema=jax_schema, train=jax_train,
    epoch=jax_epoch,
    drift=JaxDrift(n_samples=N_SAMPLES), cpu={})

FAMILIES = (
    "runner_journal_corrupt_total", "runner_resumes_total", "runner_lease_events_total",
    "snapshot_loads_total", "snapshot_writes_total", "snapshot_rows",
    "registry_promotions_total", "registry_rollbacks_total",
    "registry_rollback_refusals_total", "registry_corrupt_records_total",
    "train_runs_total", "train_rows_touched_total", "train_fit_seconds", "train_rows",
    "train_mape_ratio", "train_r2_ratio", "train_final_loss", "train_step_seconds",
    "train_fallbacks_total", "train_trainstate_corrupt_total",
    "live_test_runs_total", "live_test_rows_total", "live_test_failures_total",
    "live_mape_ratio", "live_score_label_corr_ratio", "live_response_mean_seconds",
    "scoring_client_retries_total",
)
_SAMPLE = re.compile(r"^(bodywork_tpu_[a-z0-9_]+)(\{[^}]*\})? (\S+)$")


@pytest.fixture
def fresh_registries(monkeypatch):
    """Each package's process registry replaced by an empty one for the
    test (the families register lazily, at their first operation)."""
    monkeypatch.setattr(registry, "_DEFAULT", registry.Registry())
    monkeypatch.setattr(jax_registry, "_DEFAULT", jax_registry.Registry())
    # the tracer caches its counter on first use: let it register anew
    monkeypatch.setattr(tracing.get_tracer(), "_m_sampled", None)
    monkeypatch.setattr(jax_tracing.get_tracer(), "_m_sampled", None)
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    yield
    kill.uninstall()
    jax_kill.uninstall()


def _family_lines(text: str, families) -> dict:
    """``{family: [line, ...]}`` of the exposition text, samples as
    ``(name, labels, value)`` and the HELP/TYPE lines as themselves."""
    out: dict = {}
    for line in text.splitlines():
        for family in families:
            full = f"bodywork_tpu_{family}"
            if line.startswith(("# HELP " + full + " ", "# TYPE " + full + " ")):
                out.setdefault(family, []).append(line)
                break
            m = _SAMPLE.match(line)
            if m and re.fullmatch(re.escape(full) + r"(_bucket|_sum|_count)?", m.group(1)):
                out.setdefault(family, []).append((m.group(1), m.group(2) or "", m.group(3)))
                break
    return out


def _assert_families_equal(got_text: str, want_text: str, families) -> None:
    got, want = _family_lines(got_text, families), _family_lines(want_text, families)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for family in want:
        assert len(got[family]) == len(want[family]), family
        for g, w in zip(got[family], want[family]):
            if isinstance(w, str):
                assert g == w
                continue
            assert g[:2] == w[:2], (g, w)
            name = w[0]
            if name.endswith("_seconds") or (name.endswith(("_bucket", "_sum"))
                                             and "_seconds" in name):
                continue  # a time: masked (its count is compared)
            if name.endswith("_ratio"):
                assert float(g[2]) == pytest.approx(float(w[2]), rel=1e-4), (g, w)
            else:
                assert g[2] == w[2], (g, w)


def _run_days(pkg, root) -> None:
    """Journalled days: a fresh one, its no-op rerun, a day crashed after
    train and resumed, a day under a live foreign lease, a day over a
    corrupt journal."""
    def runner():
        return pkg.pipeline.LocalRunner(pkg.pipeline.default_pipeline(),
                                        pkg.store.FilesystemStore(root), drift=pkg.drift,
                                        **pkg.cpu)

    def run(day):
        r = runner()
        try:
            return r.run_day(day)
        finally:
            r._drain_compactor()  # the compactor's writes land before the next op

    days = [START + timedelta(days=i) for i in range(4)]
    run(days[0])
    assert run(days[0]).noop
    pkg.kill.install(pkg.kill.KillSwitch([{"kind": "stage_boundary", "n": 1}],
                                         action="raise"))
    with pytest.raises(pkg.kill.SimulatedCrash):
        runner().run_day(days[1])
    pkg.kill.uninstall()
    time.sleep(0.1)  # the dead runner's lease expires
    assert run(days[1]).skipped_stages
    store = pkg.store.FilesystemStore(root)
    pkg.journal.RunJournal(store, days[2], owner="foreign:1:live", lease_ttl_s=900).acquire()
    with pytest.raises(pkg.journal.LeaseLost):
        run(days[2])
    store.put_bytes(pkg.schema.run_journal_key(days[3]), b"{torn mid-write")
    assert not run(days[3]).skipped_stages


def _snapshot_loads(pkg, root) -> None:
    """A load the snapshot covers, one it covers stale, two corrupt
    snapshots, and one with none kept."""
    pkg.data.load_all_datasets(pkg.store.FilesystemStore(root))  # hit
    store = pkg.store.FilesystemStore(root)
    last = store.history(pkg.schema.DATASETS_PREFIX)[-1][1]
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 100, 30).astype(np.float32)
    pkg.data.persist_dataset(store, pkg.data.Dataset(X, 0.5 * X + 2, last + timedelta(days=1)))
    pkg.data.load_all_datasets(pkg.store.FilesystemStore(root))  # stale
    for key in store.list_keys(pkg.schema.SNAPSHOTS_PREFIX):
        store.put_bytes(key, b"not an npz")
    pkg.data.load_all_datasets(pkg.store.FilesystemStore(root))  # corrupt, corrupt
    for key in store.list_keys(pkg.schema.SNAPSHOTS_PREFIX):
        store.delete(key)
    pkg.data.load_all_datasets(pkg.store.FilesystemStore(root))  # miss


def _registry_ops(pkg, root) -> None:
    """A rollback, a refused one (its target's checkpoint gone), and a
    corrupt record read past the retry budget."""
    store = pkg.store.FilesystemStore(root)
    registry_ = pkg.reg.ModelRegistry(store)
    doc = registry_.rollback(day=START)
    store.delete(doc["previous"])
    with pytest.raises(pkg.reg.RollbackBlocked):
        registry_.rollback(day=START)
    key = sorted(store.list_keys(pkg.schema.REGISTRY_RECORDS_PREFIX))[0]
    store.put_bytes(key, b"{not json")
    registry_.records()


def _incremental(pkg, root) -> None:
    """Incremental linear retrains: the trainstate absent, then corrupt."""
    store = pkg.store.FilesystemStore(root)
    pkg.train.train_on_history(store, "linear", mode="incremental", persist=False, **pkg.cpu)
    store.put_bytes(pkg.schema.trainstate_key("linear"), b"{torn")
    pkg.train.train_on_history(store, "linear", mode="incremental", persist=False, **pkg.cpu)


def _live_tests(pkg, root) -> None:
    """A live test of the production model, and one against a service with
    no model (every request retried, then failed)."""
    store = pkg.store.FilesystemStore(root)
    model, model_date = pkg.models.load_model(store, **pkg.cpu)
    app = pkg.serve.create_app(model, model_date, warmup=False)
    pkg.monitor.run_service_test(store, pkg.monitor.InProcessScoringClient(app),
                                 mode="batch", max_rows=50)
    pkg.monitor.run_service_test(store, pkg.monitor.InProcessScoringClient(
        pkg.serve.create_app(None)), mode="single", max_rows=2)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = tmp_path_factory.mktemp("seed")
    jax_pipeline.LocalRunner(jax_pipeline.default_pipeline(), jax_store.FilesystemStore(root),
                             drift=JaxDrift(n_samples=N_SAMPLES)).bootstrap(START)
    return root


def test_the_non_serving_families_are_jaxs(seeded, tmp_path, fresh_registries):
    texts = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        root = shutil.copytree(seeded, tmp_path / name)
        _run_days(pkg, root)
        _snapshot_loads(pkg, root)
        _registry_ops(pkg, root)
        _incremental(pkg, root)
        _live_tests(pkg, root)
        texts[name] = pkg.registry.get_registry().render()
    _assert_families_equal(texts["port"], texts["jax"], FAMILIES)
    got = _family_lines(texts["port"], FAMILIES)
    for family, want in (
            ("runner_resumes_total", {'{outcome="fresh"}': "2", '{outcome="noop"}': "1",
                                      '{outcome="resumed"}': "1",
                                      '{outcome="rerun_corrupt"}': "1"}),
            ("runner_lease_events_total", {'{event="acquired"}': "5", '{event="lost"}': "1",
                                           '{event="takeover"}': "1"}),
            # the days' train stages add two misses (no snapshot yet) and two hits
            ("snapshot_loads_total", {'{outcome="corrupt"}': "2", '{outcome="hit"}': "3",
                                      '{outcome="miss"}': "3", '{outcome="stale"}': "1"}),
            ("train_fallbacks_total", {'{reason="trainstate_absent"}': "1",
                                       '{reason="trainstate_corrupt"}': "1"}),
            ("registry_rollback_refusals_total", {'{reason="checkpoint_missing"}': "1"}),
            ("scoring_client_retries_total", {'{reason="status"}': "6"})):
        samples = {labels: value for (_n, labels, value) in
                   (x for x in got[family] if not isinstance(x, str))}
        assert samples == want, (family, samples)


def test_store_ops_are_counted_once_at_the_backend_as_in_jax(tmp_path, fresh_registries):
    texts = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        backend = pkg.store.FilesystemStore(tmp_path / name)
        wrapped = pkg.epoch.EpochGuardedStore(backend)  # a wrapper adds no count
        for store in (backend, wrapped):
            store.put_bytes("datasets/regression-dataset-2026-08-01.csv", b"a,b\n1,2\n")
            token = store.version_token("datasets/regression-dataset-2026-08-01.csv")
            store.put_bytes_if_match("runs/2026-08-01/journal.json", b"{}", None)
            store.get_bytes("datasets/regression-dataset-2026-08-01.csv")
            store.get_many(["datasets/regression-dataset-2026-08-01.csv"])
            store.version_tokens(["datasets/regression-dataset-2026-08-01.csv"])
            store.exists("nope")
            store.list_keys("datasets/")
            store.delete("runs/2026-08-01/journal.json")
            assert token is not None
        texts[name] = pkg.registry.get_registry().render()
    _assert_families_equal(texts["port"], texts["jax"], ("store_ops_total", "store_op_seconds"))
    assert 'bodywork_tpu_store_ops_total{backend="filesystem",op="get_bytes"} 4' in texts["port"]


def test_sampled_requests_count_by_route_as_in_jax(fresh_registries):
    rng = np.random.default_rng(6)
    X = rng.uniform(0, 100, 200).astype(np.float32)
    jax_model = jax_models.LinearRegressor().fit(X, 3 * X)
    model = models.LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                           for k, v in jax_model.params.items()})
    bodies = [f'{{"X": {i}}}'.encode() for i in range(20)] + [b'{"X": [1, 2]}']
    with tracing.configured_tracing(0.5, seed=3):
        app = serve.create_app(model, START, warmup=False)
        for body in bodies:
            path = "/score/v1/batch" if b"[" in body else "/score/v1"
            app.handle("POST", path, body, "application/json")
    with jax_tracing.configured_tracing(0.5, seed=3):
        client = jax_serve.create_app(jax_model, START, warmup=False).test_client()
        for body in bodies:
            path = "/score/v1/batch" if b"[" in body else "/score/v1"
            client.post(path, data=body, headers={"Content-Type": "application/json"})
    _assert_families_equal(registry.get_registry().render(),
                           jax_registry.get_registry().render(), ("trace_sampled_total",))
    assert "bodywork_tpu_trace_sampled_total" in registry.get_registry().render()
