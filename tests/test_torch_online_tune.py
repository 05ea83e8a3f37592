"""The port's online control plane against the JAX package's: the learned
dispatch-cost model (``tune.costmodel``: byte-equal weights and held-out
report for the same samples and seed, equal prices), the config lifecycle
log (``registry.configlog``: one CAS an apply and a revert, a conflict
raised and never retried, corruption raised, the same bounded history and
bytes), the online re-tune controller (``tune.online``: the same decision
sequence over one scripted run of windows), ``cli tune status``, the
admission layer's cost-priced shed, ``/healthz`` ``tuning``, and a
mid-flight apply that drops no request and builds nothing. Tolerance:
exact."""
import dataclasses
import json
import os
import threading
from datetime import date
from pathlib import Path

import pytest
import torch

from bodywork_tpu.registry import configlog as jax_configlog
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.store.base import DelegatingStore as JaxDelegating
from bodywork_tpu.tune import costmodel as jax_costmodel
from bodywork_tpu.tune import online as jax_online
from bodywork_tpu_torch.registry import configlog
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.base import CasConflict, DelegatingStore
from bodywork_tpu_torch.store.schema import CONFIG_LOG_KEY
from bodywork_tpu_torch.tune import costmodel, online

torch.set_num_threads(1)

_CURVE = {1: 4e-4, 2: 4.1e-4, 4: 4.3e-4, 8: 4.6e-4, 16: 5.2e-4, 32: 6.1e-4, 64: 7.8e-4,
          128: 1.1e-3, 256: 1.7e-3, 512: 2.9e-3}
DAY = date(2026, 3, 1)


def _counting(base):
    """A store that counts ``put_bytes_if_match`` per key at its boundary."""

    class Counting(base):
        def __init__(self, inner):
            super().__init__(inner)
            self.cas: dict = {}

        def put_bytes_if_match(self, key, data, expected_token=None):
            self.cas[key] = self.cas.get(key, 0) + 1
            return super().put_bytes_if_match(key, data, expected_token)

    return Counting


def _stores(tmp_path):
    return (_counting(DelegatingStore)(FilesystemStore(tmp_path / "port")),
            _counting(JaxDelegating)(JaxStore(tmp_path / "jax")))


# -- the learned cost model ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 18])
@pytest.mark.parametrize("n_features", [1, 16])
def test_cost_model_fits_byte_equal_to_jax(tmp_path, seed, n_features):
    samples = costmodel.samples_from_probe(_CURVE, n_features=n_features)
    jax_samples = jax_costmodel.samples_from_probe(_CURVE, n_features=n_features)
    assert [dataclasses.asdict(s) for s in samples] == [
        dataclasses.asdict(s) for s in jax_samples]
    doc = costmodel.fit_cost_model(samples, seed=seed)
    ref = jax_costmodel.fit_cost_model(jax_samples, seed=seed)
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert doc["holdout"]["mean_rel_err"] <= 0.5
    port, jax = FilesystemStore(tmp_path / "p"), JaxStore(tmp_path / "j")
    key, digest = costmodel.write_cost_model(port, doc, DAY)
    assert (key, digest) == jax_costmodel.write_cost_model(jax, ref, DAY)
    assert port.get_bytes(key) == jax.get_bytes(key)
    for ladder in ((1, 8, 64, 512), None):
        price = costmodel.cost_pricer(doc, n_features, buckets=ladder)
        jax_price = jax_costmodel.cost_pricer(ref, n_features, buckets=ladder)
        for rows in (0, 1, 2, 5, 64, 65, 700, 5000):
            assert price(rows) == jax_price(rows)
    for bucket in (1, 3, 1024, 65536):
        assert (costmodel.predict_cost(doc, bucket, n_features, "int8", 2)
                == jax_costmodel.predict_cost(ref, bucket, n_features, "int8", 2))


@pytest.mark.parametrize("sabotage", ["garbage", "digest", "weights", "absent", "none"])
def test_cost_model_loads_and_degrades_as_jax_does(tmp_path, sabotage):
    doc = costmodel.fit_cost_model(costmodel.samples_from_probe(_CURVE, 4))
    port, jax = FilesystemStore(tmp_path / "p"), JaxStore(tmp_path / "j")
    for store, pkg in ((port, costmodel), (jax, jax_costmodel)):
        key, _digest = pkg.write_cost_model(store, doc, DAY)
        if sabotage == "garbage":
            store.put_bytes(key, b"not json {")
        elif sabotage == "digest":
            tampered = json.loads(store.get_bytes(key))
            tampered["weights"][0] += 1.0
            store.put_bytes(key, json.dumps(tampered).encode())
        elif sabotage == "weights":
            store.put_bytes(key, json.dumps({**doc, "weights": doc["weights"][:3]}).encode())
        elif sabotage == "absent":
            key = "tuning/cost-model-absent.json"
    for ref in ("latest", key):
        assert costmodel.load_cost_model(port, ref) == jax_costmodel.load_cost_model(jax, ref)
    with pytest.raises(ValueError):
        costmodel.fit_cost_model(costmodel.samples_from_probe(_CURVE, 4)[:3])
    with pytest.raises(ValueError, match="not a cost-model document"):
        costmodel.write_cost_model(port, {"weights": []}, DAY)


# -- the config lifecycle log ----------------------------------------------------


def _knobs(window=1.5):
    return {"batch_window_ms": window, "batch_max_rows": 128}


def test_config_log_takes_one_cas_an_apply_and_a_revert_byte_equal_to_jax(tmp_path):
    port, jax = _stores(tmp_path)
    for store, pkg in ((port, configlog), (jax, jax_configlog)):
        assert pkg.read_config_log(store) is None
        pkg.record_config_applied(store, "tuning/a.json", "sha256:aa", _knobs(1.5),
                                  baseline={"requests": 10.0, "errors": 0.0}, reason="first")
        pkg.record_config_applied(store, "tuning/b.json", "sha256:bb", _knobs(3.0))
        restored, reverted = pkg.record_config_reverted(
            store, reason="p99 breach", flight_record="obs/flightrec/f.json")
        assert restored["knobs"] == _knobs(1.5) and reverted["digest"] == "sha256:bb"
        assert store.cas[CONFIG_LOG_KEY] == 3  # one an apply, one the revert
    assert port.get_bytes(CONFIG_LOG_KEY) == jax.get_bytes(CONFIG_LOG_KEY)
    final = configlog.read_config_log(port)
    assert final["previous"] is None and final["last_op"] == "reverted"
    assert final["history"][-1]["flight_record"] == "obs/flightrec/f.json"
    for store, pkg in ((port, configlog), (jax, jax_configlog)):
        pkg.record_config_reverted(store, reason="second")  # back to the defaults
        with pytest.raises(ValueError, match="no active config"):
            pkg.record_config_reverted(store, reason="nothing live")
    assert port.get_bytes(CONFIG_LOG_KEY) == jax.get_bytes(CONFIG_LOG_KEY)


def test_config_log_conflict_raises_after_one_cas_and_never_retries(tmp_path):
    port, _jax = _stores(tmp_path)

    def lose(key, data, expected_token=None):
        port.cas[key] = port.cas.get(key, 0) + 1
        raise CasConflict(f"{key}: concurrent writer")

    port.put_bytes_if_match = lose
    with pytest.raises(configlog.ConfigLogConflict):
        configlog.record_config_applied(port, "tuning/a.json", "sha256:aa", _knobs())
    assert port.cas[CONFIG_LOG_KEY] == 1


def test_a_corrupt_config_log_raises_and_never_reads_as_absent(tmp_path):
    port, jax = _stores(tmp_path)
    for store, pkg in ((port, configlog), (jax, jax_configlog)):
        pkg.record_config_applied(store, "tuning/a.json", "sha256:aa", _knobs())
        raw = json.loads(store.get_bytes(CONFIG_LOG_KEY))
        raw["active"]["digest"] = "sha256:tampered"
        store.put_bytes(CONFIG_LOG_KEY, json.dumps(raw).encode())
        with pytest.raises(pkg.ConfigLogCorrupt):
            pkg.read_config_log(store)
        store.put_bytes(CONFIG_LOG_KEY, b"}{ not json")
        with pytest.raises(pkg.ConfigLogCorrupt):
            pkg.read_config_log(store)


def test_config_log_history_is_bounded_as_in_jax(tmp_path):
    port, jax = _stores(tmp_path)
    assert configlog.MAX_HISTORY == jax_configlog.MAX_HISTORY
    for store, pkg in ((port, configlog), (jax, jax_configlog)):
        for i in range(pkg.MAX_HISTORY + 7):
            pkg.record_config_applied(store, f"tuning/c{i}.json", f"sha256:{i:02d}", _knobs())
    doc = configlog.read_config_log(port)
    assert len(doc["history"]) == configlog.MAX_HISTORY
    assert doc["rev"] == configlog.MAX_HISTORY + 7
    assert port.get_bytes(CONFIG_LOG_KEY) == jax.get_bytes(CONFIG_LOG_KEY)


# -- the controller --------------------------------------------------------------


class _StubBatcher:
    def __init__(self, window_ms=2.0, max_rows=64):
        self.window_s = window_ms / 1000.0
        self.max_rows = max_rows

    def reconfigure(self, window_ms=None, max_rows=None):
        applied = {}
        if window_ms is not None:
            self.window_s = window_ms / 1000.0
            applied["window_ms"] = window_ms
        if max_rows is not None:
            self.max_rows = int(max_rows)
            applied["max_rows"] = int(max_rows)
        return applied


class _StubAdmission:
    def __init__(self, max_pending=512):
        self.max_pending = max_pending


class _FakeApp:
    """The app surface the controller touches, with live-mutable stubs."""

    def __init__(self):
        self.batcher = _StubBatcher()
        self.admission = _StubAdmission()
        self.buckets = (1, 8, 64, 512)
        self.model_date = "2026-01-01"
        self.model_key = "models/regressor-2026-01-01.npz"
        self.tune_state = {}
        self.tuned_config_digest = None

    def effective_config(self):
        return {"batch_window_ms": round(self.batcher.window_s * 1e3, 3),
                "batch_max_rows": self.batcher.max_rows, "buckets": list(self.buckets),
                "max_pending": self.admission.max_pending}


def _guard_traffic(pkg: str, n_ok=0, n_err=0, latency_s=0.004):
    if pkg == "port":
        from bodywork_tpu_torch.obs import get_registry
        from bodywork_tpu_torch.ops import slo
    else:
        from bodywork_tpu.obs import get_registry
        from bodywork_tpu.ops import slo
    reg = get_registry()
    for _ in range(n_ok):
        reg.counter(slo.SERVICE_REQUESTS_METRIC, "").inc(route="/score/v1", status="200")
        reg.histogram(slo.SERVICE_LATENCY_METRIC, "").observe(latency_s)
    for _ in range(n_err):
        reg.counter(slo.SERVICE_REQUESTS_METRIC, "").inc(route="/score/v1", status="500")


def _append(path: Path, t0, rate, n, rows=1):
    lines = [] if path.exists() else [json.dumps({
        "schema": "bodywork_tpu.request_log/1", "config": {}, "n_requests": n})]
    lines += [json.dumps({"t_s": round(t0 + i / rate, 9), "route": "/score/v1", "rows": rows,
                          "x": [1.0] * rows}) for i in range(n)]
    with path.open("a") as f:
        f.write("\n".join(lines) + "\n")
    return t0 + n / rate


def _controllers(tmp_path):
    out = {}
    for name, pkg, store in (("port", online, _stores(tmp_path)[0]),
                             ("jax", jax_online, _stores(tmp_path)[1])):
        policy = pkg.OnlineTunePolicy(
            min_window_requests=20, drift_threshold=0.5, window_polls=10, cooldown_polls=1,
            verdict_polls=3, min_verdict_requests=5, revert_error_rate=0.1,
            revert_p99_ratio=2.0, revert_min_latency_samples=5)
        app = _FakeApp()
        (tmp_path / name).mkdir(exist_ok=True)
        watch = tmp_path / name / "watch.jsonl"  # one name: the sources list it
        controller = pkg.OnlineTuneController(
            store, app, policy=policy, request_logs=(watch,), cost_model_ref=None,
            apply_buckets=lambda b, app=app: setattr(app, "buckets", tuple(b)))
        out[name] = (controller, app, store, watch)
    return out


def test_the_controller_makes_jaxs_decisions_over_one_scripted_run(tmp_path, monkeypatch):
    """Pin, idle, drift -> refit -> apply, guard -> graduate, cooldown,
    drift -> apply -> error-budget revert (one CAS): the same actions,
    states, config-log bytes and live knobs in both packages. Each
    package gets a registry of its own, so the baselines' cumulative
    counts start from the same zero whatever ran before in the process,
    and a tracer of its own, so the revert's flight record (whose key
    carries the digest of the recorder's traces) holds no trace that an
    earlier test's served request left in the process tracer."""
    from bodywork_tpu.obs import registry as jax_registry
    from bodywork_tpu.obs import tracing as jax_tracing
    from bodywork_tpu_torch.obs import registry, tracing

    monkeypatch.setattr(registry, "_DEFAULT", registry.Registry())
    monkeypatch.setattr(jax_registry, "_DEFAULT", jax_registry.Registry())
    monkeypatch.setattr(tracing, "_TRACER", tracing.Tracer())
    monkeypatch.setattr(jax_tracing, "_TRACER", jax_tracing.Tracer())
    runs = _controllers(tmp_path)
    t = {name: 0.0 for name in runs}
    steps = ([("append", 50.0, 60, 0, 0)] + [("append", 50.0, 30, 0, 0)]
             + [("append", 300.0, 60, 0, 0)] * 3 + [("traffic", 0, 0, 10, 0)] * 3
             + [("append", 300.0, 60, 0, 0)] * 2 + [("append", 20.0, 60, 0, 0)] * 4
             + [("traffic", 0, 0, 10, 10)] * 2)
    seen = {name: [] for name in runs}
    for kind, rate, n, n_ok, n_err in steps:
        for name, (controller, app, store, watch) in runs.items():
            if kind == "append":
                t[name] = _append(watch, t[name], rate, n)
            else:
                _guard_traffic(name, n_ok=n_ok, n_err=n_err)
            action = controller.poll()
            state = {k: v for k, v in app.tune_state.items() if k not in ("detail",)}
            seen[name].append((action, state, app.effective_config(),
                               app.tuned_config_digest))
    assert seen["port"] == seen["jax"]
    actions = [a for a, *_ in seen["port"]]
    assert actions.count("applied") >= 2 and "graduated" in actions and "reverted" in actions
    port_store, jax_store = runs["port"][2], runs["jax"][2]
    assert port_store.get_bytes(CONFIG_LOG_KEY) == jax_store.get_bytes(CONFIG_LOG_KEY)
    assert port_store.cas == jax_store.cas


def test_the_controller_outlives_missing_and_foreign_watch_files(tmp_path):
    runs = _controllers(tmp_path)
    for name, (controller, app, _store, watch) in runs.items():
        assert controller.poll() is None
        watch.write_text("utter garbage\nnot json\n")
        assert controller.poll() is None
        assert app.tune_state["state"] == "idle"
    assert runs["port"][1].tune_state == runs["jax"][1].tune_state


def test_policy_from_env_degrades_per_field_as_jax_does(monkeypatch):
    env = {"BODYWORK_TPU_TUNE_DRIFT_THRESHOLD": "0.75", "BODYWORK_TPU_TUNE_VERDICT_POLLS": "12",
           "BODYWORK_TPU_TUNE_REVERT_ERROR_RATE": "bogus",
           "BODYWORK_TPU_TUNE_REVERT_P99_RATIO": "-3",
           "BODYWORK_TPU_TUNE_MIN_WINDOW_REQUESTS": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(online.policy_from_env()) == dataclasses.asdict(
        jax_online.policy_from_env())
    assert online.policy_from_env().drift_threshold == 0.75
    assert online.MUTABLE_LIVE_KNOBS == jax_online.MUTABLE_LIVE_KNOBS


def test_the_online_controller_reads_no_clock_and_draws_no_randomness():
    source = Path(online.__file__).read_text()
    for forbidden in ("import time", "time.time(", "time.sleep(", "perf_counter",
                      "monotonic(", "datetime.now", "date.today", "utcnow", "import random",
                      "default_rng"):
        assert forbidden not in source, forbidden


# -- cli tune status -------------------------------------------------------------


def _status(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("scene", ["applied", "nothing", "document-only", "env-override"])
def test_tune_status_prints_the_jax_commands_document(tmp_path, capsys, monkeypatch, scene):
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu.tune.config import write_tuned_config as jax_write
    from bodywork_tpu_torch.cli import main
    from bodywork_tpu_torch.tune.config import write_tuned_config

    outs = {}
    for name, fn, write, pkg, store_cls in (
            ("port", main, write_tuned_config, configlog, FilesystemStore),
            ("jax", jax_main, jax_write, jax_configlog, JaxStore)):
        root = tmp_path / name
        store = store_cls(root)
        if scene != "nothing":
            key, digest = write(store, {"knobs": {"batch_window_ms": 1.25}, "decisions": [],
                                        "observations": {"sources": ["test"]}},
                                day=date(2026, 4, 1))
        if scene in ("applied", "env-override"):
            pkg.record_config_applied(store, key, digest, {"batch_window_ms": 1.25},
                                      reason="test")
        if scene == "env-override":
            monkeypatch.setenv("BODYWORK_TPU_MAX_PENDING", "900")
        outs[name] = _status(fn, ["tune", "status", "--store", str(root)], capsys)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0


def test_tune_status_exits_1_on_a_corrupt_ledger_or_document(tmp_path):
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    for name, fn, store_cls in (("port", main, FilesystemStore), ("jax", jax_main, JaxStore)):
        root = tmp_path / name
        store_cls(root).put_bytes(CONFIG_LOG_KEY, b"}{ corrupt")
        assert fn(["tune", "status", "--store", str(root)]) == 1
        store_cls(root).delete(CONFIG_LOG_KEY)
        store_cls(root).put_bytes("tuning/tuned-config-2026-04-01.json", b"{rot")
        assert fn(["tune", "status", "--store", str(root)]) == 1


# -- the cost-priced shed ------------------------------------------------------------


def test_the_cost_priced_shed_admits_and_sheds_as_jaxs():
    from bodywork_tpu.serve.admission import AdmissionController as JaxAdmission
    from bodywork_tpu_torch.serve.admission import AdmissionController

    doc = costmodel.fit_cost_model(costmodel.samples_from_probe(_CURVE, 1))
    states = {}
    for name, cls, pkg in (("port", AdmissionController, costmodel),
                           ("jax", JaxAdmission, jax_costmodel)):
        adm = cls(max_pending=8)
        assert adm.state()["cost_shed"] is None
        with pytest.raises(ValueError):
            adm.configure_cost_shed(lambda rows: 1.0, 0.0)
        adm.configure_cost_shed(pkg.cost_pricer(doc, 1, buckets=(1, 8, 64, 512)), 0.004)
        trail = []
        for rows in (1, 512, 512, 1, 64, 700, 1, 1):
            trail.append(adm.try_admit(rows))
        adm.release(0.01)
        trail.append(adm.try_admit(1))
        for _ in range(9):
            adm.release(0.002)
        trail.append(adm.state())
        # a broken pricer never breaks admission
        adm.configure_cost_shed(lambda rows: 1 / 0, 1.0)
        trail.append(adm.try_admit(3))
        adm.configure_cost_shed(None, None)
        trail.append(adm.state())
        states[name] = trail
    assert states["port"] == states["jax"]
    assert False in states["port"][:8]


def test_the_cost_shed_counts_reason_cost_on_the_metric():
    from bodywork_tpu_torch.ops.slo import _sum_counter
    from bodywork_tpu_torch.serve.admission import AdmissionController

    before = _sum_counter("bodywork_tpu_serve_shed_total", reason="cost")
    adm = AdmissionController(max_pending=100)
    adm.configure_cost_shed(lambda rows: 1.0, 1.5)
    assert adm.try_admit() and not adm.try_admit()
    assert _sum_counter("bodywork_tpu_serve_shed_total", reason="cost") == before + 1
    from bodywork_tpu_torch.obs import get_registry

    gauge = get_registry().gauge("bodywork_tpu_serve_pending_cost_seconds")
    assert gauge.value() == 1.0
    adm.release(0.0)
    assert gauge.value() == 0.0


# -- the live service ----------------------------------------------------------------


def _mlp_store(tmp_path) -> str:
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.train import train_on_history

    root = str(tmp_path / "mlp-store")
    store = open_store(root)
    d = date(2026, 1, 1)
    X, y = generate_day(d, device="cpu")
    persist_dataset(store, Dataset(X, y, d))
    train_on_history(store, "mlp", model_kwargs={"hidden": (16, 16), "n_steps": 60},
                     device="cpu")
    return root


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def _post(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read()


def test_healthz_tuning_and_effective_config_equal_jaxs(tmp_path):
    """Both packages' services with ``online_tune`` over one store, the
    same config applied through ``apply_tuned``: ``/healthz`` ``tuning``
    and ``effective_config`` are equal (no time in either)."""
    from bodywork_tpu.serve import serve_latest_model as jax_serve
    from bodywork_tpu_torch.serve import serve_latest_model

    root = _mlp_store(tmp_path)
    knobs = {"batch_window_ms": 0.5, "batch_max_rows": 32, "buckets": [1, 8, 64],
             "max_pending": 700}
    docs = {}
    for name, serve, store in (
            ("port", lambda **k: serve_latest_model(root, device="cpu", **k), None),
            ("jax", lambda **k: jax_serve(JaxStore(root), **k), None)):
        handle = serve(host="127.0.0.1", port=0, block=False, server_engine="aio",
                       batch_window_ms=2.0, batch_max_rows=64, buckets=(1, 8, 64),
                       online_tune=True, watch_interval_s=3600)
        try:
            base = handle.url.rsplit("/score/v1", 1)[0]
            assert _get(base + "/healthz")["tuning"] is None
            controller = handle.app.tune_controller
            assert controller.apply_tuned(knobs, "tuning/live.json", "sha256:live",
                                          reason="test") == "applied"
            health = _get(base + "/healthz")
            docs[name] = (health["tuning"], health["effective_config"])
        finally:
            handle.stop()
    assert docs["port"] == docs["jax"]
    assert docs["port"][0]["state"] == "guarding"
    assert docs["port"][1]["tuned_config"] == "sha256:live"


def test_a_mid_flight_apply_drops_nothing_and_builds_nothing(tmp_path):
    """While three clients drive the service, an apply of new coalescer
    and admission knobs on the same ladder answers every request 200,
    builds no program (the graph cache's misses do not move) and leaves
    the response bytes identical; a ladder change keeps the served
    predictor's weights, owner and lane (no rebind)."""
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model

    root = _mlp_store(tmp_path)
    handle = serve_latest_model(root, host="127.0.0.1", port=0, block=False, device="cpu",
                                server_engine="aio", batch_window_ms=2.0, batch_max_rows=64,
                                buckets=(1, 8, 64), online_tune=True, watch_interval_s=3600)
    try:
        app, url = handle.app, handle.url
        controller = app.tune_controller
        payload = {"X": [50.0]}
        body_before = _post(url, payload)[1]
        misses = GRAPH_CACHE.stats()["misses"]
        statuses, lock = [], threading.Lock()

        def drive(n=40):
            for _ in range(n):
                status, _body = _post(url, payload)
                with lock:
                    statuses.append(status)

        threads = [threading.Thread(target=drive) for _ in range(3)]
        for t in threads:
            t.start()
        assert controller.apply_tuned(
            {"batch_window_ms": 0.5, "batch_max_rows": 32, "buckets": [1, 8, 64],
             "max_pending": 700}, "tuning/live.json", "sha256:live",
            reason="test_live_apply") == "applied"
        for t in threads:
            t.join()
        assert len(statuses) == 120 and set(statuses) == {200}
        effective = app.effective_config()
        assert (effective["batch_window_ms"], effective["batch_max_rows"],
                effective["max_pending"]) == (0.5, 32, 700)
        assert GRAPH_CACHE.stats()["misses"] == misses
        assert _post(url, payload)[1] == body_before
        # a new ladder: the served predictor's weights, owner and lane
        before = app.predictor
        stats = GRAPH_CACHE.stats()
        handle.watcher.apply_bucket_ladder((1, 8, 64, 256))
        after = app.predictor
        assert after is not before and after.model is before.model
        assert (after._token, after.slot_lane, after._slot) == (
            before._token, before.slot_lane, before._slot)
        assert after.buckets == (1, 8, 64, 256) and handle.watcher.buckets == after.buckets
        now = GRAPH_CACHE.stats()
        # the one new rung, looked up once at the warm-up (a miss, or a hit
        # where an earlier predictor of the architecture built it)
        assert (now["misses"] + now["hits"]) - (stats["misses"] + stats["hits"]) == 1
        assert now["rebinds"] == stats["rebinds"]
        assert app.model_key.startswith("models/")
        assert _post(url, payload)[1] == body_before
    finally:
        handle.stop()


def test_the_watcher_wires_the_controller_and_polls_it_after_the_watchdog(tmp_path):
    from bodywork_tpu_torch.serve import create_app
    from bodywork_tpu_torch.serve.reload import CheckpointWatcher
    from bodywork_tpu_torch.store import open_store

    root = _mlp_store(tmp_path)
    store = open_store(root)
    from bodywork_tpu_torch.models import load_model

    model, model_date = load_model(store, device="cpu")
    app = create_app(model, model_date)
    calls = []

    class Controller:
        apply_buckets = None

        def poll(self):
            calls.append("tuner")
            raise RuntimeError("a controller error never stops reloads")

    class Watchdog:
        def poll(self):
            calls.append("watchdog")

    controller = Controller()
    watcher = CheckpointWatcher(app, store, slo_watchdog=Watchdog(),
                                tune_controller=controller)
    assert controller.apply_buckets == watcher.apply_bucket_ladder
    assert watcher.check_once() is False
    assert calls == ["watchdog", "tuner"]
