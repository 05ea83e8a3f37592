"""The port's tuned-config layer, trace collector and tuner
(``bodywork_tpu_torch.tune.config``, ``collect``, ``model``) and ``cli
tune`` against the JAX package's: the same seeded traces ingest to the
same observation tables, the same tables fit byte-equal tuned documents
(config 13's three profiles, the date fixed), the resolver gives the same
knobs over the precedence and malformed matrix, fsck's ``tuning/``
validity matches the serving loader, and the served app reports the
tuned knobs and digest on ``/healthz`` as the JAX app does. Tolerance:
exact (the probe's seconds are the card's and are not compared)."""
import dataclasses
import json
import os
from datetime import date
from unittest.mock import patch

import numpy as np
import pytest
import torch

from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.tune import collect as jax_collect
from bodywork_tpu.tune import config as jax_config
from bodywork_tpu.tune import model as jax_model
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.tune import collect, config, model

torch.set_num_threads(1)

DAY = date(2026, 8, 1)
#: a synthetic measured curve: the probe's seconds are not compared
_CURVE = {1: 0.0004, 8: 0.00045, 64: 0.0006, 256: 0.0009, 512: 0.0015, 1024: 0.0027,
          4096: 0.009}


def _stores(tmp_path):
    return FilesystemStore(tmp_path / "port"), JaxStore(tmp_path / "jax")


def _profile_log(profile: str, duration_s: float = 3.0):
    """Config 13's seeded traffic profiles (``bench.py:3064-3100``)."""
    from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log

    if profile == "uniform_row":
        cfg = TrafficConfig(rate_rps=150.0, duration_s=duration_s, seed=131)
        return cfg, generate_request_log(cfg)
    if profile == "heavy_tail_row":
        cfg = TrafficConfig(rate_rps=30.0, duration_s=duration_s, seed=132)
        batches = generate_request_log(TrafficConfig(
            rate_rps=10.0, duration_s=duration_s, seed=133, batch_fraction=1.0,
            batch_rows=700))
        return cfg, sorted([*generate_request_log(cfg), *batches], key=lambda r: r.t_s)
    cfg = TrafficConfig(rate_rps=150.0, duration_s=duration_s, arrival="mmpp", seed=134)
    return cfg, generate_request_log(cfg)


def _write_logs(tmp_path, profile: str):
    """A profile's request log and a synthetic results log of its drive."""
    from bodywork_tpu_torch.traffic import write_request_log

    cfg, requests = _profile_log(profile)
    log_path = tmp_path / f"{profile}.requests.jsonl"
    write_request_log(log_path, cfg, requests)
    rng = np.random.default_rng(7)
    results_path = tmp_path / f"{profile}.results.jsonl"
    with results_path.open("w") as f:
        for r in requests:
            status = 429 if rng.uniform() < 0.05 else 200
            f.write(json.dumps({
                "t_s": r.t_s, "route": r.route, "rows": r.rows, "status": status,
                "latency_s": None if status != 200 else round(float(rng.uniform(1e-3, 9e-3)), 9),
                "retry_after_s": 1.0 if status == 429 else None,
                "send_lag_s": 0.0}) + "\n")
    return log_path, results_path


def _tables(tmp_path, profile: str):
    log_path, results_path = _write_logs(tmp_path, profile)
    port, ref = collect.ObservationTable(), jax_collect.ObservationTable()
    assert (collect.ingest_request_log(port, log_path)
            == jax_collect.ingest_request_log(ref, log_path))
    assert (collect.ingest_results_log(port, results_path)
            == jax_collect.ingest_results_log(ref, results_path))
    port.dispatch_cost_s, ref.dispatch_cost_s = dict(_CURVE), dict(_CURVE)
    port.sources.append("dispatch_probe")
    ref.sources.append("dispatch_probe")
    return port, ref


# -- the collector ---------------------------------------------------------------


@pytest.mark.parametrize("profile", ["uniform_row", "heavy_tail_row", "bursty_mmpp"])
def test_the_ingesters_build_the_jax_packages_tables(tmp_path, profile):
    port, ref = _tables(tmp_path, profile)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.summary() == ref.summary()
    assert port.arrival_rate_rps() == ref.arrival_rate_rps()
    assert port.row_quantiles() == ref.row_quantiles()


def _snapshot_and_report(tmp_path):
    snapshot = {
        "bodywork_tpu_serve_batch_occupancy_ratio": {"samples": [
            {"labels": {}, "sum": 3.5, "count": 7}]},
        "bodywork_tpu_serve_batch_flush_total": {"samples": [
            {"labels": {"reason": "window"}, "value": 5},
            {"labels": {"reason": "max_rows"}, "value": 2}]},
        "bodywork_tpu_device_dispatch_seconds": {"samples": [
            {"labels": {"engine": "kernel"}, "sum": 0.02, "count": 40}]},
        "bodywork_tpu_scoring_latency_seconds": {"samples": [
            {"labels": {}, "sum": 0.5, "count": 100}]},
        "bodywork_tpu_store_op_seconds": {"samples": [
            {"labels": {"op": "get"}, "sum": 0.03, "count": 3},
            {"labels": {"op": "put"}, "sum": 0.0, "count": 0}]},
    }
    snap_path = tmp_path / "snapshot.json"
    snap_path.write_text(json.dumps(snapshot))
    report_path = tmp_path / "day.report.json"
    report_path.write_text(json.dumps({"schema": "bodywork_tpu.day_report/1", "spans": [
        {"name": "stage-1-train-model", "duration_s": 1.25},
        {"name": "registry-gate", "duration_s": 0.5},
        {"name": "stage-1-train-model", "duration_s": 0.25}]}))
    return snapshot, snap_path, report_path


def test_obs_snapshot_and_day_report_ingest_as_in_jax(tmp_path):
    snapshot, snap_path, report_path = _snapshot_and_report(tmp_path)
    port, ref = collect.ObservationTable(), jax_collect.ObservationTable()
    for table, pkg in ((port, collect), (ref, jax_collect)):
        pkg.ingest_obs_snapshot(table, snapshot)
        pkg.ingest_obs_snapshot(table, snap_path)
        pkg.ingest_day_report(table, report_path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.service_rate_rps() == ref.service_rate_rps() == 200.0
    bad = tmp_path / "not-a-report.json"
    bad.write_text(json.dumps({"schema": "other/1"}))
    for pkg in (collect, jax_collect):
        with pytest.raises(ValueError, match="not a day report"):
            pkg.ingest_day_report(pkg.ObservationTable(), bad)


@pytest.mark.parametrize("kind", ["request", "results"])
def test_incremental_ingest_equals_the_whole_file_and_leaves_a_torn_tail(tmp_path, kind):
    log_path, results_path = _write_logs(tmp_path, "heavy_tail_row")
    path = log_path if kind == "request" else results_path
    lines = path.read_bytes().splitlines(keepends=True)
    grow = tmp_path / f"growing-{kind}.jsonl"
    whole = {"port": collect.ObservationTable(), "jax": jax_collect.ObservationTable()}
    for name, pkg in (("port", collect), ("jax", jax_collect)):
        ingest = pkg.ingest_request_log if kind == "request" else pkg.ingest_results_log
        ingest(whole[name], path)
    tables, cursors = {}, {}
    for name, pkg in (("port", collect), ("jax", jax_collect)):
        tables[name], cursors[name] = pkg.ObservationTable(), pkg.IngestCursor()
    incremental = {"port": collect, "jax": jax_collect}
    cut = [0, 5, len(lines) // 2, len(lines)]
    for lo, hi in zip(cut, cut[1:]):
        with grow.open("ab") as f:
            f.write(b"".join(lines[lo:hi]))
            # a torn tail: half of the next line, not yet consumed
            torn = lines[hi][: len(lines[hi]) // 2] if hi < len(lines) else b""
            f.write(torn)
        for name, pkg in incremental.items():
            ingest = (pkg.ingest_request_log_incremental if kind == "request"
                      else pkg.ingest_results_log_incremental)
            cursors[name] = ingest(tables[name], grow, cursors[name])
        assert dataclasses.asdict(cursors["port"]) == dataclasses.asdict(cursors["jax"])
        # rewrite without the torn half: the writer completes the line
        grow.write_bytes(b"".join(lines[:hi]))
        assert cursors["port"].offset == len(b"".join(lines[:hi]))
    for name in ("port", "jax"):
        a, b = dataclasses.asdict(tables[name]), dataclasses.asdict(whole[name])
        a.pop("sources"), b.pop("sources")
        assert a == b
    assert dataclasses.asdict(tables["port"]) == dataclasses.asdict(tables["jax"])


# -- the tuner -------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["uniform_row", "heavy_tail_row", "bursty_mmpp"])
def test_fit_tuned_config_writes_the_jax_packages_document(tmp_path, profile):
    from bodywork_tpu.obs.spans import SpanRecorder as JaxRecorder
    from bodywork_tpu_torch.obs.spans import SpanRecorder

    port_table, jax_table = _tables(tmp_path, profile)
    recorder, jax_recorder = SpanRecorder(label="tune"), JaxRecorder(label="tune")
    doc = model.fit_tuned_config(port_table, recorder=recorder)
    ref = jax_model.fit_tuned_config(jax_table, recorder=jax_recorder)
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert doc["knobs"], "the profile fitted no knob"
    # one decision span per knob, with the JAX spans' names and meta
    assert ([(s.name, s.category, s.meta) for s in recorder.spans()]
            == [(s.name, s.category, s.meta) for s in jax_recorder.spans()])
    port_store, jax_store = _stores(tmp_path)
    key, digest = config.write_tuned_config(port_store, doc, day=DAY)
    assert (key, digest) == jax_config.write_tuned_config(jax_store, ref, day=DAY)
    assert port_store.get_bytes(key) == jax_store.get_bytes(key)


def test_fit_is_pure_and_prices_unprobed_rungs_as_jax_does(tmp_path):
    from bodywork_tpu.tune import costmodel as jax_costmodel
    from bodywork_tpu_torch.tune import costmodel

    port_table, jax_table = _tables(tmp_path, "heavy_tail_row")
    thin = {b: c for b, c in _CURVE.items() if b in (1, 64, 512, 4096)}
    samples = costmodel.samples_from_probe(_CURVE, n_features=1)
    cm = costmodel.write_cost_model(FilesystemStore(tmp_path / "cm"),
                                    costmodel.fit_cost_model(samples, seed=3), DAY)
    cm_doc, _digest = costmodel.load_cost_model(FilesystemStore(tmp_path / "cm"), cm[0])
    jax_cm_doc, _ = jax_costmodel.load_cost_model(JaxStore(tmp_path / "cm"), cm[0])
    port_table.dispatch_cost_s, jax_table.dispatch_cost_s = dict(thin), dict(thin)
    doc = model.fit_tuned_config(port_table, cost_model=cm_doc)
    ref = jax_model.fit_tuned_config(jax_table, cost_model=jax_cm_doc)
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert doc["cost_model"]["priced_buckets"] and doc["cost_model"]["digest"] == cm[1]
    assert json.dumps(model.fit_tuned_config(port_table, cost_model=cm_doc),
                      sort_keys=True) == json.dumps(doc, sort_keys=True)


def test_empty_evidence_keeps_every_default_as_jax_does():
    doc = model.fit_tuned_config(collect.ObservationTable())
    ref = jax_model.fit_tuned_config(jax_collect.ObservationTable())
    assert doc == ref and doc["knobs"] == {}


# -- the tuned-config document and the resolver ------------------------------------


def _tuned_stores(tmp_path):
    port_table, jax_table = _tables(tmp_path, "heavy_tail_row")
    port_store, jax_store = _stores(tmp_path)
    key, digest = config.write_tuned_config(port_store, model.fit_tuned_config(port_table),
                                            day=DAY)
    jax_config.write_tuned_config(jax_store, jax_model.fit_tuned_config(jax_table), day=DAY)
    return port_store, jax_store, key, digest


def _sabotage(store, key: str, how: str, stamp) -> str:
    if how == "garbage":
        store.put_bytes(key, b"{nope")
    elif how == "wrong_schema":
        doc = json.loads(store.get_bytes(key))
        doc["schema"] = "bodywork_tpu.other/9"
        store.put_bytes(key, json.dumps(doc).encode())
    elif how == "digest_tamper":
        doc = json.loads(store.get_bytes(key))
        doc["knobs"]["batch_max_rows"] = 7
        store.put_bytes(key, json.dumps(doc).encode())
    elif how in ("all_knobs_invalid", "one_knob_invalid", "non_dict_knobs"):
        doc = json.loads(store.get_bytes(key))
        doc.pop("doc_digest")
        if how == "all_knobs_invalid":
            doc["knobs"] = {"batch_window_ms": "soon", "max_pending": -2}
        elif how == "one_knob_invalid":
            doc["knobs"]["batch_max_rows"] = -5
        else:
            doc["knobs"] = [1, 2]
        store.put_bytes(key, json.dumps(stamp(doc)).encode())
    elif how == "absent_key":
        return "tuning/tuned-config-2030-01-01.json"
    return key


_SABOTAGE = ["none", "garbage", "wrong_schema", "digest_tamper", "all_knobs_invalid",
             "one_knob_invalid", "non_dict_knobs", "absent_key"]


@pytest.mark.parametrize("how", _SABOTAGE)
@pytest.mark.parametrize("explicit", [
    {}, {"max_pending": 99}, {"batch_window_ms": 0.0}, {"buckets": (1, 16)},
    {"batch_window_ms": 1.5, "batch_max_rows": 32, "buckets": (4,), "max_pending": 5},
], ids=["none", "max_pending", "window-0", "buckets", "all"])
def test_resolve_serving_knobs_matches_jax_over_the_matrix(tmp_path, how, explicit):
    from bodywork_tpu.obs import get_registry as jax_registry
    from bodywork_tpu.utils.integrity import stamp_doc as jax_stamp
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.utils.integrity import stamp_doc

    port_store, jax_store, key, _digest = _tuned_stores(tmp_path)
    ref_key = _sabotage(port_store, key, how, stamp_doc)
    assert _sabotage(jax_store, key, how, jax_stamp) == ref_key
    assert port_store.get_bytes(key) == jax_store.get_bytes(key)
    for ref in (ref_key, "latest", None):
        got = config.resolve_serving_knobs(port_store, ref, **explicit)
        want = jax_config.resolve_serving_knobs(jax_store, ref, **explicit)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (how, ref)
        state = get_registry().gauge("bodywork_tpu_tune_config_state").value()
        assert state == jax_registry().gauge("bodywork_tpu_tune_config_state").value()
        loaded = config.load_tuned_config(port_store, ref)
        assert loaded == jax_config.load_tuned_config(jax_store, ref)


def test_validate_knobs_and_the_writer_refuse_as_jax_does(tmp_path):
    cases = [{"batch_window_ms": 1.5, "batch_max_rows": 128, "buckets": [1, 8, 64],
              "max_pending": 200}, {"batch_window_ms": 0.0}, {"batch_window_ms": -0.5},
             {"batch_window_ms": 5000.0}, {"batch_max_rows": 0}, {"buckets": []},
             {"buckets": [4, 2, 1]}, {"buckets": [0, 8]}, {"buckets": list(range(1, 20))},
             {"buckets": "18"}, {"buckets": [1, 131072]}, {"max_pending": 0},
             {"someday_knob": 1}, [1, 2], None]
    for knobs in cases:
        assert config.validate_knobs(knobs) == jax_config.validate_knobs(knobs), knobs
    port_store, jax_store = _stores(tmp_path)
    for bad in ({"batch_window_ms": -1}, {"unknown_knob": 3}):
        with pytest.raises(ValueError, match="invalid knob"):
            config.write_tuned_config(port_store, {"knobs": bad}, day=DAY)
    assert (config.TUNED_CONFIG_SCHEMA, config.TUNED_CONFIG_ENV, config.TUNED_KNOB_ENV,
            config.DISPATCHER_SCOPED_KNOBS) == (
        jax_config.TUNED_CONFIG_SCHEMA, jax_config.TUNED_CONFIG_ENV,
        jax_config.TUNED_KNOB_ENV, jax_config.DISPATCHER_SCOPED_KNOBS)


def test_latest_skips_a_newer_cost_model_as_jax_does(tmp_path):
    port_store, jax_store, key, _digest = _tuned_stores(tmp_path)
    for store in (port_store, jax_store):
        store.put_bytes("tuning/cost-model-2026-09-01.json", b"{}")
    assert config._resolve_ref(port_store, "latest") == key
    assert jax_config._resolve_ref(jax_store, "latest") == key
    empty_port, empty_jax = FilesystemStore(tmp_path / "e1"), JaxStore(tmp_path / "e2")
    assert config._resolve_ref(empty_port, "latest") is None
    assert jax_config._resolve_ref(empty_jax, "latest") is None


def test_the_knob_universe_is_pinned_to_the_serving_modules():
    """The defaults the tuner competes against are the serving modules'
    own constants, and each tuned knob's env var is one the serve stage
    reads and the k8s serve Deployment carries."""
    from bodywork_tpu_torch.pipeline.k8s import _SERVE_ENV_DEFAULTS
    from bodywork_tpu_torch.serve.admission import DEFAULT_MAX_PENDING
    from bodywork_tpu_torch.serve.batcher import DEFAULT_MAX_ROWS, DEFAULT_WINDOW_MS
    from bodywork_tpu_torch.serve.predictor import DEFAULT_BUCKETS
    from bodywork_tpu_torch.tune.online import MUTABLE_LIVE_KNOBS

    assert config.KNOB_DEFAULTS == {
        "batch_window_ms": DEFAULT_WINDOW_MS, "batch_max_rows": DEFAULT_MAX_ROWS,
        "buckets": DEFAULT_BUCKETS, "max_pending": DEFAULT_MAX_PENDING}
    assert config.KNOB_DEFAULTS == jax_config.KNOB_DEFAULTS
    emitted = {name for name, _ in _SERVE_ENV_DEFAULTS}
    assert set(config.TUNED_KNOB_ENV.values()) | {config.TUNED_CONFIG_ENV} <= emitted
    assert set(config.TUNED_KNOB_ENV) == set(MUTABLE_LIVE_KNOBS) == set(
        config.validate_knobs({"batch_window_ms": 1.0, "batch_max_rows": 8, "buckets": [1],
                               "max_pending": 9})[0])


def test_the_serve_stage_reads_the_tuned_config_env_as_jax_does():
    from bodywork_tpu.pipeline import stages as jax_stages
    from bodywork_tpu_torch.pipeline import stages

    for value in ("latest", " tuning/tuned-config-2026-08-01.json ", "", "  "):
        with patch.dict(os.environ, {"BODYWORK_TPU_TUNED_CONFIG": value}):
            assert stages._serve_tuned_config_ref() == jax_stages._serve_tuned_env_knobs()[3]
    with patch.dict(os.environ, {}, clear=False):
        os.environ.pop("BODYWORK_TPU_TUNED_CONFIG", None)
        assert stages._serve_tuned_config_ref() is None


# -- fsck ------------------------------------------------------------------------


def _fsck_tuning(store) -> list:
    from bodywork_tpu_torch.audit import run_fsck

    return [f for f in run_fsck(store)["findings"] if f["prefix"] == "tuning/"]


@pytest.mark.parametrize("how", ["rotted", "replica-less", "partially-invalid",
                                 "wrong-schema", "healthy"])
def test_fsck_validity_matches_the_serving_loader(tmp_path, how):
    """A tuned document fsck calls healthy is one the serving loader
    reads, and one it flags is one serving degrades on (or, partially
    invalid, keeps the valid knobs of: a digest-valid document is valid
    to fsck whatever its knob values)."""
    from bodywork_tpu_torch.audit.manifest import AuditedStore
    from bodywork_tpu_torch.utils.integrity import stamp_doc

    store = AuditedStore(FilesystemStore(tmp_path / "s"))
    port_table, _jax_table = _tables(tmp_path, "heavy_tail_row")
    key, _digest = config.write_tuned_config(store, model.fit_tuned_config(port_table),
                                             day=DAY)
    raw = store.inner.get_bytes(key)
    if how == "rotted":
        store.inner.put_bytes(key, raw.replace(b'"knobs"', b'"knobz"', 1))
    elif how == "replica-less":
        store.inner.put_bytes(key, raw.replace(b'"knobs"', b'"knobz"', 1))
        store.inner.delete(f"audit/digests/{key}.json")
    elif how == "partially-invalid":
        doc = json.loads(raw)
        doc.pop("doc_digest")
        doc["knobs"]["batch_max_rows"] = -5
        store.put_bytes(key, json.dumps(stamp_doc(doc)).encode())
    elif how == "wrong-schema":
        doc = json.loads(raw)
        doc["schema"] = "bodywork_tpu.other/9"
        store.put_bytes(key, json.dumps(doc).encode())
    findings = _fsck_tuning(store)
    knobs, digest, doc = config.load_tuned_config(store, key)
    flagged = any(f["problem"] == "unreadable" for f in findings)
    assert flagged == (doc is None), (how, findings)
    if how == "partially-invalid":
        assert knobs is not None and "batch_max_rows" not in knobs
    if how == "rotted":
        assert findings[0]["severity"] == "restorable"
    if how == "replica-less":
        assert findings[0]["severity"] == "rebuildable"


# -- cli tune ------------------------------------------------------------------------


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_tune_fits_writes_and_prints_one_document_as_jax_does(tmp_path, capsys):
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    log_path, results_path = _write_logs(tmp_path, "uniform_row")
    outs = {}
    for name, fn in (("port", main), ("jax", jax_main)):
        root = str(tmp_path / f"{name}-store")
        argv = ["tune", "--store", root, "--date", "2026-08-01", "--no-probe",
                "--traffic-log", str(log_path), "--results-log", str(results_path)]
        rc, out = _run(fn, argv, capsys)
        assert rc == 0
        outs[name] = json.loads(out)  # one JSON document on stdout
        key = outs[name]["key"]
        outs[name]["bytes"] = open(os.path.join(root, key), "rb").read()
    assert outs["port"] == outs["jax"]
    for name, fn in (("port", main), ("jax", jax_main)):
        rc, out = _run(fn, ["tune", "--store", str(tmp_path / f"{name}-store"), "--dry-run",
                            "--no-probe", "--traffic-log", str(log_path)], capsys)
        outs[name] = (rc, json.loads(out))
    assert outs["port"] == outs["jax"] and outs["port"][1]["dry_run"] is True


def test_cli_tune_with_nothing_to_ingest_exits_1_as_jax_does(tmp_path):
    from bodywork_tpu.cli import main as jax_main
    from bodywork_tpu_torch.cli import main

    assert main(["tune", "--store", str(tmp_path / "p"), "--device", "cpu"]) == 1
    assert jax_main(["tune", "--store", str(tmp_path / "j")]) == 1
    # a bad log is an ingestion failure: exit 1 in both
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"schema": "other/1"}) + "\n")
    assert main(["tune", "--store", str(tmp_path / "p"), "--no-probe",
                 "--traffic-log", str(bad)]) == 1
    assert jax_main(["tune", "--store", str(tmp_path / "j"), "--no-probe",
                     "--traffic-log", str(bad)]) == 1


def test_cli_tune_probes_on_the_cpu_and_fits_a_cost_model(tmp_path, capsys):
    """``--device cpu`` runs the probe here (seconds not compared): the
    curve has every probed rung, the cost model is written under
    ``tuning/`` and reads back, and without ``--device cpu`` and a card
    the command raises rather than falling back."""
    from bodywork_tpu_torch.cli import main
    from bodywork_tpu_torch.tune.costmodel import load_cost_model

    root = _mlp_store(tmp_path)
    rc, out = _run(main, ["tune", "--store", root, "--device", "cpu", "--date", "2026-08-01",
                          "--probe-buckets", "1,8,64,256,512", "--probe-reps", "2"], capsys)
    assert rc == 0
    doc = json.loads(out)
    assert sorted(map(int, doc["observations"]["dispatch_cost_s"])) == [1, 8, 64, 256, 512]
    assert doc["cost_model"]["key"] == "tuning/cost-model-2026-08-01.json"
    cm, digest = load_cost_model(FilesystemStore(root), "latest")
    assert digest == doc["cost_model"]["digest"] and cm["n_samples"] == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["tune", "--store", root])


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


# -- the tuned boot ------------------------------------------------------------------


def _healthz(handle) -> dict:
    import urllib.request

    base = handle.url.rsplit("/score/v1", 1)[0]
    with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
        return json.loads(resp.read())


def test_a_tuned_boot_reports_the_jax_apps_effective_config(tmp_path):
    """``serve_latest_model(tuned_config="latest")`` in both packages over
    one store: the knobs resolve before the predictor is built, and
    ``/healthz`` ``effective_config`` (the digest included) and
    ``tuning`` are the JAX app's; explicit flags beat the document."""
    from bodywork_tpu.serve import serve_latest_model as jax_serve
    from bodywork_tpu_torch.serve import serve_latest_model

    root = _mlp_store(tmp_path)
    port_table, _ = _tables(tmp_path, "heavy_tail_row")
    doc = model.fit_tuned_config(port_table)
    _key, digest = config.write_tuned_config(FilesystemStore(root), doc, day=DAY)
    for explicit in ({}, {"max_pending": 77, "batch_window_ms": 0.0}):
        handle = serve_latest_model(root, host="127.0.0.1", port=0, block=False,
                                    device="cpu", tuned_config="latest", **explicit)
        jax_handle = jax_serve(JaxStore(root), host="127.0.0.1", port=0, block=False,
                               tuned_config="latest", **explicit)
        try:
            got, want = _healthz(handle), _healthz(jax_handle)
        finally:
            handle.stop()
            jax_handle.stop()
        assert got["effective_config"] == want["effective_config"]
        assert got["tuning"] == want["tuning"] is None
        assert got["effective_config"]["tuned_config"] == digest
        if explicit:
            assert got["effective_config"]["max_pending"] == 77
            assert got["effective_config"]["batch_window_ms"] is None


def test_a_malformed_tuned_config_never_fails_the_boot(tmp_path):
    from bodywork_tpu_torch.serve import serve_latest_model

    root = _mlp_store(tmp_path)
    FilesystemStore(root).put_bytes("tuning/tuned-config-2026-08-01.json", b"{nope")
    handle = serve_latest_model(root, host="127.0.0.1", port=0, block=False, device="cpu",
                                tuned_config="latest")
    try:
        effective = _healthz(handle)["effective_config"]
    finally:
        handle.stop()
    assert effective["tuned_config"] is None and effective["batch_window_ms"] is None
