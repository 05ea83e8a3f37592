"""The port's sharded serving against the JAX package's
``tests/test_sharded_serve.py``: a ``data x model`` mesh predictor
(``parallel.ShardedMLPPredictor``) answers byte-identical rows to the
single-device predictor for data-parallel meshes, tensor parallelism
within 1e-4, per-mesh programs in the graph cache and a same-mesh hot
swap that captures nothing, ``build_predictor``'s routing and degrades,
``unsupported_mesh``, HTTP byte identity on both front ends (coalesced
too), the firewall fallback, ``/healthz`` ``mesh``, the metrics, and the
CLI, stage and k8s mesh knobs in sync. The port runs on the CPU repeated
(virtual devices, ``BODYWORK_TPU_VIRTUAL_DEVICES``)."""
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from datetime import date
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bodywork_tpu.models.checkpoint import save_model_bytes as jax_save_model_bytes
from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLPRegressor
from bodywork_tpu.parallel import ShardedMLPPredictor as JaxShardedMLPPredictor
from bodywork_tpu.parallel import make_mesh as jax_make_mesh
from bodywork_tpu.parallel import train_mlp_sharded as jax_train_mlp_sharded
from bodywork_tpu_torch.models import LinearRegressor, MLPConfig, MLPRegressor
from bodywork_tpu_torch.models.checkpoint import load_model_bytes, save_model_bytes
from bodywork_tpu_torch.parallel import DataParallelPredictor, ShardedMLPPredictor, make_mesh
from bodywork_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV
from bodywork_tpu_torch.serve import GRAPH_CACHE, PaddedPredictor, create_app
from bodywork_tpu_torch.serve.aio import AioServiceHandle
from bodywork_tpu_torch.serve.httpcore import ServiceHandle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
D1 = date(2026, 4, 1)


def _cpus(n: int) -> list:
    return [CPU] * n


def _mesh(data: int, model: int = 1):
    return make_mesh(data=data, model=model, devices=_cpus(data * model))


@pytest.fixture(scope="module")
def mlp_model():
    rng = np.random.default_rng(7)
    X = rng.uniform(0, 100, 800).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, 800)).astype(np.float32)
    return MLPRegressor(MLPConfig(hidden=(16, 16), n_steps=80, batch_size=64)).fit(
        X, y, device="cpu")


@pytest.fixture(scope="module")
def linear_model():
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, 400)).astype(np.float32)
    return LinearRegressor().fit(X, y, device="cpu")


@pytest.fixture()
def seeded_mlp_store(tmp_path):
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.train import train_on_history

    store = FilesystemStore(tmp_path / "artefacts")
    persist_dataset(store, Dataset(*generate_day(D1, device="cpu"), D1))
    result = train_on_history(store, "mlp", model_kwargs={"hidden": [8, 8], "n_steps": 40},
                              device="cpu")
    return store, result


# -- predictor semantics -----------------------------------------------------

def test_sharded_predictor_is_byte_identical_on_data_parallel_meshes(mlp_model):
    single = PaddedPredictor(mlp_model, buckets=(8, 64, 512))
    X = np.random.default_rng(0).uniform(0, 100, (600, 1)).astype(np.float32)
    for n_data in (2, 4):
        pred = ShardedMLPPredictor(mlp_model, _mesh(n_data), buckets=(8, 64, 512))
        assert pred.buckets == (8, 64, 512)
        pred.warmup()
        for n in (1, 3, 8, 100, 600):
            np.testing.assert_array_equal(pred.predict(X[:n]), single.predict(X[:n]),
                                          err_msg=f"mesh {n_data}x1, n={n}")
    pred8 = ShardedMLPPredictor(mlp_model, _mesh(8), buckets=(64, 512))
    pred8.warmup()
    for n in (64, 100, 600):
        np.testing.assert_array_equal(pred8.predict(X[:n]), single.predict(X[:n]))


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 4)])
def test_sharded_predictor_tensor_parallel(mlp_model, data, model):
    """The model axis really splits the hidden weights (each shard its
    slice of W0, its rows of W1) and tracks single-device within JAX's
    bar: the row-parallel sum reassociates the hidden reduction."""
    pred = ShardedMLPPredictor(mlp_model, _mesh(data, model), buckets=(8, 64))
    pred.warmup()
    for row in pred.shard_params:
        layers = row["net"]["layers"]
        assert [tuple(w.shape) for w in layers[0]["w"]] == [(1, 16 // model)] * model
        assert [tuple(w.shape) for w in layers[1]["w"]] == [(16 // model, 16)] * model
        assert torch.equal(torch.cat(layers[0]["w"], dim=1), mlp_model.net.layers[0].w)
        assert isinstance(layers[2]["w"], torch.Tensor)
    X = np.linspace(0.0, 100.0, 64, dtype=np.float32)[:, None]
    np.testing.assert_allclose(pred.predict(X), mlp_model.predict(X), rtol=1e-4, atol=1e-4)


def test_sharded_predictor_refuses_tensor_parallel_non_mlp(linear_model):
    with pytest.raises(ValueError, match="requires an MLP"):
        ShardedMLPPredictor(linear_model, _mesh(2, 2))


def test_the_graph_cache_keeps_each_mesh_apart(mlp_model):
    """Two mesh shapes over one checkpoint build two program sets; a
    second same-mesh predictor builds nothing."""
    buckets = (16, 128)
    p2 = ShardedMLPPredictor(mlp_model, _mesh(2), buckets=buckets)
    p2.warmup()
    before = GRAPH_CACHE.stats()["misses"]
    p4 = ShardedMLPPredictor(mlp_model, _mesh(4), buckets=buckets)
    p4.warmup()
    after_mesh4 = GRAPH_CACHE.stats()["misses"]
    assert after_mesh4 > before
    p1x2 = ShardedMLPPredictor(mlp_model, _mesh(1, 2), buckets=buckets)
    p1x2.warmup()
    assert GRAPH_CACHE.stats()["misses"] == after_mesh4 + len(buckets)
    p2b = ShardedMLPPredictor(mlp_model, _mesh(2), buckets=buckets)
    p2b.warmup()
    assert GRAPH_CACHE.stats()["misses"] == after_mesh4 + len(buckets)
    X = np.ones((5, 1), np.float32)
    np.testing.assert_array_equal(p2.predict(X), p4.predict(X))


def test_a_mesh_trained_checkpoint_swaps_over_the_same_mesh_with_no_build():
    from bodywork_tpu_torch.parallel import train_mlp_sharded

    rng = np.random.default_rng(5)
    X = rng.uniform(0, 100, 512).astype(np.float32)
    y = (1.0 + 0.5 * X).astype(np.float32)
    mesh = _mesh(2, 2)
    trained = train_mlp_sharded(X, y, MLPConfig(hidden=(16, 16), n_steps=30, batch_size=64),
                                mesh)
    clone = load_model_bytes(save_model_bytes(trained), device="cpu")
    p1 = ShardedMLPPredictor(clone, mesh, buckets=(8, 64))
    p1.warmup()
    stats = GRAPH_CACHE.stats()
    clone2 = load_model_bytes(save_model_bytes(trained), device="cpu")
    p2 = ShardedMLPPredictor(clone2, mesh, buckets=(8, 64))
    p2.warmup()
    after = GRAPH_CACHE.stats()
    assert (after["misses"], after["captures"]) == (stats["misses"], stats["captures"])
    assert after["rebinds"] > stats["rebinds"]
    np.testing.assert_array_equal(p1.predict(X[:32]), p2.predict(X[:32]))


def test_a_jax_trained_sharded_checkpoint_serves_as_jaxs_sharded_predictor():
    """A checkpoint JAX's ``train_mlp_sharded`` fitted on 2x2, served by
    both packages' 2x2 ``ShardedMLPPredictor``: within 1e-4."""
    rng = np.random.default_rng(8)
    X = rng.uniform(0, 100, 512).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, 512)).astype(np.float32)
    jax_mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jax_model = jax_train_mlp_sharded(X, y, JaxMLPConfig(hidden=(16, 16), n_steps=40,
                                                         batch_size=64), jax_mesh)
    port_model = load_model_bytes(jax_save_model_bytes(jax_model), device="cpu")
    port = ShardedMLPPredictor(port_model, _mesh(2, 2), buckets=(8, 64))
    ref = JaxShardedMLPPredictor(jax_model, jax_mesh, buckets=(8, 64))
    Xq = np.linspace(0.0, 100.0, 50, dtype=np.float32)[:, None]
    np.testing.assert_allclose(port.predict(Xq), ref.predict(Xq), rtol=1e-4, atol=1e-4)


# -- engine selection (serve.server.build_predictor) -------------------------

def test_build_predictor_routes_and_degrades_as_jaxs(mlp_model, linear_model, monkeypatch):
    from bodywork_tpu_torch.serve.server import build_predictor, resolve_engine

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    p = build_predictor(mlp_model, mesh_data=2)
    assert isinstance(p, ShardedMLPPredictor) and p.mesh.shape == {"data": 2, "model": 1}
    p = build_predictor(mlp_model, mesh_data=2, mesh_model=2)
    assert p.mesh.shape == {"data": 2, "model": 2}
    p = build_predictor(mlp_model, mesh_model=2)
    assert p.mesh.shape == {"data": 1, "model": 2}
    assert resolve_engine("auto", mlp_model, CPU, mesh_data=2) == "torch"
    p = build_predictor(linear_model, mesh_data=2)
    assert type(p) is DataParallelPredictor
    p = build_predictor(linear_model, mesh_data=2, mesh_model=2)
    assert type(p) is DataParallelPredictor and p.mesh.shape == {"data": 2, "model": 1}
    for engine in ("kernel", "kernel-bf16", "torch-bf16", "torch-int8"):
        with pytest.raises(ValueError, match="single-device"):
            build_predictor(mlp_model, engine, mesh_data=2)
    with pytest.raises(ValueError, match="unknown serving engine"):
        build_predictor(mlp_model, "xla", mesh_data=2)
    p = build_predictor(mlp_model, mesh_data=1024)
    assert p.mesh.shape == {"data": 8, "model": 1}
    p = build_predictor(mlp_model, mesh_data=2, mesh_model=1024)
    assert p.mesh.shape == {"data": 8, "model": 1}
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    p = build_predictor(mlp_model, mesh_data=2)
    assert p.mesh.shape == {"data": 1, "model": 1}


def test_a_quantized_dtype_over_a_mesh_keeps_f32(seeded_mlp_store, monkeypatch):
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.serve.server import build_serving_predictor

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    store, result = seeded_mlp_store
    counter = get_registry().counter("bodywork_tpu_serve_quantization_gate_total")
    before = counter.value(dtype="int8", outcome="unsupported_mesh")
    predictor, served = build_serving_predictor(store, result.model, "torch", dtype="int8",
                                                mesh_data=2)
    assert served == "float32" and isinstance(predictor, ShardedMLPPredictor)
    assert counter.value(dtype="int8", outcome="unsupported_mesh") == before + 1


# -- HTTP byte identity: sharded vs single-device, both front ends ------------

def _post(url: str, body) -> tuple[int, bytes]:
    request = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def sharded_vs_single(mlp_model):
    """Four live services over one checkpoint: {single-device, 2x1 mesh}
    x {thread, aio}, coalescer on, one shared bucket set."""
    handles = {}
    buckets = (8, 64)
    for engine in ("thread", "aio"):
        for tag, predictor in (
                ("single", PaddedPredictor(mlp_model, buckets=buckets)),
                ("sharded", ShardedMLPPredictor(mlp_model, _mesh(2), buckets=buckets))):
            app = create_app(mlp_model, D1, predictor=predictor, warmup=True,
                             batch_window_ms=2.0)
            cls = AioServiceHandle if engine == "aio" else ServiceHandle
            handles[(engine, tag)] = cls(app, "127.0.0.1", 0).start()
    yield {key: h.url.replace("/score/v1", "") for key, h in handles.items()}
    for h in handles.values():
        h.stop()


@pytest.mark.parametrize("route,body,status", [
    ("/score/v1", {"X": 50}, 200),
    ("/score/v1", {"X": [[60.0]]}, 200),
    ("/score/v1/batch", {"X": [1.0, 2.0, 3.0]}, 200),
    ("/score/v1", {"Y": 1}, 400),
])
def test_sharded_http_answers_are_byte_identical(sharded_vs_single, route, body, status):
    answers = {key: _post(base + route, body) for key, base in sharded_vs_single.items()}
    assert {s for s, _ in answers.values()} == {status}
    assert len({b for _, b in answers.values()}) == 1


def test_the_coalesced_sharded_path_is_byte_identical(sharded_vs_single):
    xs = [float(v) for v in np.linspace(5, 95, 16)]

    def burst(base):
        out = {}
        threads = [threading.Thread(target=lambda x=x: out.__setitem__(
            x, _post(base + "/score/v1", {"X": x}))) for x in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    per_target = {k: burst(base) for k, base in sharded_vs_single.items()}
    for x in xs:
        assert len({per_target[k][x] for k in per_target}) == 1, x
    assert all(s == 200 for answers in per_target.values() for s, _ in answers.values())


def test_healthz_reports_the_mesh_as_jaxs(mlp_model, sharded_vs_single):
    health = {k: _get(base + "/healthz")["mesh"] for k, base in sharded_vs_single.items()}
    assert health[("thread", "sharded")] == health[("aio", "sharded")] == {"data": 2, "model": 1}
    assert health[("thread", "single")] is None
    from bodywork_tpu.serve import create_app as jax_create_app
    from bodywork_tpu.parallel import ShardedMLPPredictor as JaxSharded

    jax_model = JaxMLPRegressor(JaxMLPConfig(hidden=(16, 16), n_steps=5)).fit(
        np.arange(64, dtype=np.float32), np.arange(64, dtype=np.float32))
    jax_app = jax_create_app(jax_model, D1, warmup=False, predictor=JaxSharded(
        jax_model, jax_make_mesh(data=4, devices=jax.devices()[:4]), buckets=(8,)))
    app = create_app(mlp_model, D1, warmup=False,
                     predictor=ShardedMLPPredictor(mlp_model, _mesh(4), buckets=(8,)))
    assert app.healthz_payload()["mesh"] == jax_app.healthz_payload()[0]["mesh"]


def test_the_firewall_fallback_rides_a_sharded_production(mlp_model):
    """A NaN canary over a sharded production: the fallback re-predict
    answers the clean production route's bytes."""
    predictor = ShardedMLPPredictor(mlp_model, _mesh(2), buckets=(1, 8))
    app = create_app(mlp_model, D1, predictor=predictor, model_key="models/prod.npz",
                     model_bounds={"lo": -1e6, "hi": 1e6})
    body = json.dumps({"X": [55.0]}).encode()
    status, _headers, clean = app.handle("POST", "/score/v1", body, "application/json")
    assert status == 200
    params = mlp_model.params
    bad = MLPRegressor(mlp_model.config, {
        "net": {"layers": [{k: torch.full_like(v, float("nan")) for k, v in layer.items()}
                           for layer in params["net"]["layers"]]},
        "scaler": dict(params["scaler"])})
    app.set_canary(bad, date(2026, 4, 2), ShardedMLPPredictor(bad, _mesh(2), buckets=(1, 8)),
                   model_key="models/bad.npz", fraction=1.0, seed=5)
    status, headers, answered = app.handle("POST", "/score/v1", body, "application/json")
    assert status == 200 and answered == clean
    assert headers["X-Bodywork-Model-Key"] == "models/prod.npz"


# -- hot swap through the real watcher path ----------------------------------

def test_a_same_mesh_hot_swap_builds_nothing(seeded_mlp_store, monkeypatch):
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.serve.reload import CheckpointWatcher
    from bodywork_tpu_torch.train import train_on_history

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    store, result_a = seeded_mlp_store
    buckets = (1, 8, 64)
    predictor = ShardedMLPPredictor(result_a.model, _mesh(2), buckets=buckets)
    app = create_app(result_a.model, D1, predictor=predictor,
                     model_key=result_a.model_artefact_key)
    watcher = CheckpointWatcher(app, store, poll_interval_s=3600, mesh_data=2,
                                served_key=result_a.model_artefact_key, buckets=buckets)
    d2 = date(2026, 4, 2)
    persist_dataset(store, Dataset(*generate_day(d2, device="cpu"), d2))
    result_b = train_on_history(store, "mlp", model_kwargs={"hidden": [8, 8], "n_steps": 40},
                                device="cpu")
    before = GRAPH_CACHE.stats()
    assert watcher.check_once() is True
    after = GRAPH_CACHE.stats()
    assert (after["misses"], after["captures"]) == (before["misses"], before["captures"])
    swapped = app.predictor
    assert isinstance(swapped, ShardedMLPPredictor) and swapped.mesh.shape == {
        "data": 2, "model": 1}
    assert app.model_key == result_b.model_artefact_key
    X = np.array([[42.0]], dtype=np.float32)
    np.testing.assert_array_equal(swapped.predict(X),
                                  PaddedPredictor(result_b.model, buckets).predict(X))


# -- metrics -----------------------------------------------------------------

def test_the_sharded_metrics_pass_the_lint_and_move(mlp_model):
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.obs.registry import validate_metric_name

    validate_metric_name("bodywork_tpu_parallel_mesh_info", "gauge")
    validate_metric_name("bodywork_tpu_serve_sharded_dispatch_total", "counter")
    reg = get_registry()
    mesh = _mesh(2)
    assert reg.gauge("bodywork_tpu_parallel_mesh_info").value(data="2", model="1") == 1.0
    counter = reg.counter("bodywork_tpu_serve_sharded_dispatch_total")
    before = counter.value(mesh="2x1")
    ShardedMLPPredictor(mlp_model, mesh, buckets=(8,)).predict(np.ones((3, 1), np.float32))
    assert counter.value(mesh="2x1") == before + 1


# -- the mesh knobs: cli, stage and k8s --------------------------------------

def test_the_mesh_knobs_of_cli_stage_and_k8s_stay_in_sync(monkeypatch):
    from bodywork_tpu_torch.cli import build_parser
    from bodywork_tpu_torch.pipeline import default_pipeline
    from bodywork_tpu_torch.pipeline.k8s import generate_manifests
    from bodywork_tpu_torch.pipeline.stages import _serve_env_knobs

    for mesh_d, mesh_m, want_d, want_m in (("4", "2", 4, 2), ("0", "-2", None, 1),
                                           ("two", "x", None, 1), ("", "", None, 1)):
        monkeypatch.setenv("BODYWORK_TPU_MESH_DATA", mesh_d)
        monkeypatch.setenv("BODYWORK_TPU_MESH_MODEL", mesh_m)
        assert _serve_env_knobs()[4:] == (want_d, want_m), (mesh_d, mesh_m)
        args = build_parser().parse_args(["serve", "--store", "s"])
        assert (args.mesh_data, args.mesh_model) == (want_d, want_m)
    docs = generate_manifests(default_pipeline(), store_path="/mnt/store")
    deployment = next(d for d in docs.values()
                      if d["kind"] == "Deployment" and "serve" in d["metadata"]["name"])
    names = {e["name"] for e in deployment["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert {"BODYWORK_TPU_MESH_DATA", "BODYWORK_TPU_MESH_MODEL"} <= names


def test_the_stage_env_mesh_drives_sharded_serving(seeded_mlp_store, monkeypatch):
    from bodywork_tpu_torch.pipeline.stages import StageContext, serve_stage

    store, result = seeded_mlp_store
    monkeypatch.setenv("BODYWORK_TPU_MESH_DATA", "2")
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    handle = serve_stage(StageContext(store=store, today=D1, device="cpu"), buckets=(1, 8))
    try:
        assert isinstance(handle.app.predictor, ShardedMLPPredictor)
        assert handle.app.predictor.mesh.shape == {"data": 2, "model": 1}
        status, body = _post(handle.url, {"X": 42.0})
        assert status == 200
        want = PaddedPredictor(result.model, (1, 8)).predict(np.array([[42.0]], np.float32))
        assert json.loads(body)["prediction"] == float(want[0])
    finally:
        handle.stop()


def test_cli_serve_refuses_a_mesh_beside_process_replicas(tmp_path):
    env = {**os.environ, "BODYWORK_TPU_MESH_DATA": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "serve", "--store", str(tmp_path),
         "--device", "cpu", "--workers", "2", "--mesh-data", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "--workers/--frontends is per-process serving" in proc.stdout + proc.stderr
