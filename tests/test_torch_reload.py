"""Hot reload in the port (``ScoringApp.swap_model``, ``serve.reload``)
against the JAX package's: a same-architecture swap builds no new graph
entry and rebinds the weights, answers from its own checkpoint, and drains
the coalescer; the degraded channel (state 1 after a failed reload) and
the health document after a swap equal the JAX app's; a watched service
follows promotions and ``registry rollback`` within its polls, boots
degraded on an empty store, and its watcher is a non-daemon thread that
``stop`` joins; ``cli serve --reload-interval`` leaves on SIGTERM with 143
and no abort."""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import date
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.serve.app import create_app as jax_create_app
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import MLPRegressor, save_model
from bodywork_tpu_torch.models.mlp import MLPConfig
from bodywork_tpu_torch.models import checkpoint as ckpt
from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.registry import ModelRegistry, register_candidate
from bodywork_tpu_torch.serve import (
    GRAPH_CACHE,
    KernelMLPPredictor,
    create_app,
    serve_latest_model,
)
from bodywork_tpu_torch.serve.reload import CheckpointWatcher
from bodywork_tpu_torch.serve.wire import MODEL_KEY_HEADER
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.utils.shutdown import SIGTERM_EXIT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D1, D2 = date(2026, 7, 1), date(2026, 7, 2)


def _mlp(seed: int, hidden=(16, 16)) -> MLPRegressor:
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, 256).astype(np.float32)
    y = (1.0 + (0.5 + 0.1 * seed) * X).astype(np.float32)
    return MLPRegressor(MLPConfig(hidden=hidden, n_steps=20, batch_size=64)).fit(
        X, y, device="cpu")


def _post(app, x):
    return app.handle("POST", "/score/v1", json.dumps({"X": x}).encode(), "application/json")


def test_a_same_architecture_swap_rebinds_and_builds_nothing():
    first, second = _mlp(1), _mlp(2)
    app = create_app(first, D1, predictor=KernelMLPPredictor(first), model_key="models/a.npz",
                     model_source="production")
    before = GRAPH_CACHE.stats()
    app.swap_model(second, D2, model_key="models/b.npz", model_source="production")
    after = GRAPH_CACHE.stats()
    assert after["misses"] == before["misses"] and after["captures"] == before["captures"]
    rebinds = after["rebinds"]
    status, headers, body = _post(app, 42.0)
    assert status == 200 and headers[MODEL_KEY_HEADER] == "models/b.npz"
    want = float(KernelMLPPredictor(second).predict(np.array([[42.0]], np.float32))[0])
    assert json.loads(body)["prediction"] == want
    assert GRAPH_CACHE.stats()["misses"] == before["misses"]
    assert GRAPH_CACHE.stats()["rebinds"] >= rebinds
    swaps = get_registry().get("bodywork_tpu_model_hot_swaps_total").value()
    app.swap_model(first, D1, model_key="models/a.npz", model_source="production")
    assert get_registry().get("bodywork_tpu_model_hot_swaps_total").value() == swaps + 1
    assert json.loads(_post(app, 42.0)[2])["prediction"] == float(
        KernelMLPPredictor(first).predict(np.array([[42.0]], np.float32))[0])


def test_a_swap_drains_the_coalescer_and_every_answer_is_one_models():
    first, second = _mlp(3), _mlp(4)
    app = create_app(first, D1, predictor=KernelMLPPredictor(first), batch_window_ms=5.0,
                     model_key="models/a.npz", model_source="production")
    answers = {"models/a.npz": KernelMLPPredictor(first),
               "models/b.npz": KernelMLPPredictor(second)}
    out = []

    def client(x):
        status, headers, body = _post(app, x)
        out.append((x, headers[MODEL_KEY_HEADER], json.loads(body)["prediction"]))

    threads = [threading.Thread(target=client, args=(float(x),)) for x in range(24)]
    for t in threads[:12]:
        t.start()
    app.swap_model(second, D2, model_key="models/b.npz", model_source="production")
    assert app.batcher.pending_depth() == 0 or app.batcher.stats()["rows_submitted"] > 12
    for t in threads[12:]:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(out) == 24
    for x, key, prediction in out:
        assert prediction == float(answers[key].predict(np.array([[x]], np.float32))[0])
    stats = app.batcher.stats()
    assert stats["rows_submitted"] == stats["rows_dispatched"] == 24
    app.close()


def test_the_degraded_channel_and_the_swapped_health_document_equal_jaxs():
    """State 1 after a failed reload, then a swap clearing it: the port's
    /healthz keys and values are the JAX app's (the port's own keys
    after them)."""
    from bodywork_tpu.models import LinearRegressor as JaxLinear
    from bodywork_tpu_torch.models import LinearRegressor

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 100, 300).astype(np.float32)
    jax_model = JaxLinear().fit(X, (1.0 + 0.5 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    port = create_app(model, D1, model_key="models/a.npz", model_source="production")
    ref = jax_create_app(jax_model, D1, buckets=(1, 8, 64, 512, 4096),
                         model_key="models/a.npz", model_source="production")
    gauge = get_registry().get("bodywork_tpu_serve_degraded_state")
    for app in (port, ref):
        app.set_degraded("hot reload of models/b.npz failed; serving last-good model")
    assert gauge.value() == 1.0
    health = {}
    for name, app in (("port", port), ("jax", ref)):
        doc = (app.healthz_response() if name == "port" else app.healthz_payload())[0]
        doc.pop("latency_exemplars")
        health[name] = doc
    assert list(health["port"])[:len(health["jax"])] == list(health["jax"])
    assert {k: health["port"][k] for k in health["jax"]} == health["jax"]
    port.swap_model(model, D2, model_key="models/b.npz", model_source="production")
    ref.swap_model(jax_model, D2, model_key="models/b.npz", model_source="production")
    assert gauge.value() == 0.0
    a, b = port.healthz_response()[0], ref.healthz_payload()[0]
    for doc in (a, b):
        doc.pop("latency_exemplars")
    assert {k: a[k] for k in b} == b and b["degraded"] is False
    assert _post(port, 1.0)[2] == ref.test_client().post("/score/v1", json={"X": 1.0}).get_data()


def _store(root: Path) -> FilesystemStore:
    """Two registered MLP checkpoints of one architecture, the first
    production."""
    store = FilesystemStore(root)
    for day, seed in ((D1, 5), (D2, 6)):
        key = save_model(store, _mlp(seed), day)
        register_candidate(store, key, day=day)
    ModelRegistry(store).promote(ckpt.model_key(D1), day=D1)
    return store


def _wait_for(fn, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.02)
    raise AssertionError("condition not reached")


def _healthz(handle) -> dict:
    """The health document, 200 or 503."""
    try:
        with urllib.request.urlopen(handle.base_url + "/healthz", timeout=10) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return json.loads(err.read())


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_a_watched_service_follows_promotion_and_rollback(tmp_path, engine):
    store = _store(tmp_path / "s")
    k1, k2 = ckpt.model_key(D1), ckpt.model_key(D2)
    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                engine="kernel", device="cpu", server_engine=engine,
                                watch_interval_s=0.05)
    try:
        watcher = handle.watcher
        assert isinstance(watcher, CheckpointWatcher) and not watcher._thread.daemon
        assert _healthz(handle)["model_key"] == k1
        misses = GRAPH_CACHE.stats()["misses"]
        ModelRegistry(store).promote(k2, day=D2)
        _wait_for(lambda: _healthz(handle)["model_key"] == k2)
        assert GRAPH_CACHE.stats()["misses"] == misses  # rebound, nothing built
        assert cli.main(["registry", "rollback", "--store", str(store.root)]) == 0
        _wait_for(lambda: _healthz(handle)["model_key"] == k1)
    finally:
        handle.stop()
    assert not watcher._thread.is_alive()


def test_a_failed_reload_degrades_then_heals(tmp_path):
    store = _store(tmp_path / "s")
    app = create_app(ckpt.load_model(store, ckpt.model_key(D1), device="cpu")[0], D1,
                     model_key=ckpt.model_key(D1), model_source="production")
    watcher = CheckpointWatcher(app, store, served_key=ckpt.model_key(D1), device="cpu")
    good = store.get_bytes(ckpt.model_key(D2))
    store.put_bytes(ckpt.model_key(D2), b"not a checkpoint")
    ModelRegistry(store).promote(ckpt.model_key(D2), day=D2)
    assert watcher.check_once() is False
    health = app.healthz_response()[0]
    assert health["degraded"] is True and "hot reload of" in health["reason"]
    assert get_registry().get("bodywork_tpu_serve_degraded_state").value() == 1.0
    assert _post(app, 3.0)[0] == 200  # the last-good model serves
    store.put_bytes(ckpt.model_key(D2), good)
    assert watcher.check_once() is True
    assert app.model_key == ckpt.model_key(D2) and app.healthz_response()[0]["degraded"] is False


def test_an_empty_store_boots_degraded_until_the_first_checkpoint(tmp_path):
    store = FilesystemStore(tmp_path / "empty")
    with pytest.raises(Exception):
        serve_latest_model(store, port=0, block=False, device="cpu")
    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False, device="cpu",
                                watch_interval_s=0.05)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(handle.base_url + "/healthz", timeout=10)
        assert err.value.code == 503
        save_model(store, _mlp(7), D1)
        _wait_for(lambda: _healthz(handle)["model_key"] == ckpt.model_key(D1))
    finally:
        handle.stop()


def test_watchers_resolve_the_same_serving_state_as_jaxs(tmp_path):
    from bodywork_tpu.store import FilesystemStore as JaxStore

    store = _store(tmp_path / "s")
    assert ckpt.resolve_serving_state(store) == jax_ckpt.resolve_serving_state(
        JaxStore(store.root))


def test_cli_serve_with_reload_leaves_on_sigterm_with_143(tmp_path):
    _store(tmp_path / "s")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "serve", "--store",
         str(tmp_path / "s"), "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--reload-interval", "0.05"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout],
                     daemon=True).start()
    seen = []
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                continue
            seen.append(line)
            if "listening on http://" in line:
                break
        time.sleep(0.3)  # a few polls of the watcher
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        time.sleep(0.2)
        while not lines.empty():
            seen.append(lines.get())
        out = "".join(seen)
        assert proc.returncode == SIGTERM_EXIT, out
        assert "watching the serving target every 0.05s" in out
        assert "Aborted" not in out and "terminate called" not in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
