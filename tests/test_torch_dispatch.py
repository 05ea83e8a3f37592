"""The port's device-owning dispatcher (``bodywork_tpu_torch.serve.dispatch``)
and the split topology of ``MultiProcessService`` against the JAX
package's, on the CPU.

- An in-process ``DispatchServer`` over a row queue, on a JAX-written MLP
  checkpoint, answers the JAX ``DispatchServer``'s predictions for the
  same rows at the serving parity tolerance the port's serving tests use
  (``tests/test_torch_serve.py``: 2e-4), with the same statuses and
  bundle identity; no model answers 503, a non-finite production
  prediction 500.
- The ``--frontends`` / ``--transport`` / ``--role`` knobs stay in sync
  between the cli, the stage's env parse and the k8s serve Deployment.
- One spawned shm fleet (2 front ends, 1 dispatcher): bytes equal to an
  in-process app's, cross-front-end merging in the aggregated
  ``/metrics``, dispatcher death answered 503 + Retry-After then healed,
  and a dead front end's slots reclaimed."""
import json
import multiprocessing
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import date

import numpy as np
import pytest
import requests
import torch

from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.models.checkpoint import save_model as jax_save_model
from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLPRegressor
from bodywork_tpu.serve import dispatch as jax_dispatch
from bodywork_tpu.serve import rowqueue as jax_rowqueue
from bodywork_tpu.serve.app import create_app as jax_create_app
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.models import LinearRegressor
from bodywork_tpu_torch.models.checkpoint import load_model, save_model
from bodywork_tpu_torch.serve import dispatch, rowqueue
from bodywork_tpu_torch.serve.app import create_app
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

CTX = multiprocessing.get_context("spawn")
DAY = date(2026, 7, 1)
#: each spawned process's own start-up bound on a loaded CPU
STARTUP_TIMEOUT_S = 90.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX trains and checkpoints a small MLP; each package's app serves
    it, coalesced as a dispatcher's is."""
    root = tmp_path_factory.mktemp("dispatch") / "store"
    store = JaxStore(root)
    X, y = jax_generate_day(DAY)
    jax_persist_dataset(store, JaxDataset(X, y, DAY))
    model = JaxMLPRegressor(JaxMLPConfig(hidden=(16, 16), n_steps=50)).fit(X, y)
    key = jax_save_model(store, model, DAY)
    port_model, port_date = load_model(FilesystemStore(root), key, device="cpu")
    apps = {
        "port": create_app(port_model, port_date, batch_window_ms=2.0, model_key=key,
                           model_source="production"),
        "jax": jax_create_app(model, DAY, batch_window_ms=2.0, model_key=key,
                              model_source="production"),
    }
    yield {"root": root, "key": key, "apps": apps,
           "models": {"port": port_model, "jax": model}}
    for app in apps.values():
        app.close()


def _pumped(app, dispatch_mod, rowqueue_mod, submissions):
    """Serve ``app`` through a ``DispatchServer`` thread over a fresh row
    queue and submit each ``(X, kind)``; the replies in order."""
    queue = rowqueue_mod.RowQueue(CTX, frontends=1, slots=16, slot_floats=512)
    server = dispatch_mod.DispatchServer(app, queue)
    pump = threading.Thread(target=server.serve_forever, kwargs={"poll_timeout_s": 0.05},
                            daemon=True)
    pump.start()
    queue.up.value = 1
    client = rowqueue_mod.RowQueueClient(queue, 0).start()
    try:
        replies = []
        for X, kind in submissions:
            done = threading.Event()
            client.submit(X, kind, lambda r, d=done: (replies.append(r), d.set()))
            assert done.wait(30)
        return [(r.status, r.predictions, r.model_key, r.model_info, r.model_date)
                for r in replies]
    finally:
        server.stop()
        pump.join(timeout=5)
        client.stop()


@pytest.mark.parametrize("kind,rows", [
    ("single", [50.0]), ("single", [0.5]), ("single", [99.9]),
    ("batch", [1.0, 2.0, 3.0]), ("batch", list(np.linspace(0, 100, 300).round(3))),
])
def test_dispatcher_answers_the_jax_dispatchers_predictions(world, kind, rows):
    X = np.asarray(rows, np.float32)
    subs = {"port": [(X if kind == "batch" else X[0], rowqueue.KIND_BATCH
                      if kind == "batch" else rowqueue.KIND_SINGLE)],
            "jax": [(X if kind == "batch" else X[0], jax_rowqueue.KIND_BATCH
                     if kind == "batch" else jax_rowqueue.KIND_SINGLE)]}
    (got,) = _pumped(world["apps"]["port"], dispatch, rowqueue, subs["port"])
    (want,) = _pumped(world["apps"]["jax"], jax_dispatch, jax_rowqueue, subs["jax"])
    assert got[0] == want[0] == 200
    assert got[2:] == want[2:]
    assert got[2] == world["key"]
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-4)
    assert got[1].shape == (len(rows),)


def test_concurrent_singles_coalesce_and_answer_each_row(world):
    """Rows submitted together by two front ends share coalesced flushes
    tagged by source; every reply is its own row's prediction."""
    queue = rowqueue.RowQueue(CTX, frontends=2, slots=64, slot_floats=8)
    app = world["apps"]["port"]
    server = dispatch.DispatchServer(app, queue)
    pump = threading.Thread(target=server.serve_forever, kwargs={"poll_timeout_s": 0.05},
                            daemon=True)
    pump.start()
    queue.up.value = 1
    clients = [rowqueue.RowQueueClient(queue, i).start() for i in (0, 1)]
    before = app.batcher.stats()
    try:
        xs = np.linspace(0, 100, 40).astype(np.float32)
        replies = {}
        done = threading.Event()

        def on_done(i):
            def cb(r):
                replies[i] = r
                if len(replies) == len(xs):
                    done.set()
            return cb

        for i, x in enumerate(xs):
            clients[i % 2].submit(x, rowqueue.KIND_SINGLE, on_done(i))
        assert done.wait(30)
        direct = app.predictor.predict(xs[:, None])
        got = np.asarray([float(replies[i].predictions[0]) for i in range(len(xs))])
        np.testing.assert_allclose(got, np.asarray(direct).ravel(), rtol=1e-6, atol=1e-6)
        stats = app.batcher.stats()
        assert stats["rows_submitted"] - before["rows_submitted"] == len(xs)
        assert {"frontend-0", "frontend-1"} <= set(stats["sources_seen"])
    finally:
        server.stop()
        pump.join(timeout=5)
        for c in clients:
            c.stop()


class _NanPredictor:
    """A production predictor whose every answer is non-finite."""

    def __init__(self, inner):
        self.inner = inner
        self.device = getattr(inner, "device", None)

    def predict(self, X):
        return np.full(np.atleast_2d(np.asarray(X)).shape[0], np.nan, np.float32)

    def warmup(self):
        pass


@pytest.mark.parametrize("case", ["no-model", "non-finite"])
def test_no_model_and_a_non_finite_prediction_answer_as_jaxs(world, case):
    """No model: 503 (the front end renders the no-model body); a
    non-finite production prediction: 500, the value never written."""
    if case == "no-model":
        apps = {"port": create_app(None), "jax": jax_create_app(None)}
    else:
        apps = {name: (create_app if name == "port" else jax_create_app)(
                    world["models"][name], DAY, predictor=_NanPredictor(app.predictor),
                    warmup=False, model_key=world["key"])
                for name, app in world["apps"].items()}
    try:
        got = _pumped(apps["port"], dispatch, rowqueue,
                      [(np.float32(50.0), rowqueue.KIND_SINGLE),
                       (np.ones(3, np.float32), rowqueue.KIND_BATCH)])
        want = _pumped(apps["jax"], jax_dispatch, jax_rowqueue,
                       [(np.float32(50.0), jax_rowqueue.KIND_SINGLE),
                        (np.ones(3, np.float32), jax_rowqueue.KIND_BATCH)])
        assert [r[0] for r in got] == [r[0] for r in want] == (
            [503, 503] if case == "no-model" else [500, 500])
        assert all(r[1].size == 0 for r in got)
    finally:
        for app in apps.values():
            app.close()


# --- knob sync: cli, stage env parse, k8s ------------------------------------------

@pytest.mark.parametrize("raw,want", [("3", 3), ("0", None), ("two", None), ("", None)])
def test_frontends_knob_cli_stage_and_k8s_stay_in_sync(monkeypatch, raw, want):
    from bodywork_tpu.pipeline.stages import _serve_fleet_env_knobs as jax_knobs
    from bodywork_tpu_torch.cli import build_parser
    from bodywork_tpu_torch.pipeline import default_pipeline, generate_manifests
    from bodywork_tpu_torch.pipeline.stages import _serve_fleet_env_knobs

    monkeypatch.setenv("BODYWORK_TPU_FRONTENDS", raw)
    assert _serve_fleet_env_knobs() == jax_knobs() == want
    assert build_parser().parse_args(["serve", "--store", "s"]).frontends == want
    docs = generate_manifests(default_pipeline(), store_path="/mnt/store")
    deployment = next(d for d in docs.values()
                      if d["kind"] == "Deployment" and "serve" in d["metadata"]["name"])
    env = deployment["spec"]["template"]["spec"]["containers"][0]["env"]
    assert "BODYWORK_TPU_FRONTENDS" in {e["name"] for e in env}


def test_transport_and_role_choices_stay_in_sync(monkeypatch):
    """``SERVE_TRANSPORTS`` / ``SERVE_ROLES`` == the cli's choices == the
    stage's env parse == the JAX package's."""
    from bodywork_tpu.pipeline.stages import _serve_transport_env_knobs as jax_knobs
    from bodywork_tpu.serve import netqueue as jax_netqueue
    from bodywork_tpu_torch import cli
    from bodywork_tpu_torch.pipeline.stages import _serve_transport_env_knobs
    from bodywork_tpu_torch.serve import netqueue

    assert netqueue.SERVE_TRANSPORTS == cli.SERVE_TRANSPORTS == jax_netqueue.SERVE_TRANSPORTS
    assert netqueue.SERVE_ROLES == cli.SERVE_ROLES == jax_netqueue.SERVE_ROLES
    parser = cli.build_parser()
    serve = next(sp for a in parser._subparsers._group_actions
                 for name, sp in a.choices.items() if name == "serve")
    choices = {o: tuple(a.choices) for a in serve._actions for o in a.option_strings
               if o in ("--transport", "--role")}
    assert choices == {"--transport": netqueue.SERVE_TRANSPORTS,
                       "--role": netqueue.SERVE_ROLES}
    for env in ({}, {"BODYWORK_TPU_SERVE_TRANSPORT": "tcp", "BODYWORK_TPU_SERVE_ROLE":
                     "frontend", "BODYWORK_TPU_DISPATCHER_ADDR": "d:9091",
                     "BODYWORK_TPU_SERVE_STANDBY": "yes"},
                {"BODYWORK_TPU_SERVE_TRANSPORT": "pigeon", "BODYWORK_TPU_SERVE_ROLE": "x",
                 "BODYWORK_TPU_SERVE_STANDBY": "perhaps"}):
        for name in ("BODYWORK_TPU_SERVE_TRANSPORT", "BODYWORK_TPU_SERVE_ROLE",
                     "BODYWORK_TPU_DISPATCHER_ADDR", "BODYWORK_TPU_SERVE_STANDBY"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert _serve_transport_env_knobs() == jax_knobs()


def test_dispatcher_scoped_knobs_partition_the_tuned_schema():
    from bodywork_tpu.tune.config import DISPATCHER_SCOPED_KNOBS as JAX_SCOPED
    from bodywork_tpu_torch.tune.config import DISPATCHER_SCOPED_KNOBS, TUNED_KNOB_ENV

    assert DISPATCHER_SCOPED_KNOBS == JAX_SCOPED
    assert set(DISPATCHER_SCOPED_KNOBS) | {"max_pending"} == set(TUNED_KNOB_ENV)


@pytest.mark.parametrize("argv,message", [
    (["--frontends", "2", "--workers", "2"], "mutually exclusive"),
    (["--transport", "tcp"], "requires --frontends N"),
    (["--frontends", "2", "--standby"], "--standby needs --transport tcp or unix"),
    (["--role", "dispatcher"], "--role dispatcher needs --transport tcp or unix"),
    (["--role", "dispatcher", "--transport", "unix"], "needs --dispatcher-addr"),
    (["--role", "dispatcher", "--transport", "unix", "--standby"], "needs --dispatcher-addr"),
    (["--role", "frontend", "--transport", "tcp"], "--role frontend needs --dispatcher-addr"),
    (["--role", "frontend"], "--role frontend needs --transport tcp or unix"),
    (["--role", "dispatcher", "--transport", "tcp", "--dispatcher-addr", "nocolon"],
     "tcp dispatcher address must be host:port"),
])
def test_cli_serve_refuses_a_bad_split_as_jax_does(tmp_path, caplog, argv, message):
    """The JAX command's refusals, exit 1, before any process starts."""
    from bodywork_tpu_torch import cli

    with caplog.at_level("ERROR"):
        rc = cli.main(["serve", "--store", str(tmp_path), "--device", "cpu", *argv])
    assert rc == 1
    assert message in caplog.text


# --- one spawned shm fleet ------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """2 front ends + 1 dispatcher on one SO_REUSEPORT port, the
    dispatcher on the CPU."""
    from bodywork_tpu_torch.serve.multiproc import MultiProcessService

    root = tmp_path_factory.mktemp("fleet-store")
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 100, 500).astype(np.float32)
    save_model(FilesystemStore(root), LinearRegressor().fit(
        X, (1.0 + 0.5 * X).astype(np.float32), device="cpu"), DAY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        svc = MultiProcessService(str(root), frontends=2, engine="torch", device="cpu",
                                  startup_timeout_s=STARTUP_TIMEOUT_S).start()
    try:
        yield svc, root
    finally:
        svc.stop()


def _base(svc) -> str:
    return svc.url.rsplit("/score/v1", 1)[0]


def test_fleet_answers_the_in_process_apps_bytes(fleet):
    from bodywork_tpu_torch.serve.wire import BINARY_CONTENT_TYPE, encode_binary_rows

    svc, root = fleet
    assert len(svc.worker_pids) == 2
    assert svc.dispatcher_pid not in svc.worker_pids
    model, model_date = load_model(FilesystemStore(root), device="cpu")
    app = create_app(model, model_date, model_key="models/regressor-2026-07-01.npz",
                     model_source="latest")
    cases = [("/score/v1", json.dumps({"X": 50}).encode(), "application/json"),
             ("/score/v1", encode_binary_rows(np.asarray([50.0])), BINARY_CONTENT_TYPE),
             ("/score/v1/batch", json.dumps({"X": [10, 50, 90]}).encode(),
              "application/json"),
             ("/score/v1", b"not json", "application/json")]
    for path, body, ctype in cases:
        r = requests.post(_base(svc) + path, data=body, headers={"Content-Type": ctype},
                          timeout=30)
        status, headers, want = app.handle("POST", path, body, ctype)
        assert (r.status_code, r.content) == (status, want), path
        assert r.headers.get("X-Bodywork-Model-Key") == headers.get("X-Bodywork-Model-Key")
    h = requests.get(_base(svc) + "/healthz", timeout=30)
    assert h.status_code == 200
    assert h.json()["role"] == "frontend" and h.json()["dispatcher_up"] is True
    assert h.json()["transport"]["kind"] == "shm"


def test_cross_front_end_merging_shows_in_the_aggregated_metrics(fleet):
    svc, _ = fleet
    with ThreadPoolExecutor(max_workers=16) as pool:
        codes = list(pool.map(
            lambda _: requests.post(svc.url, json={"X": 50}, timeout=30).status_code,
            range(160)))
    assert codes.count(200) == len(codes)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        scrape = requests.get(_base(svc) + "/metrics", timeout=30).text
        values = {line.split(" ")[0]: float(line.rsplit(" ", 1)[1])
                  for line in scrape.splitlines() if line and not line.startswith("#")}
        merged = sum(v for k, v in values.items()
                     if k.startswith("bodywork_tpu_coalesced_multisource_flush_total"))
        rows = sum(v for k, v in values.items()
                   if k.startswith("bodywork_tpu_rowqueue_rows_total"))
        if merged >= 1 and rows >= 160:
            break
        time.sleep(0.5)
    assert rows >= 160 and merged >= 1
    assert "bodywork_tpu_rowqueue_handoff_seconds_count" in scrape


def test_dispatcher_death_answers_503_then_heals(fleet):
    """SIGKILL the dispatcher: every answer until the heal is the
    byte-perfect 200 or the honest 503 + Retry-After; the respawn heals
    byte for byte."""
    svc, _ = fleet
    baseline = requests.post(svc.url, json={"X": 50}, timeout=30)
    assert baseline.status_code == 200
    old_pid = svc.dispatcher_pid
    svc.kill_dispatcher()
    saw_503 = healed = None
    health_down = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        r = requests.post(svc.url, json={"X": 50}, timeout=30)
        assert r.status_code in (200, 503), r.status_code
        if r.status_code == 503:
            saw_503 = r
            assert r.headers["Retry-After"]
            assert r.json()["error"] == "scoring dispatcher unavailable; retry shortly"
            health = requests.get(_base(svc) + "/healthz", timeout=30)
            health_down.append(health.status_code == 503 and "Retry-After" in health.headers)
        elif saw_503 is not None:
            healed = r
            break
        else:
            assert r.content == baseline.content
        time.sleep(0.05)
    assert saw_503 is not None and healed is not None
    assert any(health_down)  # probes saw the front ends leave the rotation
    assert healed.content == baseline.content
    assert svc.dispatcher_pid not in (None, old_pid)
    assert requests.get(_base(svc) + "/healthz", timeout=30).json()["dispatcher_up"]


def test_a_dead_front_ends_slots_are_reclaimed_by_the_supervisor(fleet):
    svc, _ = fleet
    queue = svc._queue
    assert int(queue.free[0]) == queue.slots
    victim = svc._procs[0].pid
    # the victim's requests in flight: slots allocated as front end 0
    holder = rowqueue.RowQueueClient(queue, frontend_id=0)
    for _ in range(3):
        holder._alloc_slot()
    svc.kill_worker(victim)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and int(queue.free[0]) < queue.slots:
        time.sleep(0.1)
    assert int(queue.free[0]) == queue.slots
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and len(svc.worker_pids) < 2:
        time.sleep(0.25)
    assert len(svc.worker_pids) == 2
    assert requests.post(svc.url, json={"X": 50}, timeout=30).status_code == 200
