"""The port's canary release loop against the JAX package's: the seeded
routing decision, the registry's canary writers (alias and record
documents byte-equal after start / abort / promote / repair, one alias CAS
each), the app's canary stream and firewall fallback on both front ends,
the reload watcher's canary sync, ``cli registry canary`` and ``cli chaos
canary`` with the JAX commands' outputs and exit codes, and the chaos
acceptance's verdicts for every scenario."""
import json
import urllib.error
import urllib.request
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu import cli as jax_cli
from bodywork_tpu.chaos import run_canary_chaos as jax_run_canary_chaos
from bodywork_tpu.models import LinearRegressor as JaxLinear
from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.registry import CANARY_ACTIONS as JAX_CANARY_ACTIONS
from bodywork_tpu.registry import ModelRegistry as JaxRegistry
from bodywork_tpu.registry import records as jax_rec
from bodywork_tpu.serve.app import create_app as jax_create_app
from bodywork_tpu.serve.app import routes_to_canary as jax_routes_to_canary
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.chaos import CANARY_SCENARIOS, run_canary_chaos
from bodywork_tpu_torch.models import checkpoint as ckpt
from bodywork_tpu_torch.ops.slo import SloPolicy, SloWatchdog
from bodywork_tpu_torch.registry import (
    CANARY_ACTION_METHODS,
    CANARY_ACTIONS,
    ModelRegistry,
    RegistryError,
    read_aliases,
    resolve_canary,
)
from bodywork_tpu_torch.registry import records as rec
from bodywork_tpu_torch.serve import AioServiceHandle, PaddedPredictor, create_app
from bodywork_tpu_torch.serve.app import routes_to_canary
from bodywork_tpu_torch.serve.reload import CheckpointWatcher
from bodywork_tpu_torch.serve.wire import MODEL_KEY_HEADER
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.base import DelegatingStore
from bodywork_tpu_torch.store.schema import REGISTRY_ALIAS_KEY, model_key

torch.set_num_threads(1)

D1, D2, D3 = date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3)
KEY1, KEY2, KEY3 = model_key(D1), model_key(D2), model_key(D3)
BOUNDS = {"lo": -30.0, "hi": 90.0}


def _jax_linear(intercept: float, slope: float, seed: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, 600).astype(np.float32)
    y = (intercept + slope * X + rng.normal(0, 1, 600)).astype(np.float32)
    return JaxLinear().fit(X, y)


@pytest.fixture(scope="module")
def checkpoints():
    """Checkpoint bytes (the JAX package's writer; both packages read
    them): production, a healthy canary, a NaN canary."""
    import io

    first = jax_ckpt.save_model_bytes(_jax_linear(1.0, 0.5, 1))
    second = jax_ckpt.save_model_bytes(_jax_linear(2.0, 0.4, 2))
    with np.load(io.BytesIO(second)) as npz:
        arrays = {name: npz[name] for name in npz.files}
    for name, arr in arrays.items():
        if np.issubdtype(arr.dtype, np.floating):
            arrays[name] = np.full_like(arr, np.nan)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return {"first": first, "second": second, "nan": buf.getvalue()}


def _seed(store, register, promote, checkpoints, canary="second"):
    store.put_bytes(KEY1, checkpoints["first"])
    store.put_bytes(KEY2, checkpoints[canary])
    store.put_bytes(KEY3, checkpoints["first"])
    for key, day in ((KEY1, D1), (KEY2, D2), (KEY3, D3)):
        register(store, key, day=day, prediction_bounds=BOUNDS)
    promote(store, KEY1)
    return store


def _pair(tmp_path, checkpoints, canary="second"):
    port = _seed(FilesystemStore(tmp_path / "port"), rec.register_candidate,
                 lambda s, k: ModelRegistry(s).promote(k, day=D1), checkpoints, canary)
    ref = _seed(JaxStore(tmp_path / "jax"), jax_rec.register_candidate,
                lambda s, k: JaxRegistry(s).promote(k, day=D1), checkpoints, canary)
    return port, ref


def _registry_bytes(store) -> dict:
    return {k: store.get_bytes(k) for k in store.list_keys("registry/")}


class _Counting(DelegatingStore):
    """Counts alias-document CAS writes."""

    def __init__(self, inner):
        super().__init__(inner)
        self.alias_cas = 0

    def put_bytes_if_match(self, key, data, expected_token=None):
        self.alias_cas += key == REGISTRY_ALIAS_KEY
        return self._inner.put_bytes_if_match(key, data, expected_token)


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.35, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 7])
def test_routing_decisions_equal_jaxs(fraction, seed):
    rng = np.random.default_rng(100 + seed)
    requests = [rng.uniform(0, 100, rng.integers(1, 4)).astype(np.float32)
                for _ in range(300)]
    got = [routes_to_canary(seed, fraction, X) for X in requests]
    assert got == [jax_routes_to_canary(seed, fraction, X) for X in requests]
    if 0.0 < fraction < 1.0:
        assert abs(np.mean(got) - fraction) < 0.1


def test_canary_lifecycle_documents_equal_jaxs_one_cas_each(tmp_path, checkpoints):
    port, ref = _pair(tmp_path, checkpoints)
    counting = _Counting(port)
    registry, jax_registry = ModelRegistry(counting), JaxRegistry(ref)
    steps = [
        ("canary_start", dict(model_key=KEY2, fraction=0.25, seed=9, day=D2)),
        ("canary_abort", dict(day=D2, reason="test abort")),
        ("canary_abort", dict()),  # nothing live: None, no CAS
        ("canary_start", dict(model_key=KEY3, fraction=0.5, seed=1, day=D3)),
        ("promote", dict(model_key=KEY3, day=D3)),  # graduating the canary clears it
        ("canary_start", dict(model_key=KEY1, fraction=0.2, day=D3)),
        ("canary_promote", dict(day=D3)),
    ]
    for name, kwargs in steps:
        before = counting.alias_cas
        results = []
        for reg in (registry, jax_registry):
            try:
                results.append(getattr(reg, name)(**kwargs))
            except Exception as exc:  # noqa: BLE001 - the same refusal both sides
                results.append(f"{type(exc).__name__}: {exc}")
        assert results[0] == results[1], name
        assert counting.alias_cas - before == (0 if results[0] is None else 1), name
        assert _registry_bytes(port) == _registry_bytes(ref), name
    assert registry.canary_status() == jax_registry.canary_status()


def test_repair_and_dangling_reasons_equal_jaxs(tmp_path, checkpoints):
    port, ref = _pair(tmp_path, checkpoints)
    for store, reg, resolve in ((port, ModelRegistry(port), resolve_canary),
                                (ref, JaxRegistry(ref), jax_rec.resolve_canary)):
        reg.canary_start(KEY2, fraction=0.3, seed=2, day=D2)
        assert resolve(store)[0]["bounds"] == BOUNDS
        store.delete(KEY2)
    assert resolve_canary(port) == jax_rec.resolve_canary(ref)
    assert ckpt.resolve_serving_state(port) == jax_ckpt.resolve_serving_state(ref)
    assert ModelRegistry(port).canary_repair(day=D2, reason="gone") == JaxRegistry(
        ref).canary_repair(day=D2, reason="gone")
    assert _registry_bytes(port) == _registry_bytes(ref)


def test_refusals_equal_jaxs(tmp_path, checkpoints):
    port, ref = _pair(tmp_path, checkpoints)
    for kwargs in (dict(model_key=KEY1), dict(model_key="models/none.npz"),
                   dict(model_key=KEY2, fraction=1.5)):
        with pytest.raises(RegistryError) as got:
            ModelRegistry(port).canary_start(**kwargs)
        with pytest.raises(Exception) as want:
            JaxRegistry(ref).canary_start(**kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(RegistryError, match="no live canary"):
        ModelRegistry(port).canary_promote()


def _port_model(data: bytes):
    return ckpt.load_model_bytes(data, device="cpu")


def _port_app(checkpoints, canary="second", fraction=1.0, seed=0, canary_bounds=BOUNDS):
    production = _port_model(checkpoints["first"])
    app = create_app(production, D1, predictor=PaddedPredictor(production, (1, 8)),
                     model_key=KEY1, model_source="production", model_bounds=BOUNDS)
    model = _port_model(checkpoints[canary])
    app.set_canary(model, D2, PaddedPredictor(model, (1, 8)), model_key=KEY2,
                   fraction=fraction, seed=seed, bounds=canary_bounds)
    return app


def _post(app, path, payload):
    return app.handle("POST", path, json.dumps(payload).encode(), "application/json")


def test_nan_canary_is_answered_from_production(checkpoints):
    from bodywork_tpu_torch.obs import get_registry

    app = _port_app(checkpoints, canary="nan")
    violations = get_registry().counter("bodywork_tpu_serve_sanity_violations_total")
    before = violations.value(model_key=KEY2, stream="canary", reason="non_finite")
    for path, payload in (("/score/v1", {"X": 50}), ("/score/v1/batch", {"X": [1.0, 2.0]})):
        status, headers, body = _post(app, path, payload)
        assert status == 200 and headers[MODEL_KEY_HEADER] == KEY1
        assert b"NaN" not in body
    assert violations.value(model_key=KEY2, stream="canary",
                            reason="non_finite") == before + 2


def test_streams_headers_and_healthz_equal_jaxs(checkpoints):
    """The port's app and the JAX app, each with the same production and
    canary predictions at fraction 0.4: every answer's bytes and model
    key header equal, and /healthz's canary channel."""
    app = _port_app(checkpoints, fraction=0.4, seed=1)
    jax_models = [jax_ckpt.load_model_bytes(checkpoints[k]) for k in ("first", "second")]

    class _Shared:
        def __init__(self, predictor):
            self.predictor, self.buckets, self.dtype = predictor, predictor.buckets, "float32"

        def predict(self, X):
            return self.predictor.predict(X)

        def warmup(self, n_features=None, sync=True):
            pass

    jax_app = jax_create_app(jax_models[0], D1, predictor=_Shared(app.predictor),
                             warmup=False, model_key=KEY1, model_source="production",
                             model_bounds=BOUNDS)
    jax_app.set_canary(jax_models[1], D2, predictor=_Shared(app._canary.predictor),
                       model_key=KEY2, fraction=0.4, seed=1, bounds=BOUNDS)
    client = jax_app.test_client()
    keys = set()
    for x in range(40):
        status, headers, body = _post(app, "/score/v1", {"X": float(x)})
        want = client.post("/score/v1", json={"X": float(x)})
        assert (status, body, headers[MODEL_KEY_HEADER]) == (
            want.status_code, want.get_data(), want.headers[MODEL_KEY_HEADER])
        keys.add(headers[MODEL_KEY_HEADER])
    assert keys == {KEY1, KEY2}
    app.slo_state = jax_app.slo_state = {"state": "watching"}
    health = json.loads(app.handle("GET", "/healthz")[2])
    want = client.get("/healthz").get_json()
    for key in ("canary_key", "canary_fraction", "watchdog", "model_key", "degraded"):
        assert health[key] == want[key], key
    app.clear_canary()
    assert json.loads(app.handle("GET", "/healthz")[2])["canary_key"] is None


def test_aio_routes_and_firewalls_like_the_thread_engine(checkpoints):
    app = _port_app(checkpoints, fraction=0.5)
    handle = AioServiceHandle(app, "127.0.0.1", 0).start()
    try:
        for x in (1.0, 37.5, 80.0, 99.0):
            req = urllib.request.Request(handle.url, data=json.dumps({"X": [x]}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                status, key, body = resp.status, resp.headers[MODEL_KEY_HEADER], resp.read()
            want = _post(app, "/score/v1", {"X": [x]})
            assert (status, body, key) == (want[0], want[2], want[1][MODEL_KEY_HEADER])
        nan = _port_model(checkpoints["nan"])
        app.set_canary(nan, D2, PaddedPredictor(nan, (1, 8)), model_key=KEY2, fraction=1.0,
                       bounds=BOUNDS)
        req = urllib.request.Request(handle.url + "/batch",
                                     data=json.dumps({"X": [1.0, 2.0]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.headers[MODEL_KEY_HEADER] == KEY1
            assert all(np.isfinite(json.loads(resp.read())["predictions"]))
    finally:
        handle.stop()


class _SharedPredictor:
    """A port predictor behind the JAX app's predictor interface."""

    def __init__(self, predictor):
        self.predictor, self.buckets, self.dtype = predictor, predictor.buckets, "float32"

    def predict(self, X):
        return self.predictor.predict(X)

    def warmup(self, n_features=None, sync=True):
        pass


class _Failing(_SharedPredictor):
    """A canary predictor whose every dispatch raises."""

    def predict(self, X):
        raise RuntimeError("canary dispatch failed")


def _stream_counts(registry) -> dict:
    """Per-(model key, stream) requests, errors and latency observations."""
    requests = registry.counter("bodywork_tpu_serve_model_requests_total")
    errors = registry.counter("bodywork_tpu_serve_model_errors_total")
    latency = registry.histogram("bodywork_tpu_serve_model_latency_seconds")
    return {(key, stream): (requests.value(model_key=key, stream=stream),
                            errors.value(model_key=key, stream=stream),
                            latency.count(model_key=key, stream=stream))
            for key in (KEY1, KEY2) for stream in ("production", "canary")}


def test_stream_accounting_equal_on_both_engines_and_jaxs(checkpoints):
    """While a canary is live, one seeded stream of single rows and
    batches through the port's thread engine, its aio engine and the JAX
    app counts the same requests, errors and latency observations per
    model key and stream; then a canary whose dispatch raises: the same
    500s and one error each."""
    from bodywork_tpu.obs import get_registry as jax_get_registry
    from bodywork_tpu_torch.obs import get_registry

    requests = [("/score/v1", {"X": float(x)}) for x in range(24)]
    requests += [("/score/v1/batch", {"X": [float(x), x + 0.5]}) for x in range(0, 96, 12)]

    def port_thread(app, path, payload):
        return _post(app, path, payload)[0]

    def port_aio(handle, path, payload):
        req = urllib.request.Request(handle.url.replace("/score/v1", "") + path,
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status
        except urllib.error.HTTPError as exc:
            return exc.code

    def jax_send(client, path, payload):
        return client.post(path, json=payload).status_code

    def delta(registry, send, target, sent):
        before = _stream_counts(registry)
        statuses = [send(target, path, payload) for path, payload in sent]
        after = _stream_counts(registry)
        return statuses, {k: tuple(a - b for a, b in zip(after[k], before[k])) for k in after}

    thread_app = _port_app(checkpoints, fraction=0.4, seed=3)
    aio_app = _port_app(checkpoints, fraction=0.4, seed=3)
    handle = AioServiceHandle(aio_app, "127.0.0.1", 0).start()
    jax_models = [jax_ckpt.load_model_bytes(checkpoints[k]) for k in ("first", "second")]
    jax_app = jax_create_app(jax_models[0], D1, predictor=_SharedPredictor(thread_app.predictor),
                             warmup=False, model_key=KEY1, model_source="production",
                             model_bounds=BOUNDS)
    jax_app.set_canary(jax_models[1], D2,
                       predictor=_SharedPredictor(thread_app._canary.predictor),
                       model_key=KEY2, fraction=0.4, seed=3, bounds=BOUNDS)
    client = jax_app.test_client()
    try:
        got = {"thread": delta(get_registry(), port_thread, thread_app, requests),
               "aio": delta(get_registry(), port_aio, handle, requests),
               "jax": delta(jax_get_registry(), jax_send, client, requests)}
        assert got["thread"] == got["aio"] == got["jax"]
        statuses, counts = got["jax"]
        assert set(statuses) == {200}
        assert counts[(KEY2, "canary")][0] > 0 and counts[(KEY1, "production")][0] > 0
        for app in (thread_app, aio_app, jax_app):
            model = jax_models[1] if app is jax_app else _port_model(checkpoints["second"])
            app.set_canary(model, D2, predictor=_Failing(thread_app.predictor),
                           model_key=KEY2, fraction=1.0, seed=3, bounds=BOUNDS)
        failing = requests[:1] + requests[-1:]
        got = {"thread": delta(get_registry(), port_thread, thread_app, failing),
               "aio": delta(get_registry(), port_aio, handle, failing),
               "jax": delta(jax_get_registry(), jax_send, client, failing)}
        assert got["thread"] == got["aio"] == got["jax"]
        assert got["jax"] == ([500, 500], {**{k: (0, 0, 0) for k in counts},
                                           (KEY2, "canary"): (2, 2, 0)})
    finally:
        handle.stop()


def _watched(store, app, policy):
    counting = _Counting(store)
    watchdog = SloWatchdog(counting, [app], policy=policy)
    watcher = CheckpointWatcher(app, counting, poll_interval_s=3600, served_key=KEY1,
                                buckets=(1, 8), slo_watchdog=watchdog, device="cpu")
    return counting, watcher


def test_watcher_loads_routes_and_clears_the_canary(tmp_path, checkpoints):
    port, _ = _pair(tmp_path, checkpoints)
    ModelRegistry(port).canary_start(KEY2, fraction=0.5, seed=2, day=D2)
    app = create_app(_port_model(checkpoints["first"]), D1, model_key=KEY1,
                     model_source="production")
    counting, watcher = _watched(port, app, SloPolicy())
    assert watcher.check_once() is False
    assert app.canary_key == KEY2 and app.canary_fraction == 0.5
    keys = [_post(app, "/score/v1", {"X": float(x)})[1][MODEL_KEY_HEADER] for x in range(40)]
    assert set(keys) == {KEY1, KEY2}
    assert keys == [_post(app, "/score/v1", {"X": float(x)})[1][MODEL_KEY_HEADER]
                    for x in range(40)]
    ModelRegistry(port).canary_abort(day=D2, reason="operator stop")
    watcher.check_once()
    assert app.canary_key is None


def test_a_live_canary_serves_from_its_own_weight_slot(tmp_path, checkpoints):
    """The canary the watcher loads dispatches through the other weight-
    slot lane: production's requests, a canary-free twin's and the
    canary's interleave with no rebind and no build on the request path,
    each stream answering from its own checkpoint. A promotion keeps the
    lanes, and the next canary takes production's old lane: built
    nothing, it only rebinds there at its warm-up."""
    from bodywork_tpu_torch.serve.predictor import GRAPH_CACHE

    port, _ = _pair(tmp_path, checkpoints)
    ModelRegistry(port).canary_start(KEY2, fraction=0.5, seed=2, day=D2)
    production = _port_model(checkpoints["first"])
    app = create_app(production, D1, predictor=PaddedPredictor(production, (1, 8)),
                     model_key=KEY1, model_source="production")
    twin = create_app(production, D1, predictor=app.predictor, warmup=False,
                      model_key=KEY1, model_source="production")
    _counting, watcher = _watched(port, app, SloPolicy())
    watcher.check_once()
    canary = app._canary.predictor
    assert (app.predictor.slot_lane, canary.slot_lane) == (0, 1)
    assert app.predictor._slot is not canary._slot
    before = GRAPH_CACHE.stats()
    plain = {KEY1: production, KEY2: _port_model(checkpoints["second"])}
    for x in np.linspace(1, 99, 40):
        status, headers, body = _post(app, "/score/v1", {"X": float(x)})
        twin_body = _post(twin, "/score/v1", {"X": float(x)})[2]
        key = headers[MODEL_KEY_HEADER]
        want = float(plain[key].predict(np.array([[x]], dtype=np.float32))[0])
        assert status == 200 and json.loads(body)["prediction"] == pytest.approx(want, abs=1e-4)
        assert json.loads(twin_body)["prediction"] == pytest.approx(
            float(production.predict(np.array([[x]], dtype=np.float32))[0]), abs=1e-4)
    after = GRAPH_CACHE.stats()
    assert after["rebinds"] == before["rebinds"] and after["misses"] == before["misses"]

    ModelRegistry(port).canary_promote(day=D2)
    app.promote_canary_bundle()
    assert app.predictor is canary and app.predictor.slot_lane == 1
    ModelRegistry(port).canary_start(KEY3, fraction=0.5, seed=2, day=D3)
    misses = GRAPH_CACHE.stats()["misses"]
    watcher.check_once()
    assert (app.model_key, app.predictor.slot_lane) == (KEY2, 1)
    assert (app.canary_key, app._canary.predictor.slot_lane) == (KEY3, 0)
    assert GRAPH_CACHE.stats()["misses"] == misses


def test_watcher_repairs_a_dangling_slot_in_one_cas(tmp_path, checkpoints):
    port, _ = _pair(tmp_path, checkpoints)
    ModelRegistry(port).canary_start(KEY2, fraction=0.5, day=D2)
    port.delete(KEY2)
    app = create_app(_port_model(checkpoints["first"]), D1, model_key=KEY1,
                     model_source="production")
    counting, watcher = _watched(port, app, SloPolicy())
    assert watcher.check_once() is False and app.canary_key is None
    doc = read_aliases(port)
    assert "canary" not in doc and doc["last_op"] == "canary_repair"
    assert counting.alias_cas == 1
    assert rec.load_record(port, KEY2)["status"] == "candidate"
    assert _post(app, "/score/v1", {"X": 5})[0] == 200


@pytest.mark.parametrize("scenario", CANARY_SCENARIOS)
def test_chaos_canary_verdicts_equal_jaxs(scenario, tmp_path):
    from bodywork_tpu.store import open_store as jax_open_store
    from bodywork_tpu_torch.store import open_store

    got = run_canary_chaos(open_store(tmp_path / "port"), scenario=scenario, seed=3,
                           device="cpu")
    want = jax_run_canary_chaos(jax_open_store(str(tmp_path / "jax")), scenario=scenario,
                                seed=3)
    assert list(got) == list(want)
    # the dump keys carry a digest of the dump, whose span timings differ
    for summary in (got, want):
        assert len(summary.pop("flight_record_keys")) == 1
    assert got == want
    assert got["ok"] is True
    assert (got["aborted"], got["promoted"]) == (
        (False, True) if scenario == "healthy" else (True, False))


def test_chaos_canary_cli_exit_codes_and_refusals(tmp_path, capsys):
    assert cli.main(["chaos", "canary", "--store", str(tmp_path / "a"), "--scenario",
                     "healthy", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["ok"] and summary["promoted"]
    # a used store is refused (exit 1), as is too little canary exposure
    assert cli.main(["chaos", "canary", "--store", str(tmp_path / "a"),
                     "--device", "cpu"]) == 1
    assert cli.main(["chaos", "canary", "--store", str(tmp_path / "b"), "--requests", "20",
                     "--device", "cpu"]) == 1
    with pytest.raises(ValueError):
        run_canary_chaos(FilesystemStore(tmp_path / "c"), scenario="bogus", device="cpu")


def _choices(parser, *path):
    for name in path:
        parser = parser._subparsers._group_actions[0].choices[name]
    return parser


def test_canary_actions_pinned_to_the_cli_the_manager_and_jax():
    assert CANARY_ACTIONS == JAX_CANARY_ACTIONS
    sub = _choices(cli.build_parser(), "registry", "canary")
    assert tuple(sub._subparsers._group_actions[0].choices) == CANARY_ACTIONS
    assert set(CANARY_ACTION_METHODS) == set(CANARY_ACTIONS)
    for method in CANARY_ACTION_METHODS.values():
        assert callable(getattr(ModelRegistry, method))
    chaos = _choices(cli.build_parser(), "chaos", "canary")
    scenario = next(a for a in chaos._actions if a.dest == "scenario")
    assert tuple(scenario.choices) == CANARY_SCENARIOS


@pytest.mark.parametrize("argv", [
    ["registry", "canary", "status"],
    ["registry", "canary", "start", "--model", "2026-07-02", "--fraction", "0.3", "--seed",
     "4", "--date", "2026-07-02"],
    ["registry", "canary", "start", "--model", "2026-07-01"],
    ["registry", "canary", "stop", "--date", "2026-07-02"],
    ["registry", "canary", "promote", "--date", "2026-07-02"],
])
def test_registry_canary_cli_equals_jaxs(argv, tmp_path, checkpoints, capsys):
    port, ref = _pair(tmp_path, checkpoints)
    outputs = []
    for main, store in ((cli.main, port), (jax_cli.main, ref)):
        if argv[2] in ("stop", "promote", "status"):
            # a live canary to act on, started by the same package
            code = main(["registry", "canary", "start", "--store", str(store.root),
                         "--model", "2026-07-02", "--date", "2026-07-02"])
            assert code == 0
        capsys.readouterr()
        code = main([*argv[:3], "--store", str(store.root), *argv[3:]])
        outputs.append((code, capsys.readouterr().out))
    assert outputs[0] == outputs[1]
    assert _registry_bytes(port) == _registry_bytes(ref)
