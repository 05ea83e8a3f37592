"""The day loop: the port's pipeline spec, stages and local runner against
the JAX package's, from the DAG grammar and the runner's retry, deadline
and write-fence contract up to a seven-day ``run-sim`` on the same data."""
import json
import threading
import time
import urllib.request
from datetime import date, timedelta

import numpy as np
import pandas as pd
import pytest
import torch

from bodywork_tpu.data.generator import generate_day as jax_generate_day
from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.models.base import Regressor as JaxRegressor
from bodywork_tpu.models.base import train_test_split as jax_train_test_split
from bodywork_tpu.pipeline import LocalRunner as JaxRunner
from bodywork_tpu.pipeline.spec import default_pipeline as jax_default_pipeline
from bodywork_tpu.pipeline.spec import parse_dag as jax_parse_dag
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data import Dataset, generator
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.monitor import InProcessScoringClient, score_dataset
from bodywork_tpu_torch.pipeline import (
    LocalRunner,
    PipelineSpec,
    StageFailure,
    StageSpec,
    default_pipeline,
    parse_dag,
)
from bodywork_tpu_torch.serve import RoundRobinApp
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.epoch import EpochGuardedStore, WriteEpochRevoked

torch.set_num_threads(1)

START = date(2026, 7, 1)
HERE = "tests.test_torch_pipeline"


@pytest.fixture
def store(tmp_path):
    return FilesystemStore(tmp_path / "store")


# -- the spec ------------------------------------------------------------------

@pytest.mark.parametrize("dag", [
    "stage-1 >> stage-2 >> stage-3 >> stage-4", "a >> b,c >> d", " a>>b , c>>  ", "a", ">> a >>",
])
def test_parse_dag_is_the_jax_grammar(dag):
    assert parse_dag(dag) == jax_parse_dag(dag)


@pytest.mark.parametrize("model_type", ["linear", "mlp"])
@pytest.mark.parametrize("mode", ["batch", "single"])
def test_default_pipeline_is_the_jax_pipeline(model_type, mode):
    got, want = default_pipeline(model_type, mode), jax_default_pipeline(model_type, mode)
    assert got.dag == want.dag and got.name == want.name
    assert list(got.stages) == list(want.stages)
    for name, stage in got.stages.items():
        ref = want.stages[name]
        assert stage.executable == ref.executable.replace("bodywork_tpu.", "bodywork_tpu_torch.")
        for field in ("kind", "args", "retries", "max_completion_time_s",
                      "max_startup_time_s", "replicas", "port"):
            assert getattr(stage, field) == getattr(ref, field), (name, field)


def test_spec_refuses_undeclared_stages_and_kinds():
    with pytest.raises(ValueError, match="undeclared"):
        PipelineSpec(name="p", dag=[["x"]], stages={})
    with pytest.raises(ValueError, match="batch\\|service"):
        StageSpec(name="s", kind="cron", executable="m:f")


# -- the runner's contract -----------------------------------------------------

def _failing_stage(ctx, **kwargs):
    ctx.store.put_text(f"attempts/{time.monotonic_ns()}", "x")
    raise RuntimeError("boom")


def _permanent_stage(ctx, **kwargs):
    ctx.store.put_text(f"attempts/{time.monotonic_ns()}", "x")
    raise ValueError("bad config")


def _flaky_stage(ctx, **kwargs):
    n = int(ctx.store.get_text("flaky-count")) if ctx.store.exists("flaky-count") else 0
    ctx.store.put_text("flaky-count", str(n + 1))
    if n + 1 < 3:
        raise RuntimeError("flaky")
    return "ok"


def _slow_stage(ctx, **kwargs):
    time.sleep(5)


def _slow_writing_stage(ctx, **kwargs):
    """Writes once before its deadline and once long after it."""
    ctx.store.put_text("datasets/regression-dataset-2026-01-01.csv", "early")
    time.sleep(1.0)
    ctx.store.put_text("models/regressor-2026-01-01.npz", "late")


_BARRIER = threading.Barrier(2, timeout=10)


def _meeting_stage(ctx, fail: bool = False, **kwargs):
    """Passes only if its sibling in the same DAG step runs at the same time."""
    _BARRIER.wait()
    if fail:
        raise RuntimeError("sibling failed")
    return ctx.device.type


class _NeverHealthy:
    """A started service nothing answers for (the discard port); counts
    its stops in the store (the runner imports this module afresh, so
    module state would not be shared with the test)."""

    base_url = "http://127.0.0.1:9"

    def __init__(self, store):
        self.store = store

    def stop(self):
        self.store.put_text(f"stopped/{time.monotonic_ns()}", "x")


def _never_healthy_stage(ctx, **kwargs):
    return _NeverHealthy(ctx.store)


def _spec(*stages):
    return PipelineSpec(name="t", dag=[[s.name for s in stages]],
                        stages={s.name: s for s in stages})


def _batch(executable, name="s", **kwargs):
    return StageSpec(name=name, kind="batch", executable=f"{HERE}:{executable}", **kwargs)


def test_batch_stage_retries_then_fails(store):
    with pytest.raises(StageFailure, match="'s' failed"):
        LocalRunner(_spec(_batch("_failing_stage", retries=2)), store, device="cpu").run_day(START)
    assert len(store.list_keys("attempts/")) == 3


def test_batch_stage_retry_eventually_succeeds(store):
    result = LocalRunner(_spec(_batch("_flaky_stage", retries=2)), store,
                         device="cpu").run_day(START)
    assert result.stage_results["s"] == "ok"
    assert store.get_text("flaky-count") == "3"


def test_permanent_error_is_not_retried(store):
    with pytest.raises(StageFailure, match="bad config"):
        LocalRunner(_spec(_batch("_permanent_stage", retries=2)), store,
                    device="cpu").run_day(START)
    assert len(store.list_keys("attempts/")) == 1


def test_batch_stage_timeout_enforced(store):
    spec = _spec(_batch("_slow_stage", retries=0, max_completion_time_s=0.3))
    t0 = time.perf_counter()
    with pytest.raises(StageFailure, match="max_completion_time"):
        LocalRunner(spec, store, device="cpu").run_day(START)
    assert time.perf_counter() - t0 < 3


def test_timed_out_stage_late_write_never_lands(store):
    """The counterpart of the JAX package's ``tests/test_pipeline.py:574``:
    the abandoned attempt's epoch is revoked, so its late write raises in
    the zombie thread instead of landing."""
    spec = _spec(_batch("_slow_writing_stage", retries=0, max_completion_time_s=0.3))
    with pytest.raises(StageFailure, match="max_completion_time"):
        LocalRunner(spec, store, device="cpu").run_day(START)
    assert store.exists("datasets/regression-dataset-2026-01-01.csv")
    time.sleep(1.2)
    assert not store.exists("models/regressor-2026-01-01.npz")


def test_epoch_guard_semantics(store):
    guard = EpochGuardedStore(store, label="stage-x")
    guard.put_text("datasets/regression-dataset-2026-01-01.csv", "ok")
    guard.revoke()
    assert guard.revoked
    with pytest.raises(WriteEpochRevoked, match="stage-x"):
        guard.put_text("datasets/regression-dataset-2026-01-02.csv", "no")
    assert guard.get_text("datasets/regression-dataset-2026-01-01.csv") == "ok"
    assert guard.list_keys("datasets/") == ["datasets/regression-dataset-2026-01-01.csv"]
    assert guard.history("datasets/")[0][1] == date(2026, 1, 1)
    assert not store.exists("datasets/regression-dataset-2026-01-02.csv")


def test_stages_of_one_step_run_concurrently(store):
    spec = _spec(_batch("_meeting_stage", name="a"), _batch("_meeting_stage", name="b"))
    result = LocalRunner(spec, store, device="cpu").run_day(START)
    assert result.stage_results == {"a": "cpu", "b": "cpu"}
    failing = _spec(_batch("_meeting_stage", name="a", retries=0),
                    _batch("_meeting_stage", name="b", retries=0, args={"fail": True}))
    with pytest.raises(StageFailure, match="'b' failed"):
        LocalRunner(failing, store, device="cpu").run_day(START)


def test_service_that_never_gets_healthy_fails_its_stage(store):
    stage = StageSpec(name="svc", kind="service", executable=f"{HERE}:_never_healthy_stage",
                      retries=1, max_startup_time_s=0.2)
    with pytest.raises(StageFailure, match="not healthy within"):
        LocalRunner(_spec(stage), store, device="cpu").run_day(START)
    assert len(store.list_keys("stopped/")) == 2  # each attempt's server is stopped


# -- the stages, end to end ----------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read())


def test_run_day_end_to_end(store):
    runner = LocalRunner(default_pipeline("linear"), store, device="cpu")
    runner.bootstrap(START)
    result = runner.run_day(START)
    assert list(result.stage_seconds) == list(default_pipeline().stages)
    assert result.wall_clock_s >= sum(result.stage_seconds.values()) * 0.99
    train = result.stage_results["stage-1-train-model"]
    assert train.model_artefact_key == "models/regressor-2026-07-01.npz"
    handle = result.stage_results["stage-2-serve-model"]
    assert len(handle.replica_apps) == 2
    assert result.stage_results["stage-3-generate-next-dataset"] == (
        "datasets/regression-dataset-2026-07-02.csv")
    metrics = result.stage_results["stage-4-test-model-scoring-service"]
    assert metrics["n_failures"] == 0 and metrics["date"] == date(2026, 7, 2)
    assert store.exists("test-metrics/regressor-test-results-2026-07-02.csv")
    # the day's service was stopped at day end
    with pytest.raises(OSError):
        _get(handle.base_url + "/healthz")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_run_day_tests_the_service_over_http_in_single_mode(store):
    """With a scoring URL the test stage scores over HTTP, one row per
    request in single mode, against the serve stage's replicas."""
    spec = default_pipeline("linear", "single")
    port = _free_port()
    spec.stages["stage-2-serve-model"].args["port"] = port
    spec.stages["stage-4-test-model-scoring-service"].args["max_rows"] = 40
    runner = LocalRunner(spec, store, device="cpu")
    runner.bootstrap(START)
    result = runner.run_day(START, scoring_url=f"http://127.0.0.1:{port}")
    metrics = result.stage_results["stage-4-test-model-scoring-service"]
    assert metrics["n_scored"] == 40 and metrics["n_failures"] == 0
    assert metrics["mean_response_time"] > 0
    handle = result.stage_results["stage-2-serve-model"]
    assert handle.port == port and len(handle.replica_apps) == 2
    assert spec.stages["stage-2-serve-model"].args["buckets"] == [1]


def test_serve_stage_resolves_auto_to_torch_off_the_card(store):
    """The day's candidate must pass the registry gate (r² >= 0.2) to be
    served, so the MLP takes enough steps to fit."""
    runner = LocalRunner(default_pipeline("mlp"), store, device="cpu")
    spec = runner.spec.stages["stage-1-train-model"]
    spec.args.update(hidden=(8,), n_steps=200)
    runner.bootstrap(START)
    result = runner.run_day(START)
    assert result.stage_results["registry-gate"].promote
    handle = result.stage_results["stage-2-serve-model"]
    health = handle.app.healthz_payload()
    assert health["engine"] == "torch" and health["device"] == "cpu"
    assert health["model_info"] == "MLPRegressor(hidden=[8])"


# -- the test stage's client ---------------------------------------------------

class _CountingClient:
    def __init__(self):
        self.sizes = []

    def score(self, payload):
        xs = payload["X"]
        self.sizes.append(len(xs))
        return True, [0.5 * x for x in xs], 0.001


@pytest.mark.parametrize("batch_size,sizes", [(2048, [1440]), (512, [512, 512, 416]),
                                              (1440, [1440])])
def test_tester_batch_size(batch_size, sizes):
    """The default pipeline's 2048 sends a 1440-row day as one request."""
    X = np.linspace(1, 100, 1440, dtype=np.float32)
    client = _CountingClient()
    results = score_dataset(client, Dataset(X, 0.5 * X, START), mode="batch",
                            batch_size=batch_size)
    assert client.sizes == sizes
    assert results["ok"].all() and len(results["score"]) == 1440


class _FlakyApp:
    def __init__(self, failures):
        self.calls, self.failures = [], failures

    def handle(self, method, path, body=b"", content_type=None):
        self.calls.append(path)
        if len(self.calls) <= self.failures:
            return 503, {"Retry-After": "0"}, b'{"error": "busy"}'
        xs = json.loads(body)["X"]
        return 200, {}, json.dumps({"predictions": xs, "n": len(xs)}).encode()


def test_in_process_client_retries_and_gives_up():
    client = InProcessScoringClient(_FlakyApp(2)).batch_sibling()
    assert client.score({"X": [1.0, 2.0]})[:2] == (True, [1.0, 2.0])
    assert client.app.calls == ["/score/v1/batch"] * 3
    assert InProcessScoringClient(_FlakyApp(99)).score({"X": [1.0]})[:2] == (False, [])


def test_round_robin_front_alternates_replicas():
    apps = [_FlakyApp(0), _FlakyApp(0)]
    front = RoundRobinApp(apps)
    for _ in range(4):
        assert front.handle("POST", "/score/v1/batch", b'{"X": [1]}')[0] == 200
    assert [len(a.calls) for a in apps] == [2, 2]


# -- run-sim against the JAX package -------------------------------------------

def _csv_row(root, key) -> pd.Series:
    return pd.read_csv(root / key).iloc[0]


def _float64_theta(X, y) -> np.ndarray:
    """The float64 solution of the normal equations the train stage
    solves in float32 on ``X, y`` (all history): the same 80/20 split,
    the same padded rows."""
    s = jax_train_test_split(X, y)
    Xtr, ytr, wtr = JaxRegressor._pad_splits(s.X_train, s.y_train, s.X_test, s.y_test)[:3]
    A = np.concatenate([Xtr.astype(np.float64), np.ones((len(Xtr), 1))], axis=1)
    Aw = A * wtr[:, None]
    return np.linalg.solve(Aw.T @ A, Aw.T @ ytr.astype(np.float64))


def test_seven_day_linear_run_sim_matches_jax(tmp_path, monkeypatch):
    """The same dates and the same data (the JAX generator's days, since
    the port's generator draws other samples). The JAX run gates each
    day's candidate through its registry; it must have promoted every
    one, or it served another model.

    Coefficients: each day the port is within 1e-4 of the float64
    solution of the day's normal equations, and within 1e-4 of the JAX
    package's beyond the JAX package's own distance from that solution.
    The JAX package forms its Gram matrix as one long float32 dot
    product, which on some of these days moves the intercept by more
    than 1e-4 from float64; the port sums each entry as a reduction and
    stays closer. The metrics then agree as far as the predictions do."""
    days = 7
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    jax_results = JaxRunner(jax_default_pipeline("linear"), JaxStore(jax_root)).run_simulation(
        START, days)
    assert all(r.stage_results["registry-gate"].promote for r in jax_results)

    def jax_day(d, cfg=None, device=None):
        X, y = jax_generate_day(d)
        return np.asarray(X), np.asarray(y)

    monkeypatch.setattr(generator, "generate_day", jax_day)
    results = LocalRunner(default_pipeline("linear"), FilesystemStore(port_root),
                          device="cpu").run_simulation(START, days)
    assert [r.day for r in results] == [START + timedelta(days=i) for i in range(days)]
    X_grid = np.linspace(0, 100, 11, dtype=np.float32)[:, None]
    history = []
    for i in range(days + 1):
        d = START + timedelta(days=i)
        key = f"datasets/regression-dataset-{d}.csv"
        assert (port_root / key).read_bytes() == (jax_root / key).read_bytes()
        history.append(jax_day(d))
        if i == days:
            continue
        exact = _float64_theta(np.concatenate([h[0] for h in history])[:, None],
                               np.concatenate([h[1] for h in history]))
        model_key = f"models/regressor-{d}.npz"
        port_model = port_ckpt.load_model_bytes((port_root / model_key).read_bytes(), device="cpu")
        jax_model = jax_ckpt.load_model_bytes((jax_root / model_key).read_bytes())
        port = np.r_[port_model.params["w"].numpy(), float(port_model.params["b"])]
        ref = np.r_[np.asarray(jax_model.params["w"]), float(jax_model.params["b"])]
        np.testing.assert_allclose(port, exact, atol=1e-4)
        np.testing.assert_allclose(port, ref, atol=1e-4 + float(np.abs(ref - exact).max()))
        # predictions over X in [0, 100], and with them the metrics
        pred_gap = float(np.abs(port_model.predict(X_grid) - jax_model.predict(X_grid)).max())
        assert pred_gap < 1e-3, (d, pred_gap)
        got = _csv_row(port_root, f"model-metrics/regressor-{d}.csv")
        want = _csv_row(jax_root, f"model-metrics/regressor-{d}.csv")
        assert list(got.index) == list(want.index) and got["date"] == want["date"]
        np.testing.assert_allclose(got.iloc[1:].to_numpy(float), want.iloc[1:].to_numpy(float),
                                   rtol=1e-3)
        test_key = f"test-metrics/regressor-test-results-{d + timedelta(days=1)}.csv"
        got, want = _csv_row(port_root, test_key), _csv_row(jax_root, test_key)
        assert list(got.index) == list(want.index)
        assert got["n_failures"] == want["n_failures"] == 0
        assert got["n_scored"] == want["n_scored"]
        cols = ["MAPE", "r_squared", "max_residual", "error_std"]
        np.testing.assert_allclose(got[cols].to_numpy(float), want[cols].to_numpy(float),
                                   rtol=1e-3)
        # the mean error moves one for one with the predictions
        assert abs(got["mean_error"] - want["mean_error"]) < pred_gap + 1e-6


def test_mlp_run_sim_lands_in_the_reference_quality_band(tmp_path):
    """A short MLP loop at hidden (32, 32) through the command line: the
    last day's held-out r² and live-test MAPE land in the reference's
    band (MAPE ≈ 0.7-1.0, R² ≈ 0.6-0.7), and the JAX package reads every
    artefact it wrote."""
    root = tmp_path / "store"
    assert cli.main(["run-sim", "--store", str(root), "--days", "3", "--date", str(START),
                     "--model", "mlp", "--mlp-hidden", "32,32", "--mlp-steps", "500",
                     "--device", "cpu"]) == 0
    last = START + timedelta(days=2)
    train = _csv_row(root, f"model-metrics/regressor-{last}.csv")
    live = _csv_row(root, f"test-metrics/regressor-test-results-{last + timedelta(days=1)}.csv")
    assert 0.6 <= train["r_squared"] <= 0.7, train
    assert 0.7 <= live["MAPE"] <= 1.0 and live["n_failures"] == 0, live
    model, d = jax_ckpt.load_model(JaxStore(root))
    assert d == last and model.info == "MLPRegressor(hidden=[32, 32])"
    assert np.isfinite(model.predict(np.array([50.0], np.float32))).all()
    assert len(JaxStore(root).history("datasets/")) == 4
