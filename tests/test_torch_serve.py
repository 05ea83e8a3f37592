"""The slice as a whole: a store written by the JAX package (a trained
(16, 16) MLP and one generated day) served by the port over real HTTP
through the kernel engine (its plain version, on the CPU), held against
the JAX app serving the same model through the Pallas kernel in
interpret mode; then the port's test stage over HTTP against the JAX test
stage through its in-process client."""
import json
import urllib.error
import urllib.request
from datetime import date

import numpy as np
import pandas as pd
import pytest
import torch

from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.models.checkpoint import save_model as jax_save_model
from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLPRegressor
from bodywork_tpu.monitor.tester import InProcessScoringClient
from bodywork_tpu.monitor.tester import run_service_test as jax_run_service_test
from bodywork_tpu.serve import create_app
from bodywork_tpu.serve.predictor import PallasMLPPredictor
from bodywork_tpu.serve.server import quantized_engine_for
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, params_from_jax
from bodywork_tpu_torch.monitor import HttpScoringClient, run_service_test, scoring_endpoint
from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
from bodywork_tpu_torch.serve import (
    ENGINE_NAMES,
    KernelMLPPredictor,
    PaddedPredictor,
    build_predictor,
    resolve_engine,
    serve_latest_model,
)
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

DAY = date(2026, 7, 1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX trains and checkpoints the model and persists the day; the
    port serves the store; the JAX app serves the same model in-process."""
    root = tmp_path_factory.mktemp("slice") / "store"
    store = JaxStore(root)
    X, y = jax_generate_day(DAY)
    jax_persist_dataset(store, JaxDataset(X, y, DAY))
    model = JaxMLPRegressor(JaxMLPConfig(hidden=(16, 16), n_steps=200)).fit(X, y)
    key = jax_save_model(store, model, DAY)
    jax_app = create_app(
        model, DAY, predictor=PallasMLPPredictor(model, interpret=True),
        model_key=key, model_source="latest",
    )
    handle = serve_latest_model(root, host="127.0.0.1", port=0, block=False,
                                engine="kernel", device="cpu")
    yield {"root": root, "store": store, "model": model, "jax": jax_app.test_client(),
           "jax_app": jax_app, "handle": handle}
    handle.stop()


def _http(url, body: bytes | None = None, content_type="application/json"):
    request = urllib.request.Request(
        url, data=body, method="POST" if body is not None else "GET",
        headers={"Content-Type": content_type} if body is not None else {},
    )
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _compare(port_body: bytes, jax_body: bytes, key: str):
    port, ref = json.loads(port_body), json.loads(jax_body)
    assert list(port) == list(ref)
    for k in ref:
        if k != key:
            assert port[k] == ref[k]
    np.testing.assert_allclose(port[key], ref[key], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("x", [50, 0.5, 99.9, [42.0]])
def test_single_score_matches_the_jax_app(world, x):
    status, body = _http(world["handle"].url, json.dumps({"X": x}).encode())
    ref = world["jax"].post("/score/v1", json={"X": x})
    assert status == ref.status_code == 200
    _compare(body, ref.data, "prediction")


@pytest.mark.parametrize("rows", [1, 3, 300, 5000])
def test_batch_score_matches_the_jax_app(world, rows):
    X = np.linspace(0, 100, rows).round(3).tolist()
    status, body = _http(world["handle"].url + "/batch", json.dumps({"X": X}).encode())
    ref = world["jax"].post("/score/v1/batch", json={"X": X})
    assert status == ref.status_code == 200
    _compare(body, ref.data, "predictions")
    assert json.loads(body)["n"] == rows


@pytest.mark.parametrize("path,body", [
    ("/score/v1", b"{}"),
    ("/score/v1", b'{"X": []}'),
    ("/score/v1", b'{"X": "fifty"}'),
    ("/score/v1", b'{"X": [1.0, NaN]}'),
    ("/score/v1/batch", b"not json"),
    ("/score/v2", b'{"X": 1}'),
])
def test_error_answers_are_byte_identical(world, path, body):
    status, got = _http(world["handle"].base_url + path, body)
    ref = world["jax"].post(path, data=body, content_type="application/json")
    assert status == ref.status_code and status in (400, 404)
    assert got == ref.data


def test_wrong_method_is_405_like_the_jax_app(world):
    status, got = _http(world["handle"].url)
    ref = world["jax"].get("/score/v1")
    assert status == ref.status_code == 405
    assert got == ref.data


def test_healthz_carries_the_identity_and_the_engine(world):
    status, body = _http(world["handle"].base_url + "/healthz")
    port = json.loads(body)
    ref = world["jax"].get("/healthz").get_json()
    assert status == 200
    for key in ("status", "model_info", "model_date", "model_key", "model_source",
                "serving_dtype"):
        assert port[key] == ref[key]
    assert port["engine"] == "kernel" and port["device"] == "cpu"
    assert port["launches"] == LAUNCHES["kernel"]


@pytest.mark.parametrize("mode", ["single", "batch"])
def test_test_stage_matches_the_jax_test_stage(world, mode):
    """The port's run_service_test over HTTP vs the JAX one through its
    in-process client, on the first 64 rows of the day: every metric but
    the response time agrees (2e-4 relative; counts exact), and the
    persisted CSV has the JAX package's columns."""
    client = HttpScoringClient(scoring_endpoint(world["handle"].url, mode))
    port = run_service_test(FilesystemStore(world["root"]), client, mode=mode, max_rows=64)
    ref = jax_run_service_test(
        world["store"], InProcessScoringClient(world["jax_app"]), mode=mode, max_rows=64,
    ).iloc[0]
    assert port["date"] == ref["date"] == DAY
    assert port["n_scored"] == ref["n_scored"] == 64
    assert port["n_failures"] == ref["n_failures"] == 0
    for k in ("MAPE", "r_squared", "max_residual", "mean_error", "error_std"):
        np.testing.assert_allclose(port[k], ref[k], rtol=2e-4, atol=1e-6)
    run_service_test(FilesystemStore(world["root"]), client, mode=mode, max_rows=64)
    frame = pd.read_csv(world["root"] / "test-metrics" / f"regressor-test-results-{DAY}.csv")
    assert list(frame.columns) == list(port) and len(frame) == 1
    np.testing.assert_allclose(frame["MAPE"][0], port["MAPE"], rtol=1e-15)


def test_engine_names_map_one_to_one_onto_the_jax_engines():
    """The JAX engine table (serve/server.py:179-184, through
    quantized_engine_for) maps one to one onto the port's names."""
    jax_engines = {"xla", "pallas"} | {
        quantized_engine_for(e, d) for e in ("xla", "pallas") for d in ("bfloat16", "int8")
    }
    assert set(ENGINE_NAMES) == jax_engines
    assert ENGINE_NAMES == {
        "xla": "torch", "xla-bf16": "torch-bf16", "xla-int8": "torch-int8",
        "pallas": "kernel", "pallas-bf16": "kernel-bf16", "pallas-int8": "kernel-int8",
    }
    assert set(cli.SERVE_ENGINES) == {"auto", "torch", "kernel", "kernel-bf16", "kernel-int8"}


def _port_model(hidden, device="cpu"):
    rng = np.random.default_rng(0)
    sizes = (1, *hidden, 1)
    host = {
        "net": {"layers": [
            {"w": rng.normal(size=(i, o)).astype(np.float32) * np.sqrt(2 / i),
             "b": np.zeros(o, np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])
        ]},
        "scaler": {"x_mean": np.array([50.0], np.float32), "x_std": np.array([29.0], np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(15.0)},
    }
    return MLPRegressor(MLPConfig(hidden=hidden), params_from_jax(host, device))


def test_auto_engine_resolution():
    """auto: the kernel for an MLP whose hidden widths are all >= 256 on
    CUDA, the plain torch engine otherwise — and always on the CPU. On
    CUDA the kernel must also be able to launch the model, asked of the
    card (here an H100's 132 SMs, 232448-byte budget and occupancy)."""
    wide, narrow = _port_model((256, 512)), _port_model((16, 16))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    h100 = {"n_sms": 132, "smem_budget": 232_448, "max_active": lambda c, smem: 132 // c}
    assert resolve_engine("auto", wide, cpu) == "torch"
    assert resolve_engine("auto", wide, cuda, **h100) == "kernel"
    assert resolve_engine("auto", narrow, cuda, **h100) == "torch"
    assert resolve_engine("kernel-int8", narrow, cpu) == "kernel-int8"
    assert isinstance(build_predictor(wide, "auto"), PaddedPredictor)
    assert not isinstance(build_predictor(wide, "auto"), KernelMLPPredictor)


@pytest.mark.parametrize("engine,dtype", [
    ("kernel", "float32"), ("kernel-bf16", "bfloat16"), ("kernel-int8", "int8"),
])
def test_kernel_engines_keep_the_pallas_bucket_policy(world, engine, dtype):
    predictor = build_predictor(_port_model((16, 16)), engine)
    jax_predictor = PallasMLPPredictor(world["model"], interpret=True)
    assert predictor.buckets == jax_predictor.buckets == (256, 512, 4096)
    assert predictor.engine == engine and predictor.dtype == dtype


@pytest.mark.parametrize("engine", ["torch-bf16", "torch-int8"])
def test_unported_quantized_plain_engines_name_the_roadmap_item(engine):
    with pytest.raises(ValueError, match="ROADMAP"):
        build_predictor(_port_model((16, 16)), engine)


def test_padded_predictor_chunks_through_the_largest_bucket():
    model = _port_model((16, 16))
    X = np.linspace(0, 100, 21, dtype=np.float32)
    np.testing.assert_allclose(
        PaddedPredictor(model, (1, 8)).predict(X), model.predict(X), rtol=1e-6, atol=1e-6,
    )


def test_cli_test_stage_against_the_running_port_service(world, capsys):
    rc = cli.main(["test", "--store", str(world["root"]), "--scoring-url",
                   world["handle"].base_url, "--mode", "batch", "--max-rows", "32"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_scored"] == 32 and out["n_failures"] == 0
