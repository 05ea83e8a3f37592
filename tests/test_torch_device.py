"""Entry points run on the card unless the caller asks for the CPU: with
no CUDA device they refuse rather than fall back."""
import subprocess
import sys
from datetime import date
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
from bodywork_tpu_torch.device import (
    fence,
    matmul_precision,
    require_ieee_f32_matmul,
    resolve_device,
)
from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, params_from_jax, save_model
from bodywork_tpu_torch.serve import serve_latest_model
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path cannot run")


@pytest.fixture
def served_store(tmp_path):
    """A store holding one day and a small MLP checkpoint."""
    store = FilesystemStore(tmp_path / "store")
    d = date(2026, 7, 1)
    X, y = generate_day(d, device="cpu")
    persist_dataset(store, Dataset(X, y, d))
    rng = np.random.default_rng(0)
    host = {
        "net": {"layers": [
            {"w": rng.normal(size=(1, 8)).astype(np.float32), "b": np.zeros(8, np.float32)},
            {"w": rng.normal(size=(8, 1)).astype(np.float32), "b": np.zeros(1, np.float32)},
        ]},
        "scaler": {"x_mean": np.array([50.0], np.float32), "x_std": np.array([29.0], np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(15.0)},
    }
    save_model(store, MLPRegressor(MLPConfig(hidden=(8,)), params_from_jax(host, "cpu")), d)
    return store


def test_default_device_is_cuda_and_refuses_without_one(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_cpu_only_when_asked_for():
    # resolving a device changes no process-wide precision setting: the
    # port states its f32 precision and refuses TF32 where it would
    # matter (require_ieee_f32_matmul) instead of switching it off
    before = matmul_precision(), torch.backends.cudnn.allow_tf32
    assert resolve_device("cpu") == torch.device("cpu")
    assert (matmul_precision(), torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_reduced_precision_f32_products_are_refused_on_the_card_only():
    require_ieee_f32_matmul(torch.device("cpu"))
    require_ieee_f32_matmul(torch.device("cuda", 0))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert matmul_precision()["float32_matmul_precision"] == "high"
        with pytest.raises(RuntimeError, match="IEEE float32"):
            require_ieee_f32_matmul(torch.device("cuda", 0))
        require_ieee_f32_matmul(torch.device("cpu"))
    finally:
        torch.set_float32_matmul_precision(before)


def test_fence_passes_cpu_results_through():
    t = torch.ones(3)
    assert fence(t) is t
    assert fence({"a": [t]})["a"][0] is t


def test_serve_refuses_to_fall_back_to_the_cpu(no_cuda, served_store):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_latest_model(served_store, port=0, block=False)
    handle = serve_latest_model(served_store, host="127.0.0.1", port=0, block=False,
                                device="cpu")
    try:
        assert handle.app.healthz_payload()["device"] == "cpu"
    finally:
        handle.stop()


def test_generate_refuses_without_a_card_unless_asked(no_cuda, tmp_path, capsys):
    store = tmp_path / "s"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--store", str(store), "--date", "2026-07-01"])
    assert cli.main(["generate", "--store", str(store), "--date", "2026-07-01",
                     "--days", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split() == [
        "datasets/regression-dataset-2026-07-01.csv",
        "datasets/regression-dataset-2026-07-02.csv",
    ]


def test_cli_serve_without_device_cpu_exits_non_zero(no_cuda, served_store):
    proc = subprocess.run(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "serve", "--store",
         str(served_store.root), "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
