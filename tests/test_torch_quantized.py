"""The quantized serving dtypes: the port's ``torch-bf16`` / ``torch-int8``
engines, ``quantized_engine_for`` and the shadow quantization gate
``build_serving_predictor`` against the JAX package's ``xla-bf16`` /
``xla-int8``, ``quantized_engine_for`` and gate on the same checkpoint and
store.

Bars: int8 qparams bit-equal to ``models.fused.quantize_mlp_params_int8``;
``torch-int8`` within 2e-2 of scale of ``int8_mlp_apply``
(``tests/test_compiled.py:398``) and ``torch-bf16`` within rtol 2e-2 of
JAX's bf16 apply (``tests/test_ops.py:55``), with the tighter agreement
reached pinned too; every gate outcome and ``served_dtype`` JAX's."""
import logging
import os
import re
from datetime import date
from unittest.mock import patch

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.models import fused as jax_fused
from bodywork_tpu.models.checkpoint import save_model_bytes
from bodywork_tpu.models.mlp import mlp_apply as jax_mlp_apply
from bodywork_tpu.obs import get_registry
from bodywork_tpu.serve import server as jax_server
from bodywork_tpu.serve.predictor import SERVE_DTYPES as JAX_SERVE_DTYPES
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.train import train_on_history as jax_train
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.models import LinearConfig, LinearRegressor, fused, params_from_jax
from bodywork_tpu_torch.models.checkpoint import load_model_bytes
from bodywork_tpu_torch.models.mlp import mlp_apply
from bodywork_tpu_torch.pipeline import stages
from bodywork_tpu_torch.serve import (
    ENGINE_NAMES,
    SERVE_DTYPES,
    BF16MLPPredictor,
    Int8MLPPredictor,
    KernelMLPPredictor,
    PaddedPredictor,
    build_serving_predictor,
    quantized_engine_for,
)
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

DAY = date(2026, 3, 1)
#: the JAX package's bars: int8 at 2e-2 of scale, bf16 at rtol 2e-2
INT8_BAR = 2e-2
BF16_RTOL = 2e-2
#: what the port reaches against JAX on the test stacks below, on the CPU:
#: int8 shares the quantized weights bit for bit and differs by f32
#: summation order (measured: 2.1e-6 of scale); bf16 rounds where JAX's
#: program rounds (measured: bit-identical)
INT8_REACHED = 5e-6
BF16_REACHED = 1e-6
GATE_COUNTER = "bodywork_tpu_serve_quantization_gate_total"


def _host_params(sizes=(3, 64, 32, 1), seed=0):
    rng = np.random.default_rng(seed)
    return {
        "net": {"layers": [
            {"w": (rng.normal(size=(i, o)) * np.sqrt(2 / i)).astype(np.float32),
             "b": rng.normal(0, 0.1, size=o).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])
        ]},
        "scaler": {"x_mean": np.array([50.0, 1.0, -2.0], np.float32),
                   "x_std": np.array([29.0, 2.0, 0.5], np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(15.0)},
    }


def _X(n=300, seed=1):
    return np.random.default_rng(seed).uniform(0, 100, (n, 3)).astype(np.float32)


def test_int8_qparams_are_jaxs_bit_for_bit():
    host = _host_params()
    got = fused.quantize_mlp_params_int8(params_from_jax(host))
    want = jax_fused.quantize_mlp_params_int8(host)
    for g, w in zip(got["net"]["layers"], want["net"]["layers"]):
        assert g["wq"].dtype == torch.int8 and g["w_scale"].dtype == torch.float32
        np.testing.assert_array_equal(g["wq"].numpy(), w["wq"])
        np.testing.assert_array_equal(g["w_scale"].numpy().view(np.int32),
                                      w["w_scale"].view(np.int32))
        np.testing.assert_array_equal(g["b"].numpy(), w["b"])
    for k, v in want["scaler"].items():
        np.testing.assert_array_equal(got["scaler"][k].numpy(), v)
    back = fused.dequantize_mlp_params(got)
    want_back = jax_fused.dequantize_mlp_params(want)
    for g, w in zip(back["net"]["layers"], want_back["net"]["layers"]):
        np.testing.assert_array_equal(g["w"].numpy(), w["w"])


def test_quantize_int8_is_the_one_the_kernel_uses():
    from bodywork_tpu_torch.ops import mlp_kernel

    assert mlp_kernel.quantize_int8 is fused.quantize_int8
    w = np.random.default_rng(2).normal(size=(5, 7)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1
    for g, ref in zip(fused.quantize_int8(w), jax_fused.quantize_int8(w)):
        np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_apply_is_jaxs(seed):
    host = _host_params(seed=seed)
    X = _X(seed=seed)
    got = fused.int8_mlp_apply(fused.quantize_mlp_params_int8(params_from_jax(host)),
                               torch.from_numpy(X)).numpy()
    want = np.asarray(jax_fused.int8_mlp_apply(jax_fused.quantize_mlp_params_int8(host),
                                               jnp.asarray(X)))
    err = float(np.max(np.abs(got - want))) / max(1.0, float(np.max(np.abs(want))))
    assert err < INT8_BAR
    assert err < INT8_REACHED, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_apply_is_jaxs(seed):
    host = _host_params(seed=seed)
    X = _X(seed=seed)
    got = mlp_apply(params_from_jax(host), torch.from_numpy(X), compute_dtype="bfloat16").numpy()
    want = np.asarray(jax_mlp_apply(host, jnp.asarray(X), compute_dtype="bfloat16"))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL)
    np.testing.assert_allclose(got, want, rtol=BF16_REACHED, atol=BF16_REACHED)
    # and bf16 is not f32 in disguise: the f32 apply differs from both
    f32 = np.asarray(jax_mlp_apply(host, jnp.asarray(X)))
    assert not np.allclose(got, f32, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["torch", "kernel"])
@pytest.mark.parametrize("dtype", SERVE_DTYPES)
def test_quantized_engine_for_is_jaxs_under_the_name_map(engine, dtype):
    jax_engine = {v: k for k, v in ENGINE_NAMES.items()}[engine]
    assert quantized_engine_for(engine, dtype) == ENGINE_NAMES[
        jax_server.quantized_engine_for(jax_engine, dtype)]


@pytest.mark.parametrize("jax_engine", sorted(ENGINE_NAMES))
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float64"])
def test_explicit_engines_and_bad_dtypes_refuse_as_in_jax(jax_engine, dtype):
    """An explicit quantized engine with a contradicting dtype, or an
    unknown dtype, raises in both; an agreeing one passes through."""
    try:
        want = ENGINE_NAMES[jax_server.quantized_engine_for(jax_engine, dtype)]
    except ValueError:
        with pytest.raises(ValueError):
            quantized_engine_for(ENGINE_NAMES[jax_engine], dtype)
    else:
        assert quantized_engine_for(ENGINE_NAMES[jax_engine], dtype) == want


def test_serve_dtypes_and_cli_choices_are_jaxs(monkeypatch):
    from bodywork_tpu.cli import build_parser as jax_parser
    from bodywork_tpu.pipeline.stages import _serve_env_knobs

    def dtype_action(parser):
        sub = next(a for a in parser._subparsers._group_actions)
        return next(a for a in sub.choices["serve"]._actions if a.dest == "dtype")

    assert SERVE_DTYPES == JAX_SERVE_DTYPES == cli.SERVE_DTYPES
    assert tuple(dtype_action(cli.build_parser()).choices) == SERVE_DTYPES
    for raw in ("int8", "bfloat16", "float32", "fp4", ""):
        with patch.dict(os.environ, {"BODYWORK_TPU_SERVE_DTYPE": raw}):
            assert stages._serve_env_dtype() == _serve_env_knobs()[3], raw
            assert dtype_action(cli.build_parser()).default == dtype_action(jax_parser()).default
    monkeypatch.delenv("BODYWORK_TPU_SERVE_DTYPE", raising=False)
    assert stages._serve_env_dtype() == "float32"


# -- the shadow quantization gate ---------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One JAX-generated day and a small JAX-trained MLP checkpoint (the
    JAX gate tests' ``seeded_store``), readable by both packages."""
    root = tmp_path_factory.mktemp("quantized") / "store"
    store = JaxStore(root)
    X, y = jax_generate_day(DAY)
    jax_persist_dataset(store, JaxDataset(np.asarray(X), np.asarray(y), DAY))
    result = jax_train(store, "mlp", model_kwargs={"hidden": [8, 8], "n_steps": 60})
    port_model = load_model_bytes(save_model_bytes(result.model), device="cpu")
    return {"root": root, "jax_store": store, "port_store": FilesystemStore(root),
            "jax_model": result.model, "port_model": port_model}


def _port_outcome(caplog) -> str:
    found = re.findall(r"quantization gate outcome=(\w+)", caplog.text)
    assert len(found) == 1, caplog.text
    return found[0]


def _jax_outcome(fn, dtype):
    counter = get_registry().counter(GATE_COUNTER)
    outcomes = ("served", "rejected_quality", "no_shadow_data", "unsupported_model")
    before = {o: counter.value(dtype=dtype, outcome=o) for o in outcomes}
    result = fn()
    moved = [o for o in outcomes if counter.value(dtype=dtype, outcome=o) > before[o]]
    assert len(moved) == 1, moved
    return result, moved[0]


def _gate_both(caplog, jax_store, port_store, jax_model, port_model, dtype, engine="torch"):
    caplog.clear()
    caplog.set_level(logging.INFO, logger="bodywork_tpu_torch")
    predictor, served = build_serving_predictor(port_store, port_model, engine,
                                                buckets=(1, 8), dtype=dtype)
    jax_engine = {v: k for k, v in ENGINE_NAMES.items()}[engine]
    (jax_predictor, jax_served), jax_outcome = _jax_outcome(
        lambda: jax_server.build_serving_predictor(jax_store, jax_model, None, jax_engine,
                                                   buckets=(1, 8), dtype=dtype), dtype)
    return predictor, served, _port_outcome(caplog), jax_served, jax_outcome


@pytest.mark.parametrize("engine,dtype,cls", [
    ("torch", "int8", Int8MLPPredictor), ("torch", "bfloat16", BF16MLPPredictor),
    ("kernel", "int8", KernelMLPPredictor), ("kernel", "bfloat16", KernelMLPPredictor),
])
def test_gate_serves_an_admitted_dtype_as_jax_does(world, caplog, engine, dtype, cls):
    predictor, served, outcome, jax_served, jax_outcome = _gate_both(
        caplog, world["jax_store"], world["port_store"], world["jax_model"],
        world["port_model"], dtype, engine)
    assert (served, outcome) == (jax_served, jax_outcome) == (dtype, "served")
    assert isinstance(predictor, cls) and predictor.dtype == dtype
    assert predictor.engine == quantized_engine_for(engine, dtype)


def test_gate_rejects_a_wrecked_int8_variant_as_jax_does(world, caplog, monkeypatch):
    """Sabotaged quantization (every column's scale x40): both gates keep
    f32 serving."""

    def wrecked(real):
        def quantize(params):
            q = real(params)
            for layer in q["net"]["layers"]:
                layer["w_scale"] = layer["w_scale"] * 40.0
            return q
        return quantize

    monkeypatch.setattr(fused, "quantize_mlp_params_int8", wrecked(fused.quantize_mlp_params_int8))
    monkeypatch.setattr(jax_fused, "quantize_mlp_params_int8",
                        wrecked(jax_fused.quantize_mlp_params_int8))
    predictor, served, outcome, jax_served, jax_outcome = _gate_both(
        caplog, world["jax_store"], world["port_store"], world["jax_model"],
        world["port_model"], "int8")
    assert (served, outcome) == (jax_served, jax_outcome) == ("float32", "rejected_quality")
    assert type(predictor) is PaddedPredictor and predictor.dtype == "float32"


def test_gate_without_shadow_data_keeps_f32_as_jax_does(world, caplog, tmp_path):
    jax_store, port_store = JaxStore(tmp_path / "jax"), FilesystemStore(tmp_path / "port")
    _p, served, outcome, jax_served, jax_outcome = _gate_both(
        caplog, jax_store, port_store, world["jax_model"], world["port_model"], "bfloat16")
    assert (served, outcome) == (jax_served, jax_outcome) == ("float32", "no_shadow_data")


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_gate_keeps_f32_for_a_linear_model_as_jax_does(world, caplog, dtype):
    from bodywork_tpu.models import LinearRegressor as JaxLinear

    rng = np.random.default_rng(4)
    X = rng.uniform(0, 100, 200).astype(np.float32)
    y = (1.0 + 0.5 * X).astype(np.float32)
    jax_linear = JaxLinear().fit(X, y)
    port_linear = LinearRegressor(LinearConfig()).fit(X, y, device="cpu")
    predictor, served, outcome, jax_served, jax_outcome = _gate_both(
        caplog, world["jax_store"], world["port_store"], jax_linear, port_linear, dtype)
    assert (served, outcome) == (jax_served, jax_outcome) == ("float32", "unsupported_model")
    assert type(predictor) is PaddedPredictor


def test_float32_builds_the_engine_without_a_gate(world, caplog):
    caplog.set_level(logging.INFO, logger="bodywork_tpu_torch")
    predictor, served = build_serving_predictor(None, world["port_model"], "torch")
    assert served == "float32" and type(predictor) is PaddedPredictor
    assert "quantization gate" not in caplog.text


# -- the serve stage's knob and /healthz -----------------------------------------


@pytest.mark.parametrize("raw,dtype", [("int8", "int8"), ("bfloat16", "bfloat16"),
                                       ("fp4", "float32"), ("", "float32")])
def test_serve_stage_knob_and_healthz_serving_dtype(world, monkeypatch, raw, dtype):
    """``BODYWORK_TPU_SERVE_DTYPE`` drives the serve stage through the
    gate; /healthz over HTTP reports what serves, and a malformed value
    is ignored."""
    import json
    import urllib.request

    monkeypatch.setenv("BODYWORK_TPU_SERVE_DTYPE", raw)
    ctx = stages.StageContext(store=world["port_store"], today=DAY, device=torch.device("cpu"))
    handle = stages.serve_stage(ctx, buckets=[1, 8], engine="torch")
    try:
        with urllib.request.urlopen(handle.base_url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        body = json.dumps({"X": 50.0}).encode()
        request = urllib.request.Request(handle.url, data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=30) as resp:
            prediction = json.loads(resp.read())["prediction"]
    finally:
        handle.stop()
    assert health["serving_dtype"] == dtype
    assert health["engine"] == quantized_engine_for("torch", dtype)
    want = float(world["jax_model"].predict(np.array([50.0], np.float32))[0])
    assert abs(prediction - want) <= INT8_BAR * max(1.0, abs(want))


def test_serve_model_refuses_a_quantized_dtype_without_a_store(world):
    from bodywork_tpu_torch.serve import serve_model

    with pytest.raises(ValueError, match="store"):
        serve_model(world["port_model"], dtype="int8", block=False, port=0)
