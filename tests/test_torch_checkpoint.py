"""Checkpoints carry across both packages: the npz leaf paths and the
``__meta__`` JSON are one format, so a model saved by either package
loads and scores in the other."""
import io
import json
from datetime import date

import jax
import numpy as np
import pytest
import torch

from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.models.base import pad_rows as jax_pad_rows
from bodywork_tpu.models.linear import LinearRegressor
from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLPRegressor
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.models.base import pad_rows
from bodywork_tpu_torch.models.mlp import MLPNet, params_from_jax, params_to_host
from bodywork_tpu_torch.store import ArtefactNotFound, FilesystemStore

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 100, 512).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, 512)).astype(np.float32)
    return JaxMLPRegressor(JaxMLPConfig(hidden=(16, 16), n_steps=100)).fit(X, y)


@pytest.fixture
def X():
    return np.random.default_rng(3).uniform(0, 100, (64, 1)).astype(np.float32)


def _npz(data: bytes):
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def test_jax_checkpoint_loads_and_scores_in_the_port(jax_model, X):
    model = port_ckpt.load_model_bytes(jax_ckpt.save_model_bytes(jax_model), device="cpu")
    np.testing.assert_allclose(model.predict(X), jax_model.predict(X), rtol=2e-4, atol=2e-4)
    assert model.info == jax_model.info == "MLPRegressor(hidden=[16, 16])"
    assert model.n_features == jax_model.n_features == 1
    assert model.config.hidden == jax_model.config.hidden


def test_port_checkpoint_loads_and_scores_in_jax(jax_model, X):
    port_model = port_ckpt.load_model_bytes(jax_ckpt.save_model_bytes(jax_model), device="cpu")
    back = jax_ckpt.load_model_bytes(port_ckpt.save_model_bytes(port_model))
    np.testing.assert_allclose(back.predict(X), port_model.predict(X), rtol=2e-4, atol=2e-4)
    assert back.info == port_model.info


def test_npz_entries_and_meta_keys_are_the_same(jax_model):
    jax_bytes = jax_ckpt.save_model_bytes(jax_model)
    port_bytes = port_ckpt.save_model_bytes(port_ckpt.load_model_bytes(jax_bytes, device="cpu"))
    jax_npz, port_npz = _npz(jax_bytes), _npz(port_bytes)
    # same leaf paths, in the same (sorted pytree flatten) order
    assert list(port_npz) == list(jax_npz)
    for key in jax_npz:
        if key == "__meta__":
            continue
        assert port_npz[key].dtype == jax_npz[key].dtype
        np.testing.assert_array_equal(port_npz[key], jax_npz[key])
    jax_meta = json.loads(bytes(jax_npz["__meta__"]).decode())
    port_meta = json.loads(bytes(port_npz["__meta__"]).decode())
    assert list(port_meta) == list(jax_meta)
    assert port_meta["model_type"] == jax_meta["model_type"] == "mlp"
    assert port_meta["config"] == jax_meta["config"]


def test_params_from_jax_round_trip(jax_model):
    host = jax_model.host_params()
    params = params_from_jax(host, "cpu")
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(params))
    back = params_to_host(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(host)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_mlpnet_holds_weights_in_jax_layout(jax_model):
    """MLPNet's parameters keep the (in, out) layout, and its state-dict
    keys map one to one onto the checkpoint leaf paths."""
    host = jax_model.host_params()
    net = MLPNet(params_from_jax(host, "cpu")["net"]["layers"])
    leaf_paths = {
        "net/" + k.replace(".", "/") for k in net.state_dict()
    }
    npz_paths = {k for k in _npz(jax_ckpt.save_model_bytes(jax_model)) if k.startswith("net/")}
    assert leaf_paths == npz_paths
    for layer, jax_layer in zip(net.layers, host["net"]["layers"]):
        assert tuple(layer.w.shape) == np.shape(jax_layer["w"])
        assert isinstance(layer.w, torch.nn.Parameter) and not layer.w.requires_grad


def test_linear_checkpoint_names_the_later_slice():
    """The later slice has landed: a linear checkpoint loads and scores,
    and a model type neither package knows is refused by name."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 100, 64).astype(np.float32)
    linear = LinearRegressor().fit(X, 0.5 * X + 1.0)
    model = port_ckpt.load_model_bytes(jax_ckpt.save_model_bytes(linear), device="cpu")
    assert model.info == linear.info
    np.testing.assert_allclose(model.predict(X), linear.predict(X), rtol=1e-6, atol=1e-5)
    buf = io.BytesIO()
    meta = json.dumps({"model_type": "forest", "config": {}}).encode()
    np.savez(buf, w=np.zeros(1, np.float32), __meta__=np.frombuffer(meta, dtype=np.uint8))
    with pytest.raises(ValueError, match="'forest'"):
        port_ckpt.load_model_bytes(buf.getvalue(), device="cpu")


def test_store_round_trip_across_packages(tmp_path, jax_model, X):
    """The port saves into a store directory; the JAX package resolves
    and loads it from the same directory, and vice versa."""
    root = tmp_path / "store"
    jax_ckpt.save_model(JaxStore(root), jax_model, date(2026, 7, 1))
    port_store = FilesystemStore(root)
    model, d = port_ckpt.load_model(port_store, device="cpu")
    assert d == date(2026, 7, 1)
    key = port_ckpt.save_model(port_store, model, date(2026, 7, 2))
    assert key == "models/regressor-2026-07-02.npz"
    back, d2 = jax_ckpt.load_model(JaxStore(root))
    assert d2 == date(2026, 7, 2)
    np.testing.assert_allclose(back.predict(X), jax_model.predict(X), rtol=2e-4, atol=2e-4)


def test_resolve_serving_key_is_the_registry_less_path(tmp_path, jax_model):
    store = FilesystemStore(tmp_path / "s")
    with pytest.raises(ArtefactNotFound):
        port_ckpt.resolve_serving_key(store)
    for day in (1, 3, 2):
        store.put_bytes(f"models/regressor-2026-07-0{day}.npz", jax_ckpt.save_model_bytes(jax_model))
    assert port_ckpt.resolve_serving_key(store) == ("models/regressor-2026-07-03.npz", "latest")
    assert port_ckpt.resolve_serving_key(store) == jax_ckpt.resolve_serving_key(JaxStore(tmp_path / "s"))


@pytest.mark.parametrize("registry_key", [
    "registry/aliases.json",
    "registry/records/regressor-2026-07-01.json",
])
def test_resolve_serving_key_refuses_a_gated_store(tmp_path, jax_model, registry_key):
    """A store with registry state must never be served past the gate:
    the port resolves it as the JAX package does. An unreadable alias
    document raises in both (it must not fall back to the ungated latest
    checkpoint); an unreadable record reads as absent in both."""
    store = FilesystemStore(tmp_path / "s")
    store.put_bytes("models/regressor-2026-07-01.npz", jax_ckpt.save_model_bytes(jax_model))
    store.put_text(registry_key, "{}")

    def outcome(resolve, s):
        try:
            return resolve(s)
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            return type(exc).__name__

    got = outcome(port_ckpt.resolve_serving_key, store)
    want = outcome(jax_ckpt.resolve_serving_key, JaxStore(tmp_path / "s"))
    assert got == want
    if registry_key == "registry/aliases.json":
        assert got == "RegistryCorrupt"


@pytest.mark.parametrize("rows,minimum", [(5, 1024), (1024, 1024), (1500, 1024), (300, 256)])
def test_pad_rows_matches_jax(rows, minimum):
    """The bucket padding the training slice will use: identical arrays."""
    rng = np.random.default_rng(rows)
    X = rng.normal(size=(rows, 2)).astype(np.float32)
    y = rng.normal(size=rows).astype(np.float32)
    for got, want in zip(pad_rows(X, y, minimum), jax_pad_rows(X, y, minimum)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
