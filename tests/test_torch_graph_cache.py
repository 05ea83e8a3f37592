"""The serving graph cache (``bodywork_tpu_torch.serve.predictor``) on the
CPU, where each entry runs the plain version eagerly over its static
buffers: the key's parts, one miss per bucket at warm-up, zero misses
across same-architecture checkpoints served in turn (each predictor
scoring with its own weights, the rebinds counted), a new architecture
missing, ``BODYWORK_TPU_AOT_CACHE=0``, eight threads across two
predictors sharing an entry, and the outputs against the JAX package's
``PaddedPredictor`` and ``PallasMLPPredictor`` (interpret mode) within
the f32 bar, 2e-4 (``tests/test_ops.py:42``)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import MLPRegressor as JaxMLPRegressor
from bodywork_tpu.serve.predictor import PaddedPredictor as JaxPaddedPredictor
from bodywork_tpu.serve.predictor import PallasMLPPredictor
from bodywork_tpu.serve.predictor import params_shape_digest as jax_digest
from bodywork_tpu_torch.models import LinearRegressor, MLPConfig, MLPRegressor, params_from_jax
from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
from bodywork_tpu_torch.serve import predictor as port
from bodywork_tpu_torch.serve.server import build_predictor

torch.set_num_threads(1)

HIDDEN = (16, 16)


def host_params(seed: int, hidden=HIDDEN, n_features: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    sizes = (n_features, *hidden, 1)
    return {
        "net": {"layers": [
            {"w": (rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
             "b": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])
        ]},
        "scaler": {"x_mean": rng.uniform(40, 60, n_features).astype(np.float32),
                   "x_std": rng.uniform(20, 30, n_features).astype(np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(14.0)},
    }


def port_mlp(seed: int, hidden=HIDDEN) -> MLPRegressor:
    return MLPRegressor(MLPConfig(hidden=hidden), params_from_jax(host_params(seed, hidden), "cpu"))


def X_of(rows: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 100, (rows, 1)).astype(np.float32)


@pytest.fixture
def cache(monkeypatch):
    """A fresh process cache for the test (the module global is patched)."""
    fresh = port.GraphCache()
    monkeypatch.setattr(port, "GRAPH_CACHE", fresh)
    monkeypatch.delenv(port.AOT_CACHE_ENV, raising=False)
    return fresh


def plain(predictor, X: np.ndarray) -> np.ndarray:
    """The predictor's model through its engine's plain function, on the
    batch padded to the bucket the predictor pads it to (row by row, the
    function of a row does not depend on its neighbours, but a CPU
    product's rounding may depend on the batch's shape)."""
    n = X.shape[0]
    Xp = np.zeros((predictor._bucket_for(n), X.shape[1]), np.float32)
    Xp[:n] = X
    with torch.no_grad():
        program = predictor._graph_runner(predictor._graph_weights())
        return program(torch.from_numpy(Xp)).numpy()[:n]


# -- the key -----------------------------------------------------------------

def test_digest_is_blind_to_values_and_sees_shapes_dtypes_devices():
    a, b = port_mlp(0).params, port_mlp(1).params
    assert port.params_shape_digest(a) == port.params_shape_digest(b)
    assert port.params_shape_digest(a) != port.params_shape_digest(port_mlp(0, (16, 8)).params)
    half = {**a, "scaler": {k: v.to(torch.float64) for k, v in a["scaler"].items()}}
    assert port.params_shape_digest(half) != port.params_shape_digest(a)
    digest = port.params_shape_digest(a)
    assert all(device == "cpu" for _shape, _dtype, device in digest)
    # the JAX digest's order: leaves in sorted-key tree order, one entry each
    jax_params = jax.tree_util.tree_map(jnp.asarray, host_params(0))
    assert [s for s, _d, _x in digest] == [s for s, _d, _x in jax_digest(jax_params)]


@pytest.mark.parametrize("engine", ["torch", "torch-bf16", "torch-int8", "kernel",
                                    "kernel-bf16", "kernel-int8"])
def test_key_parts(cache, engine):
    predictor = build_predictor(port_mlp(0), engine)
    predictor.predict(X_of(3))
    (key,) = cache._graphs
    cls, model_cls, dtype, digest, shape, device, extra = key
    assert cls == type(predictor).__name__ and model_cls == "MLPRegressor"
    assert dtype == predictor.dtype
    assert digest == port.params_shape_digest(predictor._graph_weights())
    assert shape == (predictor._bucket_for(3), 1) and device == "cpu" and extra == ()


def test_one_miss_per_bucket_at_warmup_then_none(cache):
    predictor = build_predictor(port_mlp(0), "kernel")
    predictor.warmup()
    assert cache.stats() == {"entries": 3, "hits": 0, "misses": 3, "rebinds": 0,
                             "captures": 0, "replays": 0}
    for rows in (1, 256, 257, 4096, 5000):
        predictor.predict(X_of(rows))
    assert cache.stats()["misses"] == 3 and cache.stats()["entries"] == 3


@pytest.mark.parametrize("engine", ["torch", "kernel", "torch-int8"])
def test_same_architecture_checkpoints_in_turn_never_miss(cache, engine):
    """The stale-weights guard: two checkpoints of one architecture share
    every entry; each predictor's answers are its own model's, turn after
    turn, and every switch of owner is one rebind."""
    old, new = port_mlp(0), port_mlp(1)
    p_old, p_new = build_predictor(old, engine), build_predictor(new, engine)
    p_old.warmup()
    misses = cache.stats()["misses"]
    p_new.warmup()
    assert cache.stats()["misses"] == misses
    assert cache.stats()["hits"] == len(p_new.buckets)
    assert cache.stats()["rebinds"] == 1
    X = X_of(40)
    for turn in range(3):
        for predictor in (p_old, p_new):
            np.testing.assert_array_equal(predictor.predict(X), plain(predictor, X))
    assert cache.stats()["misses"] == misses
    assert cache.stats()["rebinds"] == 1 + 6  # each turn hands the slot over twice
    assert not np.allclose(p_old.predict(X), p_new.predict(X))


def test_a_new_architecture_misses(cache):
    build_predictor(port_mlp(0), "kernel").warmup()
    build_predictor(port_mlp(2, (16, 8)), "kernel").warmup()
    assert cache.stats()["misses"] == 6 and cache.stats()["rebinds"] == 0
    # so does another engine or dtype over the same weights
    build_predictor(port_mlp(0), "kernel-int8").warmup()
    build_predictor(port_mlp(0), "torch").warmup()
    assert cache.stats()["misses"] == 6 + 3 + 5


def test_a_linear_model_dispatches_through_the_cache(cache):
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 100, 500).astype(np.float32)
    model = LinearRegressor().fit(X, 1.0 + 0.5 * X, device="cpu")
    predictor = build_predictor(model, "torch")
    predictor.warmup()
    assert cache.stats()["misses"] == 5
    np.testing.assert_array_equal(predictor.predict(X_of(9)), plain(predictor, X_of(9)))
    np.testing.assert_allclose(predictor.predict(X_of(9)), model.predict(X_of(9)), rtol=1e-6)


def test_cache_off_keeps_each_predictor_to_its_own_graphs(cache, monkeypatch):
    """BODYWORK_TPU_AOT_CACHE=0: no reuse across instances (each captures
    its own buckets, so nothing is rebound), per-instance handles still."""
    monkeypatch.setenv(port.AOT_CACHE_ENV, "0")
    a, b = build_predictor(port_mlp(0), "kernel"), build_predictor(port_mlp(1), "kernel")
    a.warmup()
    b.warmup()
    a.predict(X_of(5))
    assert cache.stats() == {"entries": 0, "hits": 0, "misses": 6, "rebinds": 0,
                             "captures": 0, "replays": 0}
    np.testing.assert_array_equal(a.predict(X_of(5)), plain(a, X_of(5)))
    np.testing.assert_array_equal(b.predict(X_of(5)), plain(b, X_of(5)))


def test_concurrent_predicts_across_two_predictors_sharing_an_entry(cache):
    """Eight threads, two same-architecture predictors, one shared slot:
    every result is its own model's."""
    models = [port_mlp(0), port_mlp(1)]
    predictors = [build_predictor(m, "kernel") for m in models]
    for p in predictors:
        p.warmup()
    assert predictors[0]._graphs[(256, 1)] is predictors[1]._graphs[(256, 1)]
    wants = {}
    for i in range(8):
        X = X_of(1 + 37 * i, seed=i)
        wants[i] = (X, plain(predictors[i % 2], X))
    errors = []
    start = threading.Barrier(8)

    def worker(i):
        try:
            X, want = wants[i]
            start.wait()
            for _ in range(25):
                np.testing.assert_array_equal(predictors[i % 2].predict(X), want)
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert cache.stats()["misses"] == 3
    assert cache.stats()["rebinds"] >= 1


def test_a_failed_build_is_not_cached_and_raises(cache):
    predictor = build_predictor(port_mlp(0), "torch")
    with pytest.raises(RuntimeError):
        predictor.predict(np.zeros((2, 3), np.float32))  # 3 features for a 1-feature model
    assert cache.stats()["entries"] == 0 and cache.stats()["misses"] == 0
    with pytest.raises(ValueError, match="expected 1 feature"):
        build_predictor(port_mlp(0), "kernel").predict(np.zeros((2, 3), np.float32))


def test_no_launch_is_counted_on_the_cpu(cache):
    before = dict(LAUNCHES)
    predictor = build_predictor(port_mlp(0), "kernel")
    predictor.warmup()
    predictor.predict(X_of(300))
    assert LAUNCHES == before and cache.stats()["replays"] == 0


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("rows", [1, 7, 300, 5000])
def test_torch_engine_within_the_f32_bar_of_jax_padded_predictor(cache, rows):
    host = host_params(4)
    jax_model = JaxMLPRegressor(JaxMLPConfig(hidden=HIDDEN),
                                jax.tree_util.tree_map(jnp.asarray, host))
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), params_from_jax(host, "cpu"))
    X = X_of(rows, seed=rows)
    want = JaxPaddedPredictor(jax_model).predict(X)
    got = build_predictor(model, "torch").predict(X)
    assert got.shape == want.shape == (rows,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rows", [1, 300, 5000])
def test_kernel_engine_within_the_f32_bar_of_jax_pallas_predictor(cache, rows):
    host = host_params(5)
    jax_model = JaxMLPRegressor(JaxMLPConfig(hidden=HIDDEN),
                                jax.tree_util.tree_map(jnp.asarray, host))
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), params_from_jax(host, "cpu"))
    X = X_of(rows, seed=rows)
    want = PallasMLPPredictor(jax_model, interpret=True).predict(X)
    predictor = build_predictor(model, "kernel")
    assert predictor.buckets == PallasMLPPredictor(jax_model, interpret=True).buckets
    got = predictor.predict(X)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # and the graph path is the kernel's own plain function, exactly
    np.testing.assert_array_equal(got[:256], plain(predictor, X[:256]))


def test_swapped_buckets_are_the_jax_buckets():
    assert port.DEFAULT_BUCKETS == JaxPaddedPredictor.__init__.__defaults__[0]
