"""The port's device mesh (``bodywork_tpu_torch.parallel``) against the JAX
package's ``tests/test_parallel.py`` cases: mesh shapes and errors,
data-parallel scoring byte-equal to single-device, buckets rounded to the
data axis, the sharding specs, the sharded fit on a 2x2 mesh against
JAX's, staging independent of the step count, device groups, the day
loop with sharded training, and ``multihost_init``'s env handling. The
JAX side runs on the conftest's 8 virtual CPU devices, the port on the
CPU repeated (virtual devices)."""
import dataclasses
import socket
from datetime import date

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models.mlp import MLPConfig as JaxMLPConfig
from bodywork_tpu.models.mlp import init_mlp_params as jax_init_mlp_params
from bodywork_tpu.parallel import make_data_parallel_predict as jax_dp_predict
from bodywork_tpu.parallel import make_mesh as jax_make_mesh
from bodywork_tpu.parallel import mlp_param_sharding as jax_mlp_param_sharding
from bodywork_tpu.parallel import split_devices as jax_split_devices
from bodywork_tpu.parallel import train_mlp_sharded as jax_train_mlp_sharded
from bodywork_tpu_torch.models import LinearRegressor, MLPConfig, MLPRegressor
from bodywork_tpu_torch.models.mlp import draw_indices, init_mlp_params
from bodywork_tpu_torch.parallel import (
    DataParallelPredictor,
    make_data_parallel_predict,
    make_mesh,
    mlp_param_sharding,
    split_devices,
    train_mlp_sharded,
)
from bodywork_tpu_torch.parallel import mesh as mesh_mod
from bodywork_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV, available_devices
from bodywork_tpu_torch.parallel.sharding import _round_buckets_to_axis
from bodywork_tpu_torch.parallel.train_step import sharded_loss_and_grads

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the port's single-device training parity bars (tests/test_torch_mlp_train.py)
LOSS_RTOL = 1e-4
PRED_RTOL, PRED_ATOL = 1e-4, 1e-3
#: the He init's normal draw: at most 3 ulps off JAX's, on at most 1.5% of
#: the entries (tests/test_torch_mlp_draws.py)
NORMAL_ULPS, NORMAL_SHARE = 3, 0.015


def _cpus(n: int) -> list:
    return [CPU] * n


def _regression(seed: int, n: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, n).astype(np.float32)
    y = (1.0 + 0.5 * X + rng.normal(0, 1, n)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def linear_model():
    X, y = _regression(3, 800)
    return LinearRegressor().fit(X, y, device="cpu"), X, y


def test_the_virtual_device_count_repeats_each_device(monkeypatch):
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    assert available_devices("cpu") == [CPU]
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    assert available_devices("cpu") == _cpus(8) and len(jax.devices()) == 8
    assert make_mesh(devices=available_devices("cpu")).shape == {"data": 8, "model": 1}
    for bad in ("0", "-1", "eight"):
        monkeypatch.setenv(VIRTUAL_DEVICES_ENV, bad)
        with pytest.raises(ValueError, match=VIRTUAL_DEVICES_ENV):
            available_devices("cpu")


def test_make_mesh_shapes_and_errors_are_jaxs():
    mesh = make_mesh(devices=_cpus(8))
    assert mesh.shape == dict(jax_make_mesh().shape) == {"data": 8, "model": 1}
    mesh2 = make_mesh(data=4, model=2, devices=_cpus(8))
    assert mesh2.shape == dict(jax_make_mesh(data=4, model=2).shape)
    assert [len(row) for row in mesh2.devices] == [2] * 4 and mesh2.label == "4x2"
    with pytest.raises(ValueError) as port_err:
        make_mesh(data=3, model=2, devices=_cpus(8))
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(data=3, model=2)
    assert str(port_err.value) == str(jax_err.value)
    assert mesh.group is None and mesh.one_device()


def test_the_mesh_info_gauge_is_set():
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.obs.registry import validate_metric_name

    validate_metric_name("bodywork_tpu_parallel_mesh_info", "gauge")
    make_mesh(data=2, model=3, devices=_cpus(6))
    assert get_registry().gauge("bodywork_tpu_parallel_mesh_info").value(
        data="2", model="3") == 1.0


@pytest.mark.parametrize("n", [1, 7, 8, 100, 1000])
def test_data_parallel_predict_is_byte_equal_to_single_device_and_near_jaxs(linear_model, n):
    model, X, _y = linear_model
    got = make_data_parallel_predict(model, make_mesh(data=8, devices=_cpus(8)))(X[:n])
    np.testing.assert_array_equal(got, model.predict(X[:n, None]))
    from bodywork_tpu.models.linear import LinearRegressor as JaxLinear
    from bodywork_tpu_torch.models.mlp import params_to_host

    jax_model = JaxLinear(model.config, params_to_host(model.params))
    want = jax_dp_predict(jax_model, jax_make_mesh(data=8))(X[:n])
    # XLA:CPU may fuse the multiply-add (one rounding where torch rounds
    # twice): JAX's rows are a last-ulp away, not byte-equal
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_data_parallel_predictor_chunks_through_its_buckets(linear_model):
    model, X, _y = linear_model
    pred = DataParallelPredictor(model, make_mesh(data=8, devices=_cpus(8)), buckets=(64, 512))
    pred.warmup()
    np.testing.assert_array_equal(pred.predict(X), model.predict(X[:, None]))


def test_buckets_round_up_to_a_data_axis_that_does_not_divide_them(linear_model):
    from bodywork_tpu.parallel import DataParallelPredictor as JaxDataParallelPredictor

    model, X, _y = linear_model
    pred = DataParallelPredictor(model, make_mesh(data=5, devices=_cpus(5)), buckets=(64, 512))
    assert all(b % 5 == 0 for b in pred.buckets)
    assert _round_buckets_to_axis((1, 8, 64, 512, 4096), 3) == (3, 9, 66, 513, 4098)
    from bodywork_tpu.models.linear import LinearRegressor as JaxLinear
    from bodywork_tpu_torch.models.mlp import params_to_host

    jax_pred = JaxDataParallelPredictor(JaxLinear(model.config, params_to_host(model.params)),
                                        jax_make_mesh(data=5, devices=jax.devices()[:5]),
                                        buckets=(64, 512))
    assert pred.buckets == jax_pred.buckets
    np.testing.assert_array_equal(pred.predict(X[:100]), model.predict(X[:100, None]))


def _tiny_mlp(hidden=(32, 32)):
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    return MLPRegressor(MLPConfig(hidden=hidden, n_steps=10)).fit(X, X.ravel(), device="cpu")


@pytest.mark.parametrize("hidden", [(32, 32), (8, 16, 4), (12,)])
def test_mlp_param_sharding_specs_are_jaxs(hidden):
    """Layer 0 column-parallel, the middle layers row-parallel, the last
    layer and the scaler replicated: the JAX ``PartitionSpec``s as tuples."""
    model = _tiny_mlp(hidden)
    specs = mlp_param_sharding(make_mesh(data=4, model=2, devices=_cpus(8)), model.params)
    jax_params = {"net": {"layers": [{"w": None, "b": None}] * (len(hidden) + 1)},
                  "scaler": dict.fromkeys(model.params["scaler"])}
    want = jax_mlp_param_sharding(jax_make_mesh(data=4, model=2), jax_params)
    for got_layer, want_layer in zip(specs["net"]["layers"], want["net"]["layers"]):
        assert {k: tuple(v) for k, v in want_layer.items()} == got_layer
    assert specs["scaler"] == {k: tuple(v) for k, v in want["scaler"].items()}
    assert specs["net"]["layers"][0]["w"] == (None, "model")


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _jax_scan_indices(key, n_steps: int, batch: int, n_rows: int) -> np.ndarray:
    out = []
    for _ in range(n_steps):
        key, k_idx = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(k_idx, (batch,), 0, n_rows)))
    return np.stack(out)


SHARDED = dict(hidden=(16, 16), n_steps=120, batch_size=128, learning_rate=1e-2)


@pytest.fixture(scope="module")
def sharded_pair():
    X, y = _regression(5, 1024)
    port = train_mlp_sharded(X, y, MLPConfig(**SHARDED), make_mesh(2, 2, _cpus(4)), seed=7)
    jax_model = jax_train_mlp_sharded(X, y, JaxMLPConfig(**SHARDED),
                                      jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]),
                                      seed=7)
    return X, y, port, jax_model


def test_the_sharded_fits_draws_are_jaxs():
    """The He init within the normal draw's ulp bar, the index stream over
    the UNPADDED row count bit for bit: ``split(PRNGKey(seed))``, then the
    scan's chain from the second key."""
    from bodywork_tpu_torch.data import prng

    k_init, k_batch = prng.split(prng.PRNGKey(7))
    jk_init, jk_batch = jax.random.split(jax.random.PRNGKey(7))
    got = init_mlp_params(k_init, (1, 16, 16, 1))
    want = jax_init_mlp_params(jk_init, (1, 16, 16, 1))
    ulps = np.concatenate([_ulps(g["w"].numpy(), np.asarray(w["w"])).ravel()
                           for g, w in zip(got["layers"], want["layers"])])
    assert ulps.max() <= NORMAL_ULPS and (ulps > 0).mean() <= NORMAL_SHARE
    np.testing.assert_array_equal(draw_indices(k_batch, 30, 128, 1000).numpy(),
                                  _jax_scan_indices(jk_batch, 30, 128, 1000))


def test_step0_loss_and_gradients_at_jaxs_init_are_jaxs():
    """At the JAX init and the JAX run's first minibatch, the 2x2 sharded
    loss within 1e-6 (relative) and the gradients within 1e-5 of JAX's."""
    from bodywork_tpu.models.mlp import _loss as jax_loss
    from bodywork_tpu_torch.parallel.train_step import _standardised

    X, y = _regression(5, 1024)
    cfg = MLPConfig(**SHARDED)
    jk_init, jk_batch = jax.random.split(jax.random.PRNGKey(7))
    jnet = jax_init_mlp_params(jk_init, (1, 16, 16, 1))
    Xs, ys, _ = _standardised(X[:, None], y, CPU)
    idx0 = _jax_scan_indices(jk_batch, 1, 128, 1024)[0]
    net = {"layers": [{k: torch.from_numpy(np.array(layer[k])) for k in ("w", "b")}
                      for layer in jnet["layers"]]}
    loss, grads = sharded_loss_and_grads(net, Xs, ys, torch.from_numpy(idx0),
                                         make_mesh(2, 2, _cpus(4)), cfg)
    jXs, jys = jnp.asarray(Xs.numpy()), jnp.asarray(ys.numpy())
    want, jgrads = jax.value_and_grad(jax_loss)(jnet, jXs[idx0], jys[idx0],
                                                jnp.ones(128, jnp.float32))
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    for n, g in enumerate(grads):
        ref = np.asarray(jgrads["layers"][n // 2]["wb"[n % 2]])
        gap = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref), 1e-30)
        assert gap <= 1e-5, (n, gap)


def test_sharded_fit_on_2x2_matches_jaxs(sharded_pair):
    X, _y, port, jax_model = sharded_pair
    np.testing.assert_allclose(port.final_loss, jax_model.final_loss, rtol=LOSS_RTOL)
    Xq = np.linspace(0.0, 100.0, 32, dtype=np.float32)[:, None]
    np.testing.assert_allclose(port.predict(Xq), jax_model.predict(Xq),
                               rtol=PRED_RTOL, atol=PRED_ATOL)
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_allclose(port.scaler[name].numpy(),
                                   np.asarray(jax_model.params["scaler"][name]), rtol=2e-6)
    # the params come back whole, in the single-device layout
    assert [tuple(layer.w.shape) for layer in port.net.layers] == [(1, 16), (16, 16), (16, 1)]


def test_sharded_params_checkpoint_and_serve_like_a_single_device_fit(sharded_pair):
    from bodywork_tpu.models.checkpoint import load_model_bytes as jax_load
    from bodywork_tpu_torch.models.checkpoint import load_model_bytes, save_model_bytes

    X, _y, port, _jax = sharded_pair
    data = save_model_bytes(port)
    clone = load_model_bytes(data, device="cpu")
    np.testing.assert_array_equal(clone.predict(X[:16]), port.predict(X[:16]))
    np.testing.assert_allclose(jax_load(data).predict(X[:16]), port.predict(X[:16]),
                               rtol=1e-5)


def test_a_batch_the_data_axis_does_not_divide_trains_as_jaxs():
    """130 rows over 4 data shards: JAX pads the index vector's shards
    (33, 33, 33, 31); the port cuts the same contiguous chunks."""
    X, y = _regression(1, 300)
    kw = dict(hidden=(8, 8), n_steps=20, batch_size=130, learning_rate=1e-2)
    port = train_mlp_sharded(X, y, MLPConfig(**kw), make_mesh(4, 2, _cpus(8)), seed=3)
    ref = jax_train_mlp_sharded(X, y, JaxMLPConfig(**kw), jax_make_mesh(data=4, model=2),
                                seed=3)
    np.testing.assert_allclose(port.final_loss, ref.final_loss, rtol=LOSS_RTOL)
    from bodywork_tpu_torch.parallel.collectives import split_bounds

    assert split_bounds(130, 4) == [(0, 33), (33, 66), (66, 99), (99, 130)]
    assert split_bounds(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]


def test_sharded_staging_is_o_dataset_and_a_seed_repeats():
    X, y = _regression(9, 1024)
    mesh = make_mesh(4, 2, _cpus(8))
    t_short, t_long = {}, {}
    cfg_short = MLPConfig(hidden=(16, 16), n_steps=5, batch_size=128)
    cfg_long = MLPConfig(hidden=(16, 16), n_steps=400, batch_size=128)
    train_mlp_sharded(X, y, cfg_short, mesh, timings=t_short)
    train_mlp_sharded(X, y, cfg_long, mesh, timings=t_long)
    assert t_long["staging_s"] < max(10 * t_short["staging_s"], 0.5)
    assert t_long["scan_s"] > t_long["staging_s"]
    m1 = train_mlp_sharded(X, y, cfg_short, mesh, seed=7)
    m2 = train_mlp_sharded(X, y, cfg_short, mesh, seed=7)
    for a, b in zip(m1.net.layers, m2.net.layers):
        assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)


def test_a_1x1_mesh_fit_is_byte_equal_across_virtual_meshes_of_one_model_axis():
    """Data shards only regroup the batch's rows: a 1xM fit and a DxM fit
    walk the same index stream, and at one model shard each row's product
    is the single-device one."""
    X, y = _regression(4, 512)
    cfg = MLPConfig(hidden=(8, 8), n_steps=3, batch_size=64)
    one = train_mlp_sharded(X, y, cfg, make_mesh(1, 1, _cpus(1)), seed=2)
    two = train_mlp_sharded(X, y, cfg, make_mesh(2, 1, _cpus(2)), seed=2)
    np.testing.assert_allclose(two.final_loss, one.final_loss, rtol=1e-6)


def test_split_devices_and_the_ab_groups_are_jaxs():
    from bodywork_tpu_torch.pipeline.ab import _device_groups

    pool = [torch.device("cpu", i) for i in range(8)]
    groups = split_devices(2, pool)
    jax_groups = jax_split_devices(2)
    assert [[d.index for d in g] for g in groups] == [[d.id for d in g] for g in jax_groups]
    assert not set(groups[0]) & set(groups[1])
    with pytest.raises(ValueError) as port_err:
        split_devices(3, pool)
    with pytest.raises(ValueError) as jax_err:
        jax_split_devices(3)
    assert str(port_err.value) == str(jax_err.value)
    assert _device_groups(2, pool) == [groups[0][0], groups[1][0]]


def test_the_day_loop_with_sharded_training_matches_jaxs(tmp_path, monkeypatch):
    """Two simulated days with the train stage's fit sharded 4x2 through
    the spec's args, as the CLI and YAML paths express it: both packages
    persist a checkpoint and the live metrics each day, and the fits
    agree."""
    from bodywork_tpu.pipeline import LocalRunner as JaxRunner
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.store import FilesystemStore as JaxStore
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import MODELS_PREFIX, TEST_METRICS_PREFIX

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    args = {"mesh_data": 4, "mesh_model": 2, "hidden": [8, 8], "n_steps": 12}
    stores = []
    for pipeline, runner_cls, store_cls, name in (
            (default_pipeline, LocalRunner, FilesystemStore, "port"),
            (jax_pipeline, JaxRunner, JaxStore, "jax")):
        spec = pipeline(model_type="mlp")
        spec.stages["stage-1-train-model"].args.update(args)
        spec.stages["stage-1-train-model"].max_completion_time_s = 120.0
        store = store_cls(tmp_path / name)
        kwargs = {"device": "cpu"} if name == "port" else {}
        results = runner_cls(spec, store, **kwargs).run_simulation(date(2026, 1, 1), 2)
        assert len(results) == 2
        stores.append(store)
    port_store, jax_store = stores
    for prefix in (MODELS_PREFIX, TEST_METRICS_PREFIX):
        assert [k for k, _ in port_store.history(prefix)] == \
            [k for k, _ in jax_store.history(prefix)]
    key = port_store.history(MODELS_PREFIX)[-1][0]
    from bodywork_tpu.models.checkpoint import load_model as jax_load_model

    port_model, _ = load_model(port_store, key, device="cpu")
    jax_model, _ = jax_load_model(jax_store, key)
    Xq = np.linspace(0.0, 100.0, 16, dtype=np.float32)[:, None]
    np.testing.assert_allclose(port_model.predict(Xq), jax_model.predict(Xq),
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_sharded_training_refuses_a_linear_model_and_an_oversized_mesh(tmp_path, monkeypatch):
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.train import train_on_history

    store = FilesystemStore(tmp_path / "s")
    d = date(2026, 1, 1)
    persist_dataset(store, Dataset(*generate_day(d, device="cpu"), d))
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    with pytest.raises(ValueError, match="requires model_type='mlp'"):
        train_on_history(store, "linear", mesh_data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 4x1 needs 4 devices, have 2"):
        train_on_history(store, "mlp", mesh_data=4, device="cpu")
    with pytest.raises(ValueError, match="incremental training does not support"):
        train_on_history(store, "mlp", mesh_data=2, mode="incremental", device="cpu")
    result = train_on_history(store, "mlp", mesh_model=2, device="cpu",
                              model_kwargs={"hidden": [8, 8], "n_steps": 5})
    assert store.exists(result.model_artefact_key)


def test_multihost_init_joins_only_with_a_coordinator(monkeypatch):
    import torch.distributed as dist

    for name in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
                 "JAX_NUM_PROCESSES", "PROCESS_ID", "JAX_PROCESS_ID", "JOB_COMPLETION_INDEX"):
        monkeypatch.delenv(name, raising=False)
    assert mesh_mod.multihost_init("cpu") is False
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "coordinator:8476")
    with pytest.raises(ValueError, match="NUM_PROCESSES and PROCESS_ID"):
        mesh_mod.multihost_init("cpu")
    # the Indexed-Job pod's env: the topology from NUM_PROCESSES and the
    # pod's JOB_COMPLETION_INDEX
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("JOB_COMPLETION_INDEX", "1")
    assert mesh_mod.multihost_init("cpu") is True
    assert calls == [(("gloo",), {"init_method": "tcp://coordinator:8476",
                                  "world_size": 2, "rank": 1})]
    # idempotent: a joined process joins nothing again
    monkeypatch.setattr(mesh_mod, "_distributed_initialized", lambda: True)
    assert mesh_mod.multihost_init("cpu") is True
    assert len(calls) == 1
    monkeypatch.setenv("PROCESS_ID", "0")  # PROCESS_ID wins over the index
    monkeypatch.setattr(mesh_mod, "_distributed_initialized", lambda: False)
    mesh_mod.multihost_init("cpu")
    assert calls[-1][1]["rank"] == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_one_rank_group_gives_the_no_group_bytes_and_shuts_down_once(monkeypatch):
    X, y = _regression(6, 512)
    cfg = MLPConfig(hidden=(8, 8), n_steps=10, batch_size=64)
    alone = train_mlp_sharded(X, y, cfg, make_mesh(2, 1, _cpus(2)), seed=4)
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    assert mesh_mod.multihost_shutdown() is False
    try:
        assert mesh_mod.multihost_init("cpu") is True
        assert mesh_mod.multihost_init("cpu") is True
        assert mesh_mod.process_layout() == (0, 1)
        grouped = train_mlp_sharded(X, y, cfg, make_mesh(2, 1, _cpus(2)), seed=4)
    finally:
        assert mesh_mod.multihost_shutdown() is True
    assert mesh_mod.multihost_shutdown() is False
    for a, b in zip(alone.net.layers, grouped.net.layers):
        assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)


def test_a_model_axis_across_processes_is_refused(monkeypatch):
    monkeypatch.setattr(mesh_mod, "process_layout", lambda: (0, 2))
    with pytest.raises(ValueError, match="split the model axis across processes"):
        make_mesh(data=1, model=2, devices=_cpus(1))
    monkeypatch.setattr(mesh_mod, "process_layout", lambda: (1, 2))
    import torch.distributed as dist

    from types import SimpleNamespace

    monkeypatch.setattr(dist, "group", SimpleNamespace(WORLD=object()))
    mesh = make_mesh(data=4, model=1, devices=_cpus(2))
    assert mesh.shape == {"data": 4, "model": 1} and mesh.data_offset == 2
    assert len(mesh.devices) == 2


def test_the_data_parallel_apply_needs_an_apply_function():
    from bodywork_tpu_torch.parallel.sharding import make_data_parallel_apply

    @dataclasses.dataclass
    class NoApply:
        apply = None

    with pytest.raises(TypeError, match="does not define an apply function"):
        make_data_parallel_apply(NoApply(), make_mesh(2, 1, _cpus(2)))
