"""MLP training: the port's Adam loop, fit + held-out eval, the bf16
policy and ``fine_tune`` against the JAX package, fed the JAX loop's own
initial weights and minibatch indices (the port draws its own from a
``torch.Generator``; the JAX package from its key chain)."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models import checkpoint as jax_ckpt
from bodywork_tpu.models import mlp as jax_mlp
from bodywork_tpu.models.base import pad_rows, train_test_split
from bodywork_tpu.models.metrics import regression_metrics
from bodywork_tpu_torch.models import checkpoint as port_ckpt
from bodywork_tpu_torch.models import mlp

torch.set_num_threads(1)

#: the loss trajectory over a few tens of steps: XLA and torch sum the
#: float32 products and the loss in another order, and Adam's first steps
#: are close to ±lr whatever the gradient's size, so rounding differences
#: are carried along rather than damped
LOSS_RTOL = 1e-4
#: the trained net's standardised predictions, absolute (their scale ~1.5)
PRED_ATOL = 1e-4


def _data(seed: int = 0, n: int = 1500, features: int = 1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (n, features)).astype(np.float32)
    y = (1.0 + 0.5 * X.sum(1) + rng.normal(0, 10, n)).astype(np.float32)
    return X, y


def _jax_draws(key, sizes, n_rows: int, cfg, split_init: bool = True):
    """The JAX loop's initial weights (host arrays) and its index stream:
    ``key, k_idx = split(key)`` per step, ``randint`` over the padded
    rows (``mlp.py:117-120``)."""
    net = None
    if split_init:
        k_init, key = jax.random.split(key)
        net = jax.tree_util.tree_map(np.asarray, jax_mlp.init_mlp_params(k_init, sizes))
    idx = []
    for _ in range(cfg.n_steps):
        key, k_idx = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(k_idx, (cfg.batch_size,), 0, n_rows)))
    return net, np.stack(idx)


def _configs(**kwargs):
    return jax_mlp.MLPConfig(**kwargs), mlp.MLPConfig(**kwargs)


def _port_leaves(net):
    return [t.numpy() for layer in net["layers"] for t in (layer["b"], layer["w"])]


@pytest.mark.parametrize("hidden,lr", [((16, 16), 1e-2), ((64, 64), 1e-3)])
def test_adam_loop_matches_jax_with_jax_indices(hidden, lr):
    X, y = _data()
    Xp, yp, w = pad_rows(X, y)
    jcfg, pcfg = _configs(hidden=hidden, n_steps=40, batch_size=64, learning_rate=lr)
    Xs, ys, _ = jax_mlp._scaled_splits(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(w))
    k_init, k_train = jax.random.split(jax.random.PRNGKey(3))
    net = jax.tree_util.tree_map(np.asarray, jax_mlp.init_mlp_params(k_init, (1, *hidden, 1)))
    _, idx = _jax_draws(k_train, None, Xp.shape[0], jcfg, split_init=False)
    ref_net, ref_losses = jax_mlp._train(
        jax.tree_util.tree_map(jnp.array, net), Xs, ys, jnp.asarray(w), k_train, jcfg)
    Xs_t, ys_t = torch.from_numpy(np.array(Xs)), torch.from_numpy(np.array(ys))
    port_in = mlp.params_from_jax(net)
    before = [t.clone() for layer in port_in["layers"] for t in (layer["w"], layer["b"])]
    got_net, losses = mlp.train_core(port_in, Xs_t, ys_t, torch.from_numpy(w),
                                     torch.from_numpy(idx), pcfg)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=LOSS_RTOL)
    np.testing.assert_allclose(mlp.mlp_forward(got_net, Xs_t).numpy(),
                               np.asarray(jax_mlp.mlp_forward(ref_net, Xs)), atol=PRED_ATOL)
    # the loop trains copies; what it returns carries no autograd graph
    after = [t for layer in port_in["layers"] for t in (layer["w"], layer["b"])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(t.requires_grad for t in _torch_leaves(got_net))


def _torch_leaves(net):
    return [t for layer in net["layers"] for t in (layer["w"], layer["b"])]


def test_first_adam_update_matches_jax_elementwise():
    """After one step every update is lr·g/(|g| + eps) ≈ ±lr: where the
    gradient is clearly non-zero the two packages' updates agree
    elementwise; where it is ~0 a rounding difference may flip its sign,
    so those entries are left out."""
    X, y = _data(1)
    Xp, yp, w = pad_rows(X, y)
    jcfg, pcfg = _configs(hidden=(32, 32), n_steps=1, batch_size=128, learning_rate=1e-2)
    Xs, ys, _ = jax_mlp._scaled_splits(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(w))
    key = jax.random.PRNGKey(4)
    net, idx = _jax_draws(key, (1, 32, 32, 1), Xp.shape[0], jcfg)
    k_train = jax.random.split(key)[1]
    ref_net, _ = jax_mlp._train(jax.tree_util.tree_map(jnp.array, net), Xs, ys,
                                jnp.asarray(w), k_train, jcfg)
    Xs_t, ys_t, w_t = (torch.from_numpy(np.array(a)) for a in (Xs, ys, w))
    port_in = mlp.params_from_jax(net)
    params = [t.clone().requires_grad_(True) for t in _torch_leaves(port_in)]
    shaped = {"layers": [{"w": params[2 * i], "b": params[2 * i + 1]} for i in range(3)]}
    i = torch.from_numpy(idx[0])
    grads = torch.autograd.grad(mlp._loss(shaped, Xs_t[i], ys_t[i], w_t[i]), params)
    got_net, _ = mlp.train_core(port_in, Xs_t, ys_t, w_t, torch.from_numpy(idx), pcfg)
    ref_leaves = {(li, k): np.asarray(ref_net["layers"][li][k]) for li in range(3) for k in "wb"}
    n_checked = 0
    for n, g in enumerate(grads):
        li, k = n // 2, "wb"[n % 2]
        start = _torch_leaves(port_in)[n].numpy()
        got = _torch_leaves(got_net)[n].numpy() - start
        want = ref_leaves[(li, k)] - start
        clear = np.abs(g.numpy()) > 1e-4 * float(g.abs().max())
        np.testing.assert_allclose(got[clear], want[clear], rtol=1e-4)
        np.testing.assert_allclose(np.abs(got[clear]), 1e-2, rtol=1e-3)
        n_checked += int(clear.sum())
    # dead ReLU units leave about half of a small net's gradient at zero
    assert n_checked > 400


@pytest.fixture
def jax_draws_in_the_port(monkeypatch):
    """Make the port's init and index draws return the JAX package's for
    the key the JAX fit would use: ``install(seed, n_rows, cfg,
    split_init)``."""

    def install(seed: int, cfg, split_init: bool = True):
        state = {}

        def init(generator, sizes, device=None):
            key = jax.random.PRNGKey(seed)
            net, state["idx_key"] = None, key
            if split_init:
                k_init, state["idx_key"] = jax.random.split(key)
                net = mlp.params_from_jax(jax_mlp.init_mlp_params(k_init, sizes), device)
            return net

        def draw(generator, n_steps, batch_size, n_rows, device=None):
            if not split_init:
                init(None, None)
            _, idx = _jax_draws(state["idx_key"], None, n_rows, cfg, split_init=False)
            return torch.from_numpy(idx).to(device)

        monkeypatch.setattr(mlp, "init_mlp_params", init)
        monkeypatch.setattr(mlp, "draw_indices", draw)

    return install


def test_fit_and_evaluate_matches_jax_on_the_same_draws(jax_draws_in_the_port):
    X, y = _data(2, 2500)
    s = train_test_split(X, y)
    jcfg, pcfg = _configs(hidden=(16, 16), n_steps=60, batch_size=64)
    jax_draws_in_the_port(5, jcfg)
    fitted, got = mlp.MLPRegressor(pcfg).fit_and_evaluate(
        s.X_train, s.y_train, s.X_test, s.y_test, seed=5, device="cpu")
    ref, want = jax_mlp.MLPRegressor(jcfg).fit_and_evaluate(
        s.X_train, s.y_train, s.X_test, s.y_test, seed=5)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=LOSS_RTOL)
    np.testing.assert_allclose(fitted.final_loss, ref.final_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(fitted.predict(s.X_test), ref.predict(s.X_test),
                               rtol=1e-4, atol=1e-3)
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        np.testing.assert_allclose(fitted.scaler[name].numpy(),
                                   np.asarray(ref.params["scaler"][name]), rtol=2e-6)


def test_fine_tune_keeps_the_donor_scaler_and_matches_jax(jax_draws_in_the_port):
    X, y = _data(3, 1500)
    X2, y2 = _data(4, 700)
    jcfg, pcfg = _configs(hidden=(16, 16), n_steps=50, batch_size=64)
    donor = mlp.MLPRegressor(pcfg).fit(X, y, device="cpu")
    jax_donor = jax_ckpt.load_model_bytes(port_ckpt.save_model_bytes(donor))
    jax_draws_in_the_port(9, jax_mlp.MLPConfig(hidden=(16, 16), n_steps=30, batch_size=64),
                          split_init=False)
    tuned = donor.fine_tune(X2, y2, n_steps=30, seed=9)
    ref = jax_donor.fine_tune(X2, y2, n_steps=30, seed=9)
    for name, t in donor.scaler.items():
        assert torch.equal(tuned.scaler[name], t), name
    assert tuned.config == donor.config and tuned.config.n_steps == 50
    np.testing.assert_allclose(tuned.final_loss, ref.final_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tuned.predict(X2), ref.predict(X2), rtol=1e-4, atol=1e-3)
    assert not np.allclose(tuned.predict(X2), donor.predict(X2))


def _nonlinear_task(rng):
    """The JAX package's bf16 accuracy task (``tests/test_models.py:136``)."""
    n = 2000
    X = rng.uniform(-3, 3, (n, 8)).astype(np.float32)
    w = rng.normal(size=8).astype(np.float32)
    y = (np.sin(X @ w) * 2 + 0.3 * (X @ w) ** 2).astype(np.float32)
    return X, y


def test_bf16_training_within_the_jax_bf16_tolerance():
    """bf16 matmul operands, f32 params, optimizer state and loss: the
    fit lands in the f32 fit's accuracy band, as in the JAX package's own
    test (r² > 0.95 and within 0.03 of f32), and within 0.03 of the JAX
    package's bf16 fit."""
    X, y = _nonlinear_task(np.random.default_rng(0))
    base = dict(hidden=(64, 64), n_steps=900, learning_rate=5e-3, batch_size=256)
    port_f32 = mlp.MLPRegressor(mlp.MLPConfig(**base)).fit(X, y, device="cpu")
    port_bf16 = mlp.MLPRegressor(mlp.MLPConfig(**base, compute_dtype="bfloat16")).fit(
        X, y, device="cpu")
    jax_bf16 = jax_mlp.MLPRegressor(jax_mlp.MLPConfig(**base, compute_dtype="bfloat16")).fit(X, y)
    r2 = {name: regression_metrics(y, m.predict(X))["r_squared"]
          for name, m in (("f32", port_f32), ("bf16", port_bf16), ("jax", jax_bf16))}
    assert r2["f32"] > 0.95 and r2["bf16"] > 0.95, r2
    assert abs(r2["f32"] - r2["bf16"]) < 0.03, r2
    assert abs(r2["bf16"] - r2["jax"]) < 0.03, r2
    for layer in port_bf16.net.layers:
        assert layer.w.dtype == torch.float32


def test_bf16_first_loss_matches_jax():
    """The first step's loss sees the same bf16-rounded operands in both
    packages (after that, bf16 rounding of different summation orders
    diverges the trajectories, so the bar above is the accuracy band)."""
    X, y = _data(5)
    Xp, yp, w = pad_rows(X, y)
    jcfg, pcfg = _configs(hidden=(32, 32), n_steps=1, batch_size=64, compute_dtype="bfloat16")
    Xs, ys, _ = jax_mlp._scaled_splits(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(w))
    key = jax.random.PRNGKey(6)
    net, idx = _jax_draws(key, (1, 32, 32, 1), Xp.shape[0], jcfg)
    _, ref_losses = jax_mlp._train(jax.tree_util.tree_map(jnp.array, net), Xs, ys,
                                   jnp.asarray(w), jax.random.split(key)[1], jcfg)
    _, losses = mlp.train_core(mlp.params_from_jax(net), torch.from_numpy(np.array(Xs)),
                               torch.from_numpy(np.array(ys)), torch.from_numpy(w),
                               torch.from_numpy(idx), pcfg)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-3)


def test_fit_is_seeded_and_fitted_params_are_detached():
    X, y = _data(6, 800)
    cfg = mlp.MLPConfig(hidden=(8,), n_steps=20, batch_size=32)
    a = mlp.MLPRegressor(cfg).fit(X, y, device="cpu")
    b = mlp.MLPRegressor(cfg).fit(X, y, device="cpu")
    c = mlp.MLPRegressor(cfg).fit(X, y, seed=1, device="cpu")
    np.testing.assert_array_equal(a.predict(X), b.predict(X))
    assert not np.array_equal(a.predict(X), c.predict(X))
    assert np.isfinite(a.final_loss)
    for layer in a.net.layers:
        assert isinstance(layer.w, torch.nn.Parameter) and not layer.w.requires_grad
    with pytest.raises(ValueError, match="not fitted"):
        mlp.MLPRegressor(cfg).predict(X)


def test_port_trained_mlp_checkpoint_cross_loads_both_ways():
    X, y = _data(7, 900)
    port = mlp.MLPRegressor(mlp.MLPConfig(hidden=(16, 8), n_steps=30)).fit(X, y, device="cpu")
    data = port_ckpt.save_model_bytes(port)
    back = jax_ckpt.load_model_bytes(data)
    np.testing.assert_allclose(back.predict(X), port.predict(X), rtol=2e-4, atol=2e-4)
    again = port_ckpt.load_model_bytes(jax_ckpt.save_model_bytes(back), device="cpu")
    np.testing.assert_allclose(again.predict(X), port.predict(X), rtol=2e-4, atol=2e-4)
    assert again.config == port.config
    with np.load(io.BytesIO(data)) as npz:
        assert npz["scaler/x_mean"].shape == (1,) and npz["scaler/y_std"].shape == ()
