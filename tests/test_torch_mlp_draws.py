"""The seeded MLP's draws are the JAX package's: the He init and the
minibatch index stream come from ``jax.random``'s threefry under the keys
``bodywork_tpu.models.mlp`` derives from ``PRNGKey(seed)``, with no
monkeypatch of either side.

Bars: the index stream bit-equal to the JAX scan's ``randint`` draws
(``fit``: ``split(PRNGKey(seed))[1]``; ``fine_tune``: ``PRNGKey(seed)``);
the init weights within ``normal``'s ulp bar (``tests/test_torch_prng.py``:
3 ulps, on under 1.5% of draws); the port's ``fit`` and JAX's on the same
data and seed within 1e-5 on the step-0 loss and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models import mlp as jax_mlp
from bodywork_tpu.models.base import pad_rows
from bodywork_tpu_torch.data import prng
from bodywork_tpu_torch.models import mlp

torch.set_num_threads(1)

#: ``normal`` against ``jax.random.normal`` (``tests/test_torch_prng.py``)
NORMAL_ULPS = 3
NORMAL_SHARE = 0.015
#: the step-0 bar on the loss and the gradients, relative (``chip_smoke.py``'s
#: ``PARITY_BARS``)
STEP0_BAR = 1e-5


def _jax_scan_indices(key, n_steps: int, batch: int, n_rows: int) -> np.ndarray:
    """The JAX loop's index stream: the scan of ``_train_core``
    (``mlp.py:112-120``) with only its draws."""

    def step(key, _):
        key, k_idx = jax.random.split(key)
        return key, jax.random.randint(k_idx, (batch,), 0, n_rows)

    _, idx = jax.lax.scan(step, key, None, length=n_steps)
    return np.asarray(idx)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (n, 1)).astype(np.float32)
    y = (1.0 + 0.5 * X[:, 0] + rng.normal(0, 10, n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("seed,n_rows,batch,n_steps", [
    (0, 1024, 256, 40),
    (5, 1000, 64, 25),        # a row count that is not a power of two
    (-3, 3, 7, 9),            # fewer rows than the batch draws
    (2**31 - 1, 70001, 33, 12),
    (42, 2**20 + 7, 256, 5),  # a span past 2**16: the multiplier wraps
])
def test_fit_index_stream_is_jaxs_bit_for_bit(seed, n_rows, batch, n_steps):
    k_init, k_train = mlp.fit_keys(seed)
    got = mlp.draw_indices(k_train, n_steps, batch, n_rows).numpy()
    jk_init, jk_train = jax.random.split(jax.random.PRNGKey(seed))
    want = _jax_scan_indices(jk_train, n_steps, batch, n_rows)
    assert got.shape == want.shape == (n_steps, batch)
    np.testing.assert_array_equal(got, want)
    assert k_init.tolist() == np.asarray(jk_init).astype(np.int64).tolist()


@pytest.mark.parametrize("seed,n_rows", [(0, 1024), (9, 2048), (-7, 1500)])
def test_randint_is_jaxs_for_one_key_and_a_stack(seed, n_rows):
    key = prng.PRNGKey(seed)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (300,), 0, n_rows))
    np.testing.assert_array_equal(prng.randint(key, 300, 0, n_rows).numpy(), want)
    keys = prng.split(key, 4)
    stacked = prng.randint(keys, 50, 10, n_rows)
    for i in range(4):
        jkey = jax.random.split(jax.random.PRNGKey(seed), 4)[i]
        np.testing.assert_array_equal(
            stacked[i].numpy(), np.asarray(jax.random.randint(jkey, (50,), 10, n_rows)))


def test_randint_refuses_bounds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), 4, 0, 2**31)


def test_key_chain_is_the_scans_carried_key():
    chain = prng.key_chain(prng.PRNGKey(11), 6)
    key = jax.random.PRNGKey(11)
    for t in range(6):
        assert chain[t].tolist() == np.asarray(key).astype(np.int64).tolist()
        key, _ = jax.random.split(key)


@pytest.mark.parametrize("sizes,seed", [((1, 64, 64, 1), 0), ((3, 256, 128, 1), 17),
                                        ((1, 1024, 1), 4)])
def test_init_is_jaxs_within_the_normal_ulp_bar(sizes, seed):
    k_init, _ = mlp.fit_keys(seed)
    got = mlp.init_mlp_params(k_init, sizes)
    want = jax_mlp.init_mlp_params(jax.random.split(jax.random.PRNGKey(seed))[0], sizes)
    worst, differ, total = 0, 0, 0
    for g, w in zip(got["layers"], want["layers"]):
        gw, ww = g["w"].numpy(), np.asarray(w["w"])
        assert gw.shape == ww.shape and gw.dtype == ww.dtype == np.float32
        np.testing.assert_array_equal(np.sign(gw), np.sign(ww))
        ulps = _ulps(gw, ww)
        worst, differ, total = max(worst, int(ulps.max())), differ + int((ulps > 0).sum()), \
            total + ulps.size
        np.testing.assert_array_equal(g["b"].numpy(), np.asarray(w["b"]))
    assert worst <= NORMAL_ULPS, worst
    assert differ / total <= NORMAL_SHARE, differ / total


@pytest.mark.parametrize("hidden,seed", [((16, 16), 5), ((64, 32), 12)])
def test_fit_step0_loss_and_gradients_are_jaxs(hidden, seed):
    """The port's fit and JAX's from the same data and seed, with no draw
    shared between them: the first step's loss (the trajectory's losses[0],
    taken before any update) and the gradients at the init within 1e-5."""
    X, y = _data(seed, 1500)
    cfg = dict(hidden=hidden, n_steps=3, batch_size=64)
    Xp, yp, w = pad_rows(X, y)
    _, losses = mlp.MLPRegressor(mlp.MLPConfig(**cfg))._train(
        seed, *(torch.from_numpy(a) for a in (Xp, yp, w)))
    jcfg = jax_mlp.MLPConfig(**cfg)
    k_init, k_train = jax.random.split(jax.random.PRNGKey(seed))
    Xs, ys, _ = jax_mlp._scaled_splits(jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(w))
    jnet = jax_mlp.init_mlp_params(k_init, (1, *hidden, 1))
    _, ref_losses = jax_mlp._train(jax.tree_util.tree_map(jnp.array, jnet), Xs, ys,
                                   jnp.asarray(w), k_train, jcfg)
    assert abs(float(losses[0]) - float(ref_losses[0])) <= STEP0_BAR * abs(float(ref_losses[0]))

    # gradients at each side's own init and first minibatch
    pk_init, pk_train = mlp.fit_keys(seed)
    pnet = mlp.init_mlp_params(pk_init, (1, *hidden, 1))
    idx0 = mlp.draw_indices(pk_train, 1, 64, Xp.shape[0])[0]
    leaves = [t.clone().requires_grad_(True) for layer in pnet["layers"]
              for t in (layer["w"], layer["b"])]
    shaped = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                         for i in range(len(pnet["layers"]))]}
    Xs_t, ys_t, w_t = (torch.from_numpy(np.array(a)) for a in (Xs, ys, w))
    grads = torch.autograd.grad(mlp._loss(shaped, Xs_t[idx0], ys_t[idx0], w_t[idx0]), leaves)
    jidx0 = _jax_scan_indices(k_train, 1, 64, Xp.shape[0])[0]
    jgrads = jax.grad(jax_mlp._loss)(jnet, Xs[jidx0], ys[jidx0], jnp.asarray(w)[jidx0])
    for n, g in enumerate(grads):
        want = np.asarray(jgrads["layers"][n // 2]["wb"[n % 2]])
        gap = float(np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-30))
        assert gap <= STEP0_BAR, (n, gap)


def test_fine_tune_draws_jaxs_index_stream(monkeypatch):
    """``fine_tune`` trains straight from ``PRNGKey(seed)`` (no init
    split); the stream it hands the loop is the JAX fine-tune's scan."""
    X, y = _data(3, 900)
    donor = mlp.MLPRegressor(mlp.MLPConfig(hidden=(8, 8), n_steps=5, batch_size=32)).fit(
        X, y, device="cpu")
    seen = {}
    real = mlp.train_core

    def spy(net, Xs, ys, w, idx, cfg):
        seen["idx"] = idx.clone()
        return real(net, Xs, ys, w, idx, cfg)

    monkeypatch.setattr(mlp, "train_core", spy)
    seed = 7 + 739800  # the incremental path's seed + ordinal form
    donor.fine_tune(X[:700], y[:700], n_steps=12, seed=seed)
    want = _jax_scan_indices(jax.random.PRNGKey(seed), 12, 32, 1024)
    np.testing.assert_array_equal(seen["idx"].numpy(), want)
