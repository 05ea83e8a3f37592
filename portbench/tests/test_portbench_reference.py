"""The plain reference against the port's CPU path at a small size: the
seeded draws bit for bit, the serving apply, and the first three steps
of the fit; and the comparisons on cases whose answer is known."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from portbench.reference import compare, threefry
from portbench.reference import mlp as reference


def test_the_reference_imports_nothing_of_the_port():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); import portbench.reference.mlp, "
            "portbench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'bodywork_tpu_torch', 'bodywork_tpu', 'jax', 'jaxlib'}))")
    from portbench.harness.spec import ROOT

    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_draws_are_the_ports(seed):
    from bodywork_tpu_torch.data import prng

    key = prng.split(prng.PRNGKey(seed), 3)[2]
    mine = np.array(key.numpy(), np.uint32)
    assert np.array_equal(prng.normal(key, 50_000).numpy(), threefry.normal(mine, 50_000))
    assert np.array_equal(prng.randint(key, 5000, 0, 16384).numpy(),
                          threefry.randint(mine, 5000, 0, 16384))
    assert np.array_equal(prng.key_chain(key, 5).numpy(), threefry.key_chain(mine, 5))


def test_the_init_and_indices_are_the_ports():
    from bodywork_tpu_torch.models.mlp import draw_indices, fit_keys, init_mlp_params

    seed, sizes = 123456789, (4, 16, 16, 1)
    k_init, k_train = fit_keys(seed)
    for (w, b), layer in zip(reference.init_layers(seed, sizes, "cpu"),
                             init_mlp_params(k_init, sizes)["layers"]):
        assert torch.equal(w, layer["w"]) and torch.equal(b, layer["b"])
    assert np.array_equal(draw_indices(k_train, 3, 64, 2048).numpy(),
                          reference.minibatch_indices(seed, 3, 64, 2048))


def test_the_apply_is_the_ports():
    from bodywork_tpu_torch.models.mlp import mlp_apply

    gen = torch.Generator().manual_seed(3)
    layers = [(torch.randn(a, b, generator=gen) / a**0.5, torch.randn(b, generator=gen))
              for a, b in ((1, 32), (32, 32), (32, 1))]
    scaler = {"x_mean": torch.tensor([50.0]), "x_std": torch.tensor([28.9]),
              "y_mean": torch.tensor(26.0), "y_std": torch.tensor(17.0)}
    X = torch.rand(300, 1, generator=gen) * 100
    params = {"net": {"layers": [{"w": w, "b": b} for w, b in layers]}, "scaler": scaler}
    assert torch.allclose(reference.apply(layers, scaler, X), mlp_apply(params, X),
                          rtol=1e-6, atol=1e-5)


def test_three_fit_steps_are_the_ports():
    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor

    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (1500, 4)).astype(np.float32)
    y = (X @ rng.normal(size=4)).astype(np.float32)
    seed, cfg = 99, MLPConfig(hidden=(16, 16), batch_size=64, n_steps=3)
    ref = reference.fit_steps(X, y, seed, (16, 16), 1e-2, 64, 3, "cpu")
    leaves = compare.counted_leaves(ref["grad_norms"])
    losses = []
    for n in (1, 2, 3):
        fitted = MLPRegressor(dataclasses.replace(cfg, n_steps=n)).fit(X, y, seed=seed,
                                                                        device="cpu")
        losses.append(fitted.final_loss)
    params = [t for layer in fitted.params["net"]["layers"] for t in (layer["w"], layer["b"])]
    assert compare.loss_gap(losses, ref["losses"]) < 1e-6
    assert compare.change_gap(params, ref["params"][3], ref["init"], leaves) < 1e-6


def test_the_comparisons_on_known_cases():
    a = np.array([1.0, 2.0, -4.0])
    assert compare.answer_gap(a, a) == 0.0
    assert compare.answer_gap(a + [0, 0, 0.4], a) == pytest.approx(0.1)
    assert compare.answer_gap(a[:2], a) == float("inf")
    assert compare.loss_gap([1.0, 2.0], [1.0, 1.0]) == 1.0
    init = [torch.zeros(3), torch.zeros(2)]
    moved = [torch.ones(3), torch.ones(2)]
    assert compare.change_gap(moved, moved, init, [0, 1]) == 0.0
    # a step that returns its state unchanged reads 1
    assert compare.change_gap(init, moved, init, [0, 1]) == 1.0
    # a leaf with no gradient in the reference is left out
    assert compare.counted_leaves([1.0, 2.0, 1e-9]) == [0, 1]
