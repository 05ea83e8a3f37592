"""The port's fused-MLP kernel wrapper (plain version, on the CPU) against
the JAX package's Pallas kernel run in interpret mode, as tests/test_ops.py
runs it. Inputs and weights are made with numpy from a seed and handed to
both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.models.fused import quantize_int8 as jax_quantize_int8
from bodywork_tpu.models.mlp import mlp_apply as jax_mlp_apply
from bodywork_tpu.ops import fold_scaler_into_net as jax_fold
from bodywork_tpu.ops import make_pallas_mlp_apply
from bodywork_tpu_torch.models.mlp import params_from_jax
from bodywork_tpu_torch.ops import mlp_kernel as port

torch.set_num_threads(1)

#: (n_features, hidden): small shapes — equal widths, a single
#: hidden layer over 3 features, and unequal widths
CONFIGS = [(1, (16, 16)), (3, (8,)), (1, (24, 40))]
IDS = ["1f-16x16", "3f-8", "1f-24x40"]


def host_params(n_features: int, hidden: tuple, seed: int = 0) -> dict:
    """He-init weights, small random biases and a realistic scaler, as
    nested numpy arrays in the JAX pytree layout."""
    rng = np.random.default_rng(seed)
    sizes = (n_features, *hidden, 1)
    layers = [
        {
            "w": (rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
            "b": (rng.normal(size=(o,)) * 0.1).astype(np.float32),
        }
        for i, o in zip(sizes[:-1], sizes[1:])
    ]
    scaler = {
        "x_mean": rng.uniform(40, 60, n_features).astype(np.float32),
        "x_std": rng.uniform(20, 30, n_features).astype(np.float32),
        "y_mean": np.float32(26.0),
        "y_std": np.float32(14.0),
    }
    return {"net": {"layers": layers}, "scaler": scaler}


def inputs(n_features: int, rows: int = 300, seed: int = 1) -> np.ndarray:
    X = np.random.default_rng(seed).uniform(0, 100, (rows, n_features))
    return X.astype(np.float32)


@pytest.fixture(params=CONFIGS, ids=IDS)
def case(request):
    n_features, hidden = request.param
    host = host_params(n_features, hidden)
    return {
        "host": host,
        "jax": jax.tree_util.tree_map(jnp.asarray, host),
        "port": params_from_jax(host, "cpu"),
        "X": inputs(n_features),
    }


def test_fold_matches_jax(case):
    """The scaler fold is the same algebra in both packages (2e-4)."""
    want = jax_fold(case["jax"])
    got = port.fold_scaler_into_net(case["port"])
    assert len(got) == len(want)
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=2e-4, atol=2e-4)


def test_f32_plain_matches_pallas_interpret(case):
    """engine kernel vs pallas: f32 to the JAX package's own 2e-4
    (tests/test_ops.py:42)."""
    want = np.asarray(make_pallas_mlp_apply(case["jax"], interpret=True)(case["X"]))
    got = port.make_kernel_mlp_apply(case["port"], "cpu")(case["X"]).numpy()
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_f32_plain_matches_xla_apply(case):
    """...and the folded stack equals the unfolded XLA apply (2e-4)."""
    want = np.asarray(jax_mlp_apply(case["jax"], jnp.asarray(case["X"])))
    got = port.make_kernel_mlp_apply(case["port"], "cpu")(case["X"]).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_plain_matches_pallas_bf16(case):
    """bf16 weights, activations rounded to bf16 at each product, f32
    accumulation: the same arithmetic as the Pallas bf16 variant, so the
    two agree far inside bf16's precision (rtol 1e-3; a summation-order
    difference can flip one activation's bf16 rounding)."""
    want = np.asarray(make_pallas_mlp_apply(
        case["jax"], interpret=True, compute_dtype="bfloat16")(case["X"]))
    got = port.make_kernel_mlp_apply(
        case["port"], "cpu", compute_dtype="bfloat16")(case["X"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_bf16_close_to_f32_and_genuinely_bf16(case):
    """tests/test_ops.py:45-56's bar: within rtol 2e-2 / atol 0.5 of f32,
    and not silently f32."""
    f32 = port.make_kernel_mlp_apply(case["port"], "cpu")(case["X"]).numpy()
    b16 = port.make_kernel_mlp_apply(
        case["port"], "cpu", compute_dtype="bfloat16")(case["X"]).numpy()
    np.testing.assert_allclose(b16, f32, rtol=2e-2, atol=0.5)
    assert not np.allclose(b16, f32, rtol=1e-6, atol=0)


def test_int8_quantization_identical_to_jax(case):
    """The port's quantize_int8 gives the same q and scale as the JAX
    package's on the same folded weights (exact)."""
    for w, _ in jax_fold(case["jax"]):
        w = np.asarray(w)
        q_want, s_want = jax_quantize_int8(w)
        q_got, s_got = port.quantize_int8(w)
        assert q_got.dtype == np.int8 and s_got.dtype == np.float32
        np.testing.assert_array_equal(q_got, q_want)
        np.testing.assert_array_equal(s_got, s_want)


def test_int8_error_over_scale(case):
    """tests/test_compiled.py:395-398's bar against f32 (error/scale <
    2e-2), and close agreement with the Pallas int8 variant (1e-3 of
    scale: the same dequantized weights, another summation order)."""
    X = case["X"]
    ref = np.asarray(jax_mlp_apply(case["jax"], jnp.asarray(X)))
    scale = max(1.0, float(np.max(np.abs(ref))))
    got = port.make_kernel_mlp_apply(
        case["port"], "cpu", compute_dtype="int8")(X).numpy()
    assert np.max(np.abs(got - ref)) / scale < 2e-2
    pallas = np.asarray(make_pallas_mlp_apply(
        case["jax"], interpret=True, compute_dtype="int8")(X))
    assert np.max(np.abs(got - pallas)) / scale < 1e-3


@pytest.mark.parametrize("tile", [7, 12, -8])
def test_row_tile_must_be_a_positive_multiple_of_8(tile):
    params = params_from_jax(host_params(1, (8,)), "cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        port.make_kernel_mlp_apply(params, "cpu", row_tile=tile)
    with pytest.raises(ValueError):
        make_pallas_mlp_apply(
            jax.tree_util.tree_map(jnp.asarray, host_params(1, (8,))),
            interpret=True, row_tile=tile,
        )


@pytest.mark.parametrize("tile", [8, 16, 256])
def test_valid_row_tiles_are_accepted(tile):
    params = params_from_jax(host_params(1, (8,)), "cpu")
    assert port.make_kernel_mlp_apply(params, "cpu", row_tile=tile).row_tile == tile


def test_feature_count_mismatch_raises():
    params = params_from_jax(host_params(3, (8,)), "cpu")
    apply = port.make_kernel_mlp_apply(params, "cpu")
    with pytest.raises(ValueError, match="expected 3 feature"):
        apply(np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_1d_and_2d_input_agree(dtype):
    apply = port.make_kernel_mlp_apply(
        params_from_jax(host_params(1, (16, 16)), "cpu"), "cpu", compute_dtype=dtype
    )
    X = np.linspace(0, 100, 40, dtype=np.float32)
    np.testing.assert_array_equal(apply(X).numpy(), apply(X[:, None]).numpy())


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_output_is_column_zero_unpadded(rows):
    apply = port.make_kernel_mlp_apply(params_from_jax(host_params(1, (16, 16)), "cpu"), "cpu")
    out = apply(inputs(1, rows))
    assert out.shape == (rows,) and out.dtype == torch.float32


def test_a_tensor_on_another_device_is_refused_not_moved():
    apply = port.make_kernel_mlp_apply(params_from_jax(host_params(1, (8,)), "cpu"), "cpu")
    with pytest.raises(ValueError, match="input on meta"):
        apply(torch.empty(4, 1, device="meta"))


def test_layer_storage_types():
    params = params_from_jax(host_params(1, (16, 16)), "cpu")
    f32 = port.make_kernel_mlp_apply(params, "cpu").layers
    b16 = port.make_kernel_mlp_apply(params, "cpu", compute_dtype="bfloat16").layers
    i8 = port.make_kernel_mlp_apply(params, "cpu", compute_dtype="int8").layers
    assert all(layer["w"].dtype == torch.float32 and layer["scale"] is None for layer in f32)
    assert all(layer["w"].dtype == torch.bfloat16 for layer in b16)
    assert all(
        layer["w"].dtype == torch.int8 and layer["scale"].dtype == torch.float32
        for layer in i8
    )
    with pytest.raises(ValueError, match="compute_dtype"):
        port.make_kernel_mlp_apply(params, "cpu", compute_dtype="float16")


def test_cpu_path_launches_no_kernel():
    """The plain version runs only because the tensor lies on the CPU,
    and it never counts as a kernel launch."""
    port.reset_launches()
    apply = port.make_kernel_mlp_apply(params_from_jax(host_params(1, (8,)), "cpu"), "cpu")
    apply(inputs(1, 10))
    assert apply.launch is None
    assert all(v == 0 for v in port.LAUNCHES.values())
    assert set(port.LAUNCHES) == {"kernel", "kernel-bf16", "kernel-int8"}
