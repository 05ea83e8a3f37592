"""The launch plan of the port's Hopper cluster kernels (``kernel-bf16``,
``kernel-int8``), held on the CPU: the pure plan function, the padded
weight layouts the kernels read, and a static check of the CUDA sources.
The kernels themselves run only on the card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu_torch.models.mlp import params_from_jax
from bodywork_tpu_torch.ops import _build
from bodywork_tpu_torch.ops import mlp_kernel as port

torch.set_num_threads(1)

#: the served model (1 -> 1024 -> 1024 -> 1024 -> 1) on an H100 SXM: 132 SMs
#: and 232,448 bytes of shared memory a block may opt into
WIDTHS = (1, 1024, 1024, 1024, 1)
N_SMS = 132
BUDGET = 232_448
ENGINES = list(port.CLUSTER_KERNELS)
ROWS = [1, 8, 256, 300, 512, 4096]
#: PR 1's f32 kernel gave a 256-row batch 32 blocks of 8 rows
PR1_BLOCKS_AT_256 = 32
CSRC = Path(port.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("engine", ENGINES)
def test_plan_fits_the_shared_memory_budget(engine, rows):
    plan = port.launch_plan(WIDTHS, rows, engine, N_SMS, BUDGET)
    smem, units = port.plan_smem_bytes(WIDTHS, engine, plan.cluster, plan.stages)
    assert plan.smem_bytes == smem <= BUDGET
    geo = port.CLUSTER_KERNELS[engine]
    assert plan.units_per_cta == units <= geo.max_units
    assert plan.stages in (geo.stages or (0,))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("engine", ENGINES)
def test_grid_is_a_whole_number_of_clusters(engine, rows):
    plan = port.launch_plan(WIDTHS, rows, engine, N_SMS, BUDGET)
    assert plan.cluster in port.CLUSTER_SIZES
    assert plan.grid % plan.cluster == 0
    assert plan.grid == plan.tiles * plan.cluster


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("engine", ENGINES)
def test_every_row_is_covered_by_exactly_one_tile(engine, rows):
    plan = port.launch_plan(WIDTHS, rows, engine, N_SMS, BUDGET)
    assert plan.rows_per_tile == port.CLUSTER_KERNELS[engine].rows
    covered = np.zeros(rows, dtype=int)
    for tile in range(plan.tiles):
        covered[tile * plan.rows_per_tile:(tile + 1) * plan.rows_per_tile] += 1
    assert (covered == 1).all()
    assert (plan.tiles - 1) * plan.rows_per_tile < rows  # no tile lies past the batch


@pytest.mark.parametrize("engine", ENGINES)
def test_a_256_row_batch_spreads_over_more_ctas_than_pr1(engine):
    plan = port.launch_plan(WIDTHS, 256, engine, N_SMS, BUDGET)
    assert plan.grid > PR1_BLOCKS_AT_256


@pytest.mark.parametrize("engine", ENGINES)
def test_few_rows_take_a_cluster_no_smaller_than_many(engine):
    small = port.launch_plan(WIDTHS, 8, engine, N_SMS, BUDGET)
    large = port.launch_plan(WIDTHS, 4096, engine, N_SMS, BUDGET)
    assert small.cluster >= large.cluster


#: clusters of each size an H100 SXM holds at once for the served stack
#: (cudaOccupancyMaxActiveClusters, as chip_smoke.py's timing-launch-plan
#: line reports them)
H100_CLUSTERS = {2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("engine, rows, cluster", [
    # int8: the fastest cluster of the sweep at every bucket
    ("kernel-int8", 256, 8), ("kernel-int8", 512, 4), ("kernel-int8", 4096, 2),
    # bf16: one request's bucket spreads over the most CTAs in one wave
    # (clusters of 4 and 8 are about 10% faster there); at 512 rows the
    # sweep's clusters of 4 and 8 are within 7%
    ("kernel-bf16", 256, 16), ("kernel-bf16", 512, 8), ("kernel-bf16", 4096, 2),
])
def test_the_plan_on_the_cards_own_cluster_counts(engine, rows, cluster):
    assert port.launch_plan(WIDTHS, rows, engine, N_SMS, BUDGET, H100_CLUSTERS).cluster == cluster


@pytest.mark.parametrize("engine", ENGINES)
def test_only_schedulable_cluster_sizes_are_planned(engine):
    """The card's own count of resident clusters (0: cannot run) rules."""
    plans = port.launch_plans(WIDTHS, 4096, engine, N_SMS, BUDGET, {4: 30, 8: 0, 16: 7})
    assert [p.cluster for p in plans] == [4, 16]
    assert port.launch_plan(WIDTHS, 4096, engine, N_SMS, BUDGET, {16: 7}).cluster == 16


@pytest.mark.parametrize("engine, widest", [("kernel-bf16", 1536), ("kernel-int8", 1600)])
def test_the_widest_layer_each_source_states(engine, widest):
    """The widest layer the header of each source says it serves fits, and
    one unit (64 features) more is refused."""
    assert port.launch_plans((1, widest, 1), 1, engine, N_SMS, BUDGET)
    with pytest.raises(ValueError, match="shared memory"):
        port.launch_plans((1, widest + 64, 1), 1, engine, N_SMS, BUDGET)


@pytest.mark.parametrize("engine", ENGINES)
def test_a_stack_too_wide_for_shared_memory_raises(engine):
    with pytest.raises(ValueError, match=f"{engine}: layer widths up to 2048"):
        port.launch_plan((3, 2048, 1), 256, engine, N_SMS, BUDGET)


def _params(n_features: int, hidden: tuple, seed: int = 0) -> dict:
    """Small seeded weights and a scaler, in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    sizes = (n_features, *hidden, 1)
    return params_from_jax({
        "net": {"layers": [
            {"w": rng.normal(size=(i, o)).astype(np.float32),
             "b": rng.normal(size=o).astype(np.float32)}
            for i, o in zip(sizes[:-1], sizes[1:])
        ]},
        "scaler": {"x_mean": np.full(n_features, 50.0, np.float32),
                   "x_std": np.full(n_features, 29.0, np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(14.0)},
    }, "cpu")


def _unpad(padded, widths, engine):
    """pad_layers' layout back to prepare_layers': the bf16 tiles
    unswizzled (chunk c of row r sits at c ^ (r % 8), an involution) and
    reassembled into W, every tensor sliced to the unpadded widths."""
    out = []
    for layer, k, n in zip(padded, widths[:-1], widths[1:]):
        w, scale = layer["w"], layer["scale"]
        if engine == "kernel-bf16":
            kc, units = w.shape[:2]
            swizzle = torch.arange(8)[None, :] ^ (torch.arange(64)[:, None] % 8)
            tiles = w[:, :, torch.arange(64)[:, None], swizzle]
            w = tiles.permute(1, 2, 0, 3, 4).reshape(units * 64, kc * 64)[:n, :k].t()
        else:
            w, scale = w[:k, :n], scale[:n]
        out.append({"w": w.contiguous(), "b": layer["b"][:n].contiguous(), "scale": scale})
    return out


def _layers(widths, compute_dtype, seed=0):
    rng = np.random.default_rng(seed)
    folded = [
        (torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)),
         torch.from_numpy(rng.normal(size=n).astype(np.float32)))
        for k, n in zip(widths[:-1], widths[1:])
    ]
    return port.prepare_layers(folded, compute_dtype)


@pytest.mark.parametrize("widths", [(1, 16, 16, 1), (3, 130, 70, 1), (5, 64, 1)])
def test_padded_bf16_weights_give_the_unpadded_output_exactly(widths):
    layers = _layers(widths, "bfloat16")
    padded = port.pad_layers(layers, "kernel-bf16")
    k_pad, n_pad = port.padded_widths(widths, "kernel-bf16")
    for layer, kp, np_ in zip(padded, k_pad, n_pad):
        assert layer["w"].shape == (kp // 64, np_ // 64, 64, 8, 8)
        assert layer["w"].dtype == torch.bfloat16 and layer["b"].shape == (np_,)
    unpadded = _unpad(padded, widths, "kernel-bf16")
    for got, want in zip(unpadded, layers):
        assert torch.equal(got["w"], want["w"]) and torch.equal(got["b"], want["b"])
    X = torch.from_numpy(np.random.default_rng(1).uniform(0, 100, (37, widths[0])).astype(np.float32))
    assert torch.equal(port.mlp_stack_plain(unpadded, X, "bfloat16"),
                       port.mlp_stack_plain(layers, X, "bfloat16"))


def test_bf16_tiles_are_stored_in_the_128_byte_swizzle():
    """Row r of a 64 x 64 tile keeps logical 16-byte chunk c at position
    c ^ (r % 8), the layout a 128-byte-swizzled wgmma descriptor reads."""
    widths = (64, 64, 1)
    layers = _layers(widths, "bfloat16")
    tile = port.pad_layers(layers, "kernel-bf16")[0]["w"][0, 0]  # (row, chunk, 8)
    wt = layers[0]["w"].t()  # row n of W^T holds column n of W
    for r in range(64):
        for c in range(8):
            assert torch.equal(tile[r, c ^ (r % 8)], wt[r, 8 * c:8 * c + 8])
    last = port.pad_layers(layers, "kernel-bf16")[1]["w"][0, 0]  # N = 1 padded to 64
    assert not last[1:].float().any()


def test_padded_int8_weights_are_zero_with_unit_scale_past_the_stack():
    widths = (3, 70, 1)
    layers = _layers(widths, "int8")
    padded = port.pad_layers(layers, "kernel-int8")
    first, last = padded
    assert first["w"].shape == (32, 128) and last["w"].shape == (128, 64)
    assert not first["w"][3:].any() and not first["w"][:, 70:].any()
    assert torch.equal(first["scale"][70:], torch.ones(58))
    assert not first["b"][70:].any()
    for got, want in zip(_unpad(padded, widths, "kernel-int8"), layers):
        assert torch.equal(got["w"], want["w"]) and torch.equal(got["scale"], want["scale"])


@pytest.mark.parametrize("engine, dtype, bad", [
    ("kernel", None, 64), ("kernel-bf16", "bfloat16", 32), ("kernel-int8", "int8", 64),
])
def test_block_rows_outside_the_engines_own_set_raise(engine, dtype, bad):
    params = _params(1, (8,))
    with pytest.raises(ValueError, match="block_rows"):
        port.make_kernel_mlp_apply(params, "cpu", compute_dtype=dtype, block_rows=bad)


def test_cluster_pins_are_checked():
    params = _params(1, (8,))
    with pytest.raises(ValueError, match="cluster must be one of"):
        port.make_kernel_mlp_apply(params, "cpu", cluster=3)
    assert port.make_kernel_mlp_apply(params, "cpu", block_rows=32, cluster=2).engine == "kernel"
    with pytest.raises(ValueError, match="cluster must be one of"):
        port.make_kernel_mlp_apply(params, "cpu", compute_dtype="int8", cluster=3)
    apply = port.make_kernel_mlp_apply(params, "cpu", compute_dtype="bfloat16",
                                       block_rows=64, cluster=16)
    assert apply.engine == "kernel-bf16" and apply.launch is None


def _extern_c_functions(source: str) -> set:
    names = set()
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', source, re.S):
        names |= set(re.findall(r"^\S[^\n(]*?\b(\w+)\(", block, re.M))
    return names


def test_every_c_entry_point_is_declared_and_every_declaration_exists():
    assert set(_build.SOURCES) == set(_build.DECLARATIONS)
    for name, path in _build.SOURCES.items():
        assert path.parent == CSRC and path.exists()
        assert _extern_c_functions(path.read_text()) == set(_build.DECLARATIONS[name])
    for library, entry in port._ENTRY_POINTS.values():
        assert entry in _build.DECLARATIONS[library]
    assert set(port._ENTRY_POINTS) == set(port.LAUNCHES) == {"kernel", "kernel-bf16", "kernel-int8"}
    assert sorted(p.name for p in CSRC.glob("*.cu")) == sorted(p.name for p in _build.SOURCES.values())


@pytest.mark.parametrize("path", sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]),
                         ids=lambda p: p.name)
def test_no_source_calls_a_library_gemm(path):
    code = path.read_text()
    for banned in ("cublas", "cutlass::gemm::device", "at::"):
        assert banned not in code, f"{path.name} mentions {banned}"


def test_the_cluster_kernels_use_their_hopper_instructions():
    bf16 = (CSRC / "mlp_bf16_tc.cu").read_text()
    int8 = (CSRC / "mlp_int8.cu").read_text()
    assert "wgmma.mma_async" in bf16 and "cp.async.bulk" in bf16
    assert "fmaf(" in int8 and "cp.async.cg" in int8 and "wgmma" not in int8
    assert "mapa.shared::cluster" in bf16 and "map_shared_rank" in int8
    common = (CSRC / "cluster_common.cuh").read_text()
    assert "cudaLaunchKernelEx" in common and "cudaLaunchAttributeClusterDimension" in common
    assert "cudaOccupancyMaxActiveClusters" in common
    for code in (bf16, int8):
        assert '#include "cluster_common.cuh"' in code
        assert "launch_clusters(" in code and "max_active_clusters(" in code
    f32 = (CSRC / "mlp_kernel.cu").read_text()
    assert "mlp_forward_bf16" not in f32 and "mlp_forward_int8" not in f32


def _bf16_step_of(nu: int, g: int) -> tuple:
    """(first unit, units) of ring step g of a CTA's slice of nu units, as
    ``groups_of`` / ``per_step`` in mlp_bf16_tc.cu split it."""
    groups = max(1, -(-nu // 4))
    per = -(-nu // groups)
    return g * per, max(0, min(per, nu - g * per))


@pytest.mark.parametrize("nu", range(9))
def test_bf16_ring_steps_give_a_warpgroup_units_in_every_step_or_none(nu):
    """A ring stage is recycled after ``wgmma.wait_group 1``, which retires
    the group that read it only if the warpgroup committed a group in
    every step since: so within a layer each warpgroup (units wg, wg + 2 of
    a step) must have units in every step or in none."""
    groups = max(1, -(-nu // 4))
    steps = [_bf16_step_of(nu, g) for g in range(groups)]
    assert [first + i for first, count in steps for i in range(count)] == list(range(nu))
    assert all(count <= 4 for _, count in steps)
    for wg in (0, 1):
        assert len({wg < count for _, count in steps}) == 1
    bf16 = (CSRC / "mlp_bf16_tc.cu").read_text()
    assert "return max(1, (nu + BF_STAGE_UNITS - 1) / BF_STAGE_UNITS);" in bf16
    assert "return (nu + groups - 1) / groups;" in bf16
    helper = bf16[bf16.index("void issue_products("):bf16.index("mlp_bf16_kernel(")]
    assert "wgmma_commit();" in helper
