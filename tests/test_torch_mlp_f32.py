"""The port's f32 fused-MLP kernel (``kernel``, ``ops/csrc/mlp_kernel.cu``)
held on the CPU: its split-TF32 arithmetic emulated in torch against a
float64 stack, its padded weights, its launch plan, the widest layer its
source states, its shared-memory index maps and fragment maps (read from
the source itself), and a static check of the source. The kernel runs only
on the card (``chip_smoke.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu_torch.models.mlp import params_from_jax
from bodywork_tpu_torch.ops import mlp_kernel as port

torch.set_num_threads(1)

SOURCE = (Path(port.__file__).resolve().parent / "csrc" / "mlp_kernel.cu").read_text()
N_SMS = 132
BUDGET = 232_448
#: the bar chip_smoke.py holds the kernel to, as max|err| / max(1, max|ref|)
BAR = 1e-4


def _params(widths, seed: int = 0) -> dict:
    """He-init weights, small biases and the pipeline's scaler, in the JAX
    package's layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n_features = widths[0]
    return params_from_jax({
        "net": {"layers": [
            {"w": (rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32),
             "b": (rng.normal(size=o) * 0.1).astype(np.float32)}
            for i, o in zip(widths[:-1], widths[1:])
        ]},
        "scaler": {"x_mean": np.full(n_features, 50.0, np.float32),
                   "x_std": np.full(n_features, 29.0, np.float32),
                   "y_mean": np.float32(26.0), "y_std": np.float32(14.0)},
    }, "cpu")


def _layers(widths, seed: int = 0) -> list[dict]:
    return port.prepare_layers(port.fold_scaler_into_net(_params(widths, seed)))


def _inputs(rows: int, n_features: int, seed: int = 1) -> torch.Tensor:
    X = np.random.default_rng(seed).uniform(0, 100, (rows, n_features))
    return torch.from_numpy(X.astype(np.float32))


# -- the split-TF32 arithmetic ----------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (nearest, ties away
    from zero: f32 is sign-magnitude, so adding half an ulp to the bits
    rounds the magnitude), with the low 13 bits cleared as the kernel
    clears them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 bits cleared (TF32, rounded toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: hi = x rounded to TF32, lo = x - hi (exact in
    f32) truncated to TF32."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each
    term a product of TF32 values (exact in f32) summed in f32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _stack(layers, X, matmul, dtype=torch.float32) -> torch.Tensor:
    h = X.to(dtype)
    for i, layer in enumerate(layers):
        h = matmul(h, layer["w"].to(dtype)) + layer["b"].to(dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


def _err_over_scale(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max() / max(1.0, float(want.abs().max())))


def test_tf32_rounds_to_nearest_with_ties_away_and_clears_the_low_bits():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 bits after the point
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4, 3.0e-3, -7.5], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp,
                         float(tf32(torch.tensor([3.0e-3]))), -7.5])
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    hi, lo = split(torch.tensor([np.float32(np.pi)]))
    assert abs(float(hi.double() + lo.double()) - float(np.float32(np.pi))) <= 2.0 ** -21 * np.pi
    assert not (lo.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("widths", [(1, 256, 256, 1), (3, 130, 70, 1)])
def test_three_tf32_products_meet_the_bar_and_one_does_not(widths):
    """Why the kernel issues three TF32 products a product: the emulated
    3xTF32 stack stays within 1e-5 of scale of the float64 stack, well
    inside chip_smoke.py's 1e-4 bar; one TF32 product a product does not
    meet that bar, so the bar tells the two apart."""
    layers = _layers(widths)
    X = _inputs(512, widths[0])
    ref = _stack(layers, X, torch.matmul, torch.float64)
    err3 = _err_over_scale(_stack(layers, X, tf32x3_matmul), ref)
    err1 = _err_over_scale(_stack(layers, X, tf32_matmul), ref)
    assert err3 <= 1e-5
    assert err1 > BAR
    # and f32 FMA itself reads in the same range as 3xTF32
    assert _err_over_scale(_stack(layers, X, torch.matmul), ref) <= 1e-5


# -- padded weights ----------------------------------------------------------


@pytest.mark.parametrize("widths", [(1, 16, 16, 1), (3, 130, 70, 1), (5, 64, 1), (1, 1024, 1)])
def test_padded_f32_weights_give_the_unpadded_output_exactly(widths):
    layers = _layers(widths)
    padded = port.pad_layers(layers, "kernel")
    k_pad, n_pad = port.padded_widths(widths, "kernel")
    assert k_pad[0] % 16 == 0 and all(n % 64 == 0 for n in n_pad)
    unpadded = []
    for layer, want, kp, np_, k, n in zip(padded, layers, k_pad, n_pad, widths[:-1], widths[1:]):
        w, b = layer["w"], layer["b"]
        assert w.shape == (kp, np_) and w.dtype == torch.float32 and b.shape == (np_,)
        assert layer["scale"] is None
        assert not w[k:].any() and not w[:, n:].any() and not b[n:].any()
        unpadded.append({"w": w[:k, :n], "b": b[:n], "scale": None})
        assert torch.equal(unpadded[-1]["w"], want["w"])
        assert torch.equal(unpadded[-1]["b"], want["b"])
    X = _inputs(37, widths[0])
    assert torch.equal(port.mlp_stack_plain(unpadded, X), port.mlp_stack_plain(layers, X))


# -- the launch plan -----------------------------------------------------------

WIDTHS = (1, 1024, 1024, 1024, 1)


@pytest.mark.parametrize("rows", [1, 8, 256, 300, 512, 4096])
def test_the_f32_plan_takes_the_deepest_ring_that_fits(rows):
    plan = port.launch_plan(WIDTHS, rows, "kernel", N_SMS, BUDGET)
    assert plan.rows_per_tile == 32
    smem, units = port.plan_smem_bytes(WIDTHS, "kernel", plan.cluster, plan.stages)
    assert plan.smem_bytes == smem <= BUDGET
    assert plan.stages == 6 or port.plan_smem_bytes(
        WIDTHS, "kernel", plan.cluster, plan.stages + 1)[0] > BUDGET


#: clusters of each size an H100 SXM holds at once for the served stack
#: (``clusters_resident`` of chip_smoke.py's timing-launch-plan line)
H100_CLUSTERS = {2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("rows, cluster", [(1, 16), (8, 16), (256, 8), (300, 8), (512, 4),
                                           (4096, 2)])
def test_the_f32_plan_on_the_cards_own_cluster_counts(rows, cluster):
    """The picks chip_smoke.py's timing-launch-plan sweep supports on an
    H100 SXM (700 W): clusters of 8 at 256 rows (0.142 ms; 2, 4 and 16 took
    0.350, 0.220 and 0.175), of 4 at 512 (0.210; 16 took 0.242) and of 2
    at 4096 (0.617; 4 took 0.838). One row tile spreads over a cluster of
    16, the one-wave rule for a single request."""
    assert port.launch_plan(WIDTHS, rows, "kernel", N_SMS, BUDGET, H100_CLUSTERS).cluster == cluster


def test_the_f32_shared_memory_budget_the_source_states():
    """The figures of the source's header: at width 1024 every cluster size
    takes 3 stages of 32 KB in 229,376 bytes; a stage of 32 k-rows of 8
    units (64 KB) would not leave room for 2 of them."""
    got = {p.cluster: (p.stages, p.smem_bytes)
           for p in port.launch_plans(WIDTHS, 4096, "kernel", N_SMS, BUDGET)}
    assert got == {c: (3, 229_376) for c in (2, 4, 8, 16)}
    assert 32 * 1024 * 4 + 2 * 32 * 8 * 64 * 4 > BUDGET


def _stated_widest() -> int:
    m = re.search(r"The widest layer this kernel serves\s*(?://\s*)?is (\d+) features", SOURCE)
    assert m, "the source's header states the widest layer it serves"
    return int(m.group(1))


def test_the_widest_layer_the_source_states():
    widest = _stated_widest()
    assert widest == 1280
    assert port.launch_plans((1, widest, 1), 1, "kernel", N_SMS, BUDGET)
    assert port.launch_plans((3, widest, 40, 1), 1, "kernel", N_SMS, BUDGET)
    with pytest.raises(ValueError, match="shared memory"):
        port.launch_plans((1, widest + 64, 1), 1, "kernel", N_SMS, BUDGET)


# -- the shared-memory index maps and fragment maps, read from the source --


def _device_int_fn(name: str):
    """A one-line ``__device__`` int function of the source as a Python
    function (C and Python rank + - * << >> & ^ | alike)."""
    m = re.search(rf"int {name}\(([^)]*)\) \{{\s*return (.*?);\s*\}}", SOURCE, re.S)
    assert m, name
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = m.group(2)
    for macro in ("F_M",):
        body = body.replace(macro, str(int(re.search(rf"#define {macro} (\d+)", SOURCE).group(1))))
    assert re.fullmatch(r"[\w\s()+*<>&^|-]+", body), body
    return eval(f"lambda {', '.join(args)}: {body}")  # noqa: S307 - the repo's own source


act_slot = _device_int_fn("act_slot")
stage_slot = _device_int_fn("stage_slot")
frag_a_row, frag_a_k = _device_int_fn("frag_a_row"), _device_int_fn("frag_a_k")
frag_b_k, frag_b_col = _device_int_fn("frag_b_k"), _device_int_fn("frag_b_col")
frag_c_row, frag_c_col = _device_int_fn("frag_c_row"), _device_int_fn("frag_c_col")
LANES = range(32)


def test_the_fragment_maps_cover_each_tile_once():
    """PTX's m16n8k8 .tf32 fragments: A's 4 values a lane over 32 lanes are
    the 16 x 8 tile, B's 2 the 8 x 8 tile, C's 4 the 16 x 8 tile."""
    a = {(frag_a_row(lane, i), frag_a_k(lane, i)) for lane in LANES for i in range(4)}
    b = {(frag_b_k(lane, i), frag_b_col(lane)) for lane in LANES for i in range(2)}
    c = {(frag_c_row(lane, i), frag_c_col(lane, i)) for lane in LANES for i in range(4)}
    assert a == {(r, k) for r in range(16) for k in range(8)}
    assert b == {(k, n) for k in range(8) for n in range(8)}
    assert c == {(r, n) for r in range(16) for n in range(8)}
    # lane 4 g + t: A row g, k t; C row g, columns 2t, 2t + 1
    assert (frag_a_row(13, 0), frag_a_k(13, 0), frag_a_k(13, 2)) == (3, 1, 5)
    assert (frag_c_row(13, 3), frag_c_col(13, 0), frag_c_col(13, 1)) == (11, 2, 3)


@pytest.mark.parametrize("k_max", [16, 1024, 1664])
def test_act_slot_is_a_bijection_on_the_activation_tile(k_max):
    slots = [act_slot(k, r) for k in range(k_max) for r in range(32)]
    assert sorted(slots) == list(range(32 * k_max))
    # 4 aligned rows stay contiguous (the epilogue's peer copy moves whole
    # k-rows; nothing else relies on it)
    for k in range(8):
        for r in range(0, 32, 4):
            first = act_slot(k, r)
            assert [act_slot(k, r + i) for i in range(4)] == list(range(first, first + 4))


@pytest.mark.parametrize("units", [1, 2, 4, 8])
def test_stage_slot_is_a_bijection_on_a_ring_stage(units):
    pitch = units * 64
    slots = [stage_slot(kk, c, pitch) for kk in range(16) for c in range(pitch)]
    assert sorted(slots) == list(range(16 * pitch))
    # a 16-byte chunk (4 columns from a multiple of 4) stays one chunk, so
    # the cp.async copies land whole
    for kk in range(16):
        for c in range(0, pitch, 4):
            s0 = stage_slot(kk, c, pitch)
            assert s0 % 4 == 0
            assert [stage_slot(kk, c + i, pitch) for i in range(4)] == [s0 + i for i in range(4)]


def _banks(slots) -> list:
    return [s % 32 for s in slots]


@pytest.mark.parametrize("k0", [0, 8, 512, 1016])
@pytest.mark.parametrize("mt", [0, 1])
@pytest.mark.parametrize("i", range(4))
def test_an_a_fragment_load_reads_32_banks(k0, mt, i):
    banks = _banks(act_slot(k0 + frag_a_k(lane, i), 16 * mt + frag_a_row(lane, i))
                   for lane in LANES)
    assert len(set(banks)) == 32
    # unswizzled, the 4 lanes of a row group (same g) would share one bank
    plain = _banks((k0 + frag_a_k(lane, i)) * 32 + 16 * mt + frag_a_row(lane, i) for lane in LANES)
    for g in range(8):
        assert len(set(banks[4 * g:4 * g + 4])) == 4 and len(set(plain[4 * g:4 * g + 4])) == 1


@pytest.mark.parametrize("units", [1, 2, 8])
@pytest.mark.parametrize("ks", [0, 1])
@pytest.mark.parametrize("i", [0, 1])
def test_a_b_fragment_load_reads_32_banks(units, ks, i):
    pitch = units * 64
    for col0 in range(0, pitch, 8):  # every n8 tile of the slice
        banks = _banks(stage_slot(8 * ks + frag_b_k(lane, i), col0 + frag_b_col(lane), pitch)
                       for lane in LANES)
        assert len(set(banks)) == 32
        for g in range(8):  # the 4 lanes of one row group: 4 banks
            assert len(set(banks[4 * g:4 * g + 4])) == 4


def test_every_writer_and_reader_goes_through_the_two_helpers():
    """X staging and the epilogue write the activations at act_slot; the
    cp.async copies write a stage at stage_slot; the fragment loads read at
    offsets computed once per layer with the same helpers."""
    assert SOURCE.count("act[act_slot(") == 2
    assert "cp_async16(dst + stage_slot(kk, 4 * c, pitch)" in SOURCE
    assert "a_off[mt][h] = act_slot(frag_a_k(lane, h), 16 * mt + frag_a_row(lane, h));" in SOURCE
    assert ("b_off[j] = stage_slot(frag_b_k(lane, 0), unit * F_UNIT + 8 * j + frag_b_col(lane), "
            "pitch);") in SOURCE


@pytest.mark.parametrize("pitch", [64, 512])
def test_a_shift_of_k_by_a_multiple_of_4_moves_a_slot_by_whole_k_rows(pitch):
    """What lets the kernel compute each lane's fragment offsets once per
    layer: act_slot(k0 + k, r) = k0 * 32 + act_slot(k, r) and
    stage_slot(k0 + k, c) = k0 * pitch + stage_slot(k, c) when 4 divides k0."""
    for k0 in (0, 4, 8, 1016):
        for k in range(8):
            for r in range(32):
                assert act_slot(k0 + k, r) == k0 * 32 + act_slot(k, r)
            for c in range(0, pitch, 3):
                assert stage_slot(k0 + k, c, pitch) == k0 * pitch + stage_slot(k, c, pitch)


# -- the source ------------------------------------------------------------------


def test_the_f32_source_is_a_split_tf32_cluster_kernel():
    assert '#include "cluster_common.cuh"' in SOURCE
    assert "launch_clusters(" in SOURCE and "max_active_clusters(" in SOURCE
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in SOURCE
    assert "cvt.rna.tf32.f32" in SOURCE and SOURCE.count("0xffffe000u") == 2
    assert "map_shared_rank" in SOURCE and "cp.async.cg" in SOURCE
    assert "mlp_forward_kernel" not in SOURCE and "template <typename WT" not in SOURCE
    assert "wgmma" not in SOURCE
    # small terms first: lo.hi, hi.lo, then hi.hi into the same partial sum,
    # which meets the layer's accumulator in an f32 add once a chunk
    products = re.findall(r"mma_tf32\(part\[mt\]\[j\], (\w+)\[mt\], (\w+)\[j\]\[0\], "
                          r"\w+\[j\]\[1\]\);", SOURCE)
    assert products == [("alo", "bhi"), ("ahi", "blo"), ("ahi", "bhi")]
    assert "acc[mt][j][i] += part[mt][j][i];" in SOURCE
    # the header's geometry is the wrapper's
    geo = port.CLUSTER_KERNELS["kernel"]
    defines = {name: int(v) for name, v in re.findall(r"#define (F_\w+) (\d+)", SOURCE)}
    assert (defines["F_M"], defines["F_KC"], defines["F_UNIT"], defines["F_MAX_UNITS"]) == (
        geo.rows, geo.k_chunk, geo.unit, geo.max_units)
    assert geo.stages == tuple(range(defines["F_MIN_STAGES"], defines["F_MAX_STAGES"] + 1))
    assert geo.stage_unit_bytes == defines["F_KC"] * defines["F_UNIT"] * 4 and geo.act_bytes == 4
    assert geo.full_stages and geo.stage_units == defines["F_STAGE_UNITS"]


def test_the_f32_wrapper_has_one_path_on_the_cpu():
    """``kernel`` pins only its own row tile and a cluster size; on the CPU
    it runs the plain version and launches nothing."""
    params = _params((1, 16, 1))
    with pytest.raises(ValueError, match="block_rows must be 32"):
        port.make_kernel_mlp_apply(params, "cpu", block_rows=16)
    port.reset_launches()
    X = _inputs(10, 1)
    for cluster in port.CLUSTER_SIZES:
        apply = port.make_kernel_mlp_apply(params, "cpu", block_rows=32, cluster=cluster)
        assert apply.launch is None and apply.engine == "kernel"
        assert torch.equal(apply(X), port.mlp_stack_plain(apply.layers, X))
    assert port.LAUNCHES["kernel"] == 0
    for name in ("BLOCK_ROWS", "COLUMNS_PER_PASS", "activation_bytes", "_KernelLaunch"):
        assert not hasattr(port, name)
