"""The trainer's tensor-core products (``ops/train_gemm.py``,
``ops/csrc/train_gemm.cu``) held on the CPU: which of a training step's
products take the kernel (the shape gate, and the routing of the weight
gradients alone through it), the plain path bit for bit against the
autograd of ``h @ w + b``, the kernel's split arithmetic emulated in torch
against float64, a static check of the source, and the ``fit`` span's
count. The kernel runs only on the card (``chip_smoke.py`` phase
``train-gemm``)."""
import ast
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu_torch.models import mlp
from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor
from bodywork_tpu_torch.obs.spans import SpanRecorder, recording
from bodywork_tpu_torch.ops import _build
from bodywork_tpu_torch.ops import train_gemm as tg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE_PATH = ROOT / "bodywork_tpu_torch" / "ops" / "csrc" / "train_gemm.cu"
SOURCE = SOURCE_PATH.read_text()
DEFINES = {name: int(v) for name, v in re.findall(r"#define (TG_\w+) (\d+)\b", SOURCE)}
#: config 6: 32 features, three hidden layers of 1024, a 1-wide head
CONFIG6 = (32, 1024, 1024, 1024, 1)
#: the bar chip_smoke.py holds the kernel to against float64, as
#: max|C - C64| / max|C64|
BAR = 1e-5


def _chip_smoke_constant(name: str):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


# -- the gate ----------------------------------------------------------------


def _step_products(widths, batch):
    """Every product of one training step: (layer, kind, M, N, K)."""
    out = []
    for i, (k, n) in enumerate(zip(widths[:-1], widths[1:])):
        out.append((i, "forward", batch, n, k))
        out.append((i, "weight_grad", k, n, batch))
        if i > 0:
            out.append((i, "input_grad", batch, k, n))
    return out


@pytest.mark.parametrize("widths, batch, device, compute_dtype, engaged", [
    (CONFIG6, 32768, "cuda", None, [(1, "weight_grad"), (2, "weight_grad")]),
    (CONFIG6, 8192, "cuda", None, [(1, "weight_grad"), (2, "weight_grad")]),
    ((1, 64, 64, 1), 256, "cuda", None, []),          # MLPConfig's defaults
    ((1, *mlp.MLPConfig().hidden, 1), MLPConfig().batch_size, "cuda", None, []),
    (CONFIG6, 32768, "cuda", "bfloat16", []),
    (CONFIG6, 32768, "cpu", None, []),
])
def test_the_gate_table(widths, batch, device, compute_dtype, engaged):
    """Of a step's products the weight gradients whose M, N and K are all
    at least 1024 take the kernel: at config 6 the two 1024 x 1024
    layers', at either batch; the first layer's (M = 32) and the head's
    (N = 1) stay on cuBLAS, as do every forward and input gradient."""
    got = [(i, kind) for i, kind, m, n, k in _step_products(widths, batch)
           if kind == "weight_grad" and compute_dtype is None and tg.engages(m, n, k, device)]
    assert got == engaged
    assert tg.step_products(widths, batch, device, compute_dtype) == len(engaged)
    flags = tg.kernel_layers(zip(widths[:-1], widths[1:]), batch, device, compute_dtype)
    assert [i for i, tc in enumerate(flags) if tc] == [i for i, _ in engaged]
    # the shape gate alone would take every 1024-wide product of config 6
    if widths == CONFIG6 and device == "cuda":
        shaped = [(i, kind) for i, kind, m, n, k in _step_products(widths, batch)
                  if tg.engages(m, n, k, "cuda")]
        assert shaped == [(i, kind) for i in (1, 2)
                          for kind in ("forward", "weight_grad", "input_grad")]


@pytest.mark.parametrize("m, n, k, ok", [
    (1024, 1024, 1024, True), (1024, 1024, 32768, True), (8232, 1024, 1024, True),
    (1020, 1024, 1024, False), (1024, 1022, 1024, False), (1024, 1024, 1040, False),
    (1024, 1024, 1056, True), (32, 1024, 32768, False), (1024, 1, 32768, False),
])
def test_the_shape_gate(m, n, k, ok):
    assert tg.engages(m, n, k, "cuda") is ok
    assert not tg.engages(m, n, k, "cpu")
    assert not tg.engages(m, n, k, "cuda", torch.bfloat16)


@pytest.mark.parametrize("compute_dtype, expected", [(None, 2), ("bfloat16", 0)])
def test_a_step_routes_only_its_weight_gradients_to_the_kernel(monkeypatch, compute_dtype,
                                                               expected):
    """One training step with the gate widened to the CPU and the weight
    gradient replaced by a recorder: only the weight gradients of the
    layers whose shape passes reach it, with their h and dY, and the
    step's gradients are those of plain autograd."""
    seen = []

    def record(h, dy):
        seen.append((tuple(h.shape), tuple(dy.shape)))
        return h.t() @ dy

    monkeypatch.setattr(tg, "weight_grad", record)
    monkeypatch.setattr(tg, "engages", lambda m, n, k, device_type, dtype=torch.float32: (
        dtype == torch.float32 and min(m, n, k) >= 64))
    widths, batch = (8, 64, 64, 64, 1), 96
    rng = np.random.default_rng(0)
    net = {"layers": [{"w": torch.tensor(rng.normal(size=(i, o)) * 0.2, dtype=torch.float32,
                                         requires_grad=True),
                       "b": torch.tensor(rng.normal(size=o) * 0.1, dtype=torch.float32,
                                         requires_grad=True)}
                      for i, o in zip(widths[:-1], widths[1:])]}
    X = torch.tensor(rng.normal(size=(batch, widths[0])), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=batch), dtype=torch.float32)
    w = torch.ones(batch)
    leaves = [t for layer in net["layers"] for t in (layer["w"], layer["b"])]
    tc_layers = tg.kernel_layers(zip(widths[:-1], widths[1:]), batch, "cpu", compute_dtype)
    assert tc_layers == ((False, True, True, False) if compute_dtype is None else (False,) * 4)
    grads = torch.autograd.grad(mlp._loss(net, X, y, w, compute_dtype, tc_layers), leaves)
    want = torch.autograd.grad(
        torch.sum(w * (mlp.mlp_forward(net, X, compute_dtype) - y) ** 2) / batch, leaves)
    assert len(seen) == expected
    if expected:
        # h (96 x 64) and dY (96 x 64), layers 2 and 1
        assert seen == [((96, 64), (96, 64))] * 2
    for g, v in zip(grads, want):
        assert torch.equal(g, v)


def test_split_count_fills_the_card():
    assert tg.split_count(32768, 1024, 1024, 132) == 1
    assert tg.split_count(1024, 1024, 32768, 132) == 2  # 128 CTAs: one wave
    for m, k in ((1024, 8192), (1064, 8192), (2048, 32768), (1024, 1024)):
        s = tg.split_count(m, 1024, k, 132)
        assert 1 <= s <= min(tg.MAX_SPLITS, k // tg.TILE_K)


# -- the plain path ----------------------------------------------------------


@pytest.mark.parametrize("rows, d_in, d_out, h_grad", [
    (64, 16, 24, True), (33, 7, 5, True), (128, 40, 1, True), (50, 1, 12, False),
])
def test_the_plain_path_is_the_autograd_of_h_at_w_plus_b(rows, d_in, d_out, h_grad):
    """On the CPU ``train_product(h, w) + b`` gives the forward, the input
    gradient, the weight gradient and the bias gradient of ``h @ w + b``
    bit for bit, and launches nothing."""
    rng = np.random.default_rng(rows)
    h0 = torch.tensor(rng.normal(size=(rows, d_in)), dtype=torch.float32)
    w0 = torch.tensor(rng.normal(size=(d_in, d_out)), dtype=torch.float32)
    b0 = torch.tensor(rng.normal(size=d_out), dtype=torch.float32)
    up = torch.tensor(rng.normal(size=(rows, d_out)), dtype=torch.float32)
    tg.reset_launches()
    outs = []
    for fn in (tg.train_product, lambda h, w: h @ w):
        h = h0.clone().requires_grad_(h_grad)
        w, b = w0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        out = torch.relu(fn(h, w) + b)
        inputs = [w, b] + ([h] if h_grad else [])
        outs.append((out.detach(), torch.autograd.grad((out * up).sum(), inputs)))
    (got, got_grads), (want, want_grads) = outs
    assert torch.equal(got, want)
    assert len(got_grads) == len(want_grads)
    for g, v in zip(got_grads, want_grads):
        assert torch.equal(g, v)
    assert tg.LAUNCHES == {"split": 0, "product": 0, "reduce": 0}


def test_the_cpu_takes_the_plain_version_and_the_kernel_refuses_it():
    h, dy = torch.ones(2048, 1024), torch.ones(2048, 1024)
    tg.reset_launches()
    assert torch.equal(tg.weight_grad(h, dy), h.t() @ dy)
    assert tg.LAUNCHES == {"split": 0, "product": 0, "reduce": 0}
    with pytest.raises(ValueError, match="does not take"):
        tg.kernel_weight_grad(h, dy)


def test_a_fit_reads_the_gate_once_and_the_daily_fit_runs_mlp_forward(monkeypatch):
    """The gate is read once a fit (the ``fit`` span's count, then the
    trainer's layers), not once a step; a fit with no engaged layer, as
    the daily fit is at ``MLPConfig``'s widths, runs ``mlp_forward``
    itself and never the trainer's own forward."""
    calls = []
    engages = tg.engages
    monkeypatch.setattr(tg, "engages", lambda *a, **kw: calls.append(a) or engages(*a, **kw))

    def refuse(*args):
        raise AssertionError("a fit with no engaged layer ran _train_forward")

    monkeypatch.setattr(mlp, "_train_forward", refuse)
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 100, (600, 1)).astype(np.float32)
    y = (0.4 * X[:, 0] + rng.normal(size=600)).astype(np.float32)
    cfg = MLPConfig(n_steps=7)
    assert (cfg.hidden, cfg.batch_size) == ((64, 64), 256)
    MLPRegressor(cfg).fit(X, y, device="cpu")
    assert calls == [(1, 64, 256, "cpu"), (64, 64, 256, "cpu"), (64, 1, 256, "cpu")] * 2


# -- the split arithmetic ----------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does, low 13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split (``split_tf32``): hi = x rounded to TF32, lo =
    x - hi (exact) truncated to TF32."""
    hi = tf32(x)
    return hi, truncate(x - hi)


def emulate(a: torch.Tensor, b: torch.Tensor, run_k: int, splits: int = 1,
            terms: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: per k-tile pair (``run_k`` k) the
    products lo.hi + hi.lo + hi.hi of TF32 parts (exact in f32) summed in
    f32, each run promoted into an f32 sum; split-K partial sums added in
    split order. ``terms=1`` keeps hi.hi alone (1xTF32)."""
    k = a.shape[1]
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    per = -(-k // splits)
    out = None
    for z in range(splits):
        part = torch.zeros(a.shape[0], b.shape[1])
        for k0 in range(z * per, min(k, (z + 1) * per), run_k):
            s = slice(k0, min(k0 + run_k, (z + 1) * per))
            run = a_hi[:, s] @ b_hi[s]
            if terms == 3:
                run = a_lo[:, s] @ b_hi[s] + a_hi[:, s] @ b_lo[s] + run
            part += run
        out = part if out is None else out + part
    return out


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name, m, n, k, splits", [
    ("forward", 64, 48, 1024, 1),        # h @ w: K = the layer's input width
    ("input_grad", 48, 64, 1024, 1),     # dY @ w.T: K = the layer's output width
    ("weight_grad", 64, 48, 32768, 2),   # h.T @ dY: K = config 6's batch, split in 2
])
def test_the_split_arithmetic_meets_the_bar_and_one_tf32_product_does_not(name, m, n, k,
                                                                           splits):
    """Why three TF32 products a product: the emulated kernel, promoting
    every k-tile pair, stays well inside the card's bar against float64 at
    each product's K (1.3e-6 at K = 32768), as close as IEEE float32 itself;
    one TF32 product (3e-4) fails the bar, so the bar tells them apart."""
    run_k = 2 * DEFINES["TG_BK"]
    assert run_k <= 64
    gen = torch.Generator().manual_seed(k + m)
    a = torch.relu(torch.randn(m, k, generator=gen))
    b = torch.randn(k, n, generator=gen) * 0.03
    exact = a.double() @ b.double()
    err3 = _err(emulate(a, b, run_k, splits), exact)
    err1 = _err(emulate(a, b, run_k, splits, terms=1), exact)
    assert err3 <= 2e-6 < BAR < err1
    assert _err(a @ b, exact) <= 2e-6


def test_the_split_is_exact_to_two_to_the_minus_21():
    x = torch.tensor([np.float32(np.pi), -1.1e-3, 7.75e4, 1.0, -3.0e-30], dtype=torch.float32)
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    gap = (hi.double() + lo.double() - x.double()).abs()
    assert bool((gap <= 2.0 ** -21 * x.double().abs()).all())


# -- the source ----------------------------------------------------------------


def test_the_library_is_built_and_declared():
    assert _build.SOURCES["train_gemm"] == SOURCE_PATH
    assert set(_build.DECLARATIONS["train_gemm"]) == {
        "train_gemm", "train_gemm_split", "train_gemm_error_string"}


def test_every_kernel_name_holds_gemm_and_every_launch_is_checked():
    """The benchmark's ``gemm_roofline.train`` counts kernels named with
    ``gemm``: every ``__global__`` function of the source has it, so the
    roofline reads the split pass and the split-K reduction too. Each
    launch is followed by ``cudaGetLastError()`` before anything else."""
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", SOURCE)
    assert sorted(kernels) == ["train_gemm_kernel", "train_gemm_split_kernel",
                               "train_gemm_splitk_reduce_kernel"]
    assert all("gemm" in name for name in kernels)
    launches = [mt.end() for mt in re.finditer(r">>>\(", SOURCE)]
    assert len(launches) == 3
    for end in launches:
        after = SOURCE[end:].split(";", 2)
        assert "cudaGetLastError()" in after[1], after[:2]


def test_the_source_is_a_3xtf32_wgmma_kernel_with_promoted_sums():
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in SOURCE
    assert "cvt.rna.tf32.f32" in SOURCE and SOURCE.count("0xffffe000u") == 2
    assert "cp.async.bulk.tensor.2d" in SOURCE and "cp.async.bulk.shared::cluster" in SOURCE
    assert "setmaxnreg" in SOURCE
    # small terms first, into an accumulator that each k-tile pair starts afresh
    products = re.findall(r"wgmma_tf32<(?:\w+)>\(acc, (\w+)\[kk\], (d\w)", SOURCE)
    assert products == [("lo", "dh"), ("lo", "dh"), ("hi", "dl"), ("hi", "dh")]
    assert "sum[i] += acc[i];" in SOURCE
    # no atomics: a seeded fit gives the same bits twice
    assert "atomic" not in SOURCE.lower().replace("no atomics", "")
    for banned in ("cublas", "cutlass", "at::"):
        assert banned not in SOURCE


def test_the_wrapper_mirrors_the_source():
    assert (tg.TILE_M, tg.TILE_N, tg.TILE_K) == (
        DEFINES["TG_BM"], DEFINES["TG_BN"], DEFINES["TG_BK"])
    assert _chip_smoke_constant("TRAIN_GEMM_BAR") == BAR


def test_only_the_trainer_reaches_the_kernel():
    """The serving engines, the tenancy stack and the sharded forward
    never call the trainer's products: only ``models/mlp.py`` imports the
    module, and ``mlp_forward`` / ``mlp_apply`` keep ``h @ w``."""
    package = ROOT / "bodywork_tpu_torch"
    users = sorted(str(p.relative_to(package)) for p in package.rglob("*.py")
                   if "train_gemm" in p.read_text() and p.name != "train_gemm.py")
    assert users == ["models/mlp.py", "ops/_build.py"]
    for fn in (mlp.mlp_forward, mlp.mlp_apply):
        assert "train_product" not in inspect.getsource(fn)


# -- the fit span ----------------------------------------------------------------


def test_a_recorded_cpu_fit_counts_no_tensor_core_products():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 100, (300, 2)).astype(np.float32)
    y = (0.4 * X[:, 0] + rng.normal(size=300)).astype(np.float32)
    rec = SpanRecorder()
    with recording(rec):
        MLPRegressor(MLPConfig(hidden=(8, 8), batch_size=32, n_steps=3)).fit(X, y, device="cpu")
    (fit,) = [s for s in rec.spans() if s.name == "fit"]
    assert fit.meta["tc_products"] == 0
    assert mlp._tc_products(MLPConfig(hidden=(1024,) * 3, batch_size=32768), 32,
                            torch.device("cuda")) == 2
