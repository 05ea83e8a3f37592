#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bodywork_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. ``device``  — the card's name, compute capability (must be 9.0) and
   ``nvidia-smi`` name and power limit; then ``generator``: the drift
   generator's threefry draws for all 365 dates of 2026 on the card
   against the CPU (``X`` and the kept-row mask must be bit-equal; the
   ``eps`` and ``y`` gaps are printed in ulps) and the card's time for
   one day;
2. ``build``   — compiles the CUDA kernels from the repository's sources
   with ``nvcc``, one process per source, all started together
   (``ops/_build.py``), and prints the seconds and the compiler's
   register/shared-memory report;
3. ``kernels`` — each fused-MLP kernel (``kernel``: ``mlp_kernel.cu``;
   ``kernel-bf16``: ``mlp_bf16_tc.cu``; ``kernel-int8``: ``mlp_int8.cu``)
   at the served model's widths (1 -> 1024 -> 1024 -> 1024 -> 1) on {1, 8,
   300, 4096} rows, held against its plain PyTorch version on the card,
   with each launch's shape (row tile, cluster size, ring stages, dynamic
   shared memory), and the readings of cheaper arithmetic (``controls``),
   which each bar must refuse; ``kernels-ragged`` runs a ragged 3 -> 1100
   -> 40 -> 1 stack the same way at every cluster size the card schedules
   and checks that a stack past each kernel's shared memory is refused;
4. ``slice``   — the serving main path at full width: three days of drift
   data generated on the card, a (1024, 1024, 1024) MLP checkpoint with
   seeded He-init weights, ``serve_latest_model(engine="auto")`` (which
   must pick the ``kernel`` engine on ``cuda``), single and batch requests
   over HTTP checked against the plain version, then the port's test stage
   over HTTP on the latest day; ``slice-bf16`` / ``slice-int8`` serve the
   same checkpoint through the other two kernels; ``slice-auto-wide``
   serves a (1344, 1344, 1344) MLP, which the f32 kernel cannot launch, on
   ``auto``, which must resolve to the ``torch`` engine with no launch;
   ``slice-nan`` serves a model whose output is NaN through ``kernel``,
   which must answer 500 over HTTP without the value. Kernel launch counts
   are set to 0 just before each path and read just after it;
5. ``day-loop`` — the daily train -> registry gate -> serve -> generate
   -> test loop (``run_simulation``) for 7 simulated days on the card: the
   MLP at hidden (1024, 1024, 1024) trained with Adam (lr 1e-3, batch 256,
   2000 steps), registered as a candidate, gated, and served from the
   registry's ``production`` alias by ``auto``, which must resolve to
   ``kernel`` every day, with the kernel's launches counted over the loop
   (counts set to 0 just before it, read just after); every day's gate
   must have reached a decision and every day's served key must come from
   ``production``. Then the last day's checkpoint through the kernel held
   against its plain version; then a forced rejection on a copy of the
   store (``day-loop-gate-rejection``: a candidate whose metrics fail
   ``min_r2`` is rejected, and the serve stage serves the previous
   production through ``kernel``, launches counted); then the linear
   model's loop (the ``torch`` engine, no kernel). One line per day (the
   engine, the launches, the gate's verdict and seconds, the served key
   and its source, the train and test metrics, the wall-clock and the
   seconds of each stage), one line per loop, the float32 matrix
   product settings in force, and 20 Adam steps at width 1024 from one
   init and one index stream on the card and on the CPU: the first
   step's loss and gradients within 1e-5 (TF32 products must fail both
   bars) and the loss trajectories' largest relative gap; and a profiled
   window of 50 training steps (host time a step, the device's busy
   share, the kernels);
6. ``timing``  — per variant at the 256- and 4096-row buckets, with CUDA
   events (warm-up, then the median of 30): the kernel as one call
   (``kernel_ms``) and as replays of a captured CUDA graph, which leaves
   out the host's launch gaps (``kernel_graph_ms``), its plain version,
   and the folded stack through ``torch.addmm`` in the variant's dtype
   with TF32 off (a yardstick the port never calls), eager
   (``library_ms``) and from a graph (``library_graph_ms``), beside the
   card's bound; ``timing-launch-plan`` times every cluster size each
   kernel can take at 256, 512 and 4096 rows; then one ``kernels`` line
   summing every kernel up.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from datetime import date, timedelta

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTHS = (1, 1024, 1024, 1024, 1)  # the served model: hidden (1024, 1024, 1024)
HIDDEN = WIDTHS[1:-1]
VARIANTS = {"kernel": None, "kernel-bf16": "bfloat16", "kernel-int8": "int8"}
SOURCES = {
    "kernel": "bodywork_tpu_torch/ops/csrc/mlp_kernel.cu",
    "kernel-bf16": "bodywork_tpu_torch/ops/csrc/mlp_bf16_tc.cu",
    "kernel-int8": "bodywork_tpu_torch/ops/csrc/mlp_int8.cu",
}
REPLACES = {
    "kernel": "bodywork_tpu/ops/mlp_kernel.py:65",
    "kernel-bf16": "bodywork_tpu/ops/mlp_kernel.py:77",
    "kernel-int8": "bodywork_tpu/ops/mlp_kernel.py:86",
}
#: agreement with the plain version, as max|kernel - plain| / max(1, max|plain|):
#: the f32 and int8 kernels keep the plain arithmetic up to summation
#: order; bf16's tensor-core order may also flip the bf16 rounding of an
#: activation (1.1e-3 of scale at 4096 rows on an H100). Each bar must also
#: refuse the cheaper arithmetic of :func:`controls` (checked in ``kernels``),
#: so that it tells the kernel's design from a shortcut
BARS = {"kernel": 1e-4, "kernel-bf16": 2.5e-3, "kernel-int8": 1e-4}
KERNEL_ROWS = (1, 8, 300, 4096)
TIMING_ROWS = (256, 4096)
TIMING_REPS = 30
#: the day loop: 7 simulated days from this date; the MLP trained with the
#: repository's wide-training settings (``bench.py:1092-1094``)
LOOP_DAYS = 7
LOOP_START = date(2026, 7, 1)
LOOP_MLP = {"hidden": HIDDEN, "learning_rate": 1e-3, "batch_size": 256, "n_steps": 2000}
#: card against CPU: Adam steps, and the bars on the largest relative
#: gaps of the first step's loss and gradients, computed from the same
#: params on both sides: IEEE float32 differs there by summation order
#: alone (~5e-7 at width 1024 on an H100), TF32 products by ~1e-4 (loss)
#: and ~4e-3 (gradients). The loss trajectory over the 20 steps is
#: printed and has no bar: from the second step on, Adam's ±lr steps
#: carry each rounding difference forward (percents by step 20 on some
#: days' data, in IEEE float32 too)
PARITY_STEPS = 20
PARITY_BARS = {"loss_step0": 1e-5, "grad_step0": 1e-5}
#: Adam steps in the profiled window of the training loop
PROFILE_STEPS = 50
#: the generator phase: every date of this year on the card and the CPU,
#: and this many days timed on the card
GENERATOR_YEAR = date(2026, 1, 1)
GENERATOR_TIMED_DAYS = 30
#: a stack the f32 kernel cannot launch (its widest layer is 1280)
TOO_WIDE = (1, 1344, 1344, 1344, 1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets): f32 on the
    CUDA cores, TF32 and bf16 on the tensor cores (PCIe and NVL: half the
    sheet's with-sparsity figure), and the memory rate."""
    if "PCIe" in name:
        return {"part": "H100 PCIe", "f32": 51e12, "tf32": 378e12, "bf16": 756e12,
                "bytes_s": 2.0e12}
    if "NVL" in name:
        return {"part": "H100 NVL", "f32": 60e12, "tf32": 417.5e12, "bf16": 835e12,
                "bytes_s": 3.9e12}
    return {"part": "H100 SXM", "f32": 67e12, "tf32": 495e12, "bf16": 989e12,
            "bytes_s": 3.35e12}


def f32_product_ms(rows: int, card: dict) -> dict:
    """The two ways to run f32-accurate products on the card, in ms for
    one forward of ``rows`` rows: FFMA on the CUDA cores (2 operations a
    MAC at the f32 peak) and 3xTF32 on the tensor cores (three TF32
    products a MAC, 2 operations each, at the dense TF32 peak)."""
    macs = rows * sum(k * n for k, n in zip(WIDTHS[:-1], WIDTHS[1:]))
    return {"ffma_ms": 1e3 * 2 * macs / card["f32"],
            "tf32x3_ms": 1e3 * 3 * 2 * macs / card["tf32"]}


def bound(rows: int, engine: str, card: dict) -> tuple[float, str]:
    """The least time the card could take for one forward of ``rows``
    rows: the larger of its bytes (X read once, weights/biases/scales read
    once, the head written once) over the memory rate, and its operations
    over the peak rate for the operands' type. The f32 and int8 kernels
    need f32-accurate products: the faster of FFMA and 3xTF32
    (:func:`f32_product_ms`); the bf16 operands' peak is the tensor
    cores'."""
    pairs = list(zip(WIDTHS[:-1], WIDTHS[1:]))
    macs = rows * sum(k * n for k, n in pairs)
    weight_bytes = {"kernel": 4, "kernel-bf16": 2, "kernel-int8": 1}[engine]
    nbytes = (
        rows * WIDTHS[0] * 4 + sum(k * n for k, n in pairs) * weight_bytes
        + sum(n for _, n in pairs) * 4 * (2 if engine == "kernel-int8" else 1)
        + rows * 4
    )
    if engine == "kernel-bf16":
        t_ops = 2 * macs / card["bf16"]
    else:
        t_ops = 1e-3 * min(f32_product_ms(rows, card).values())
    t_bytes = nbytes / card["bytes_s"]
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(1.0, float(want.abs().max()))


def controls(torch, layers, X, dtype) -> dict:
    """The variant's function computed with cheaper arithmetic than its
    kernel claims, in plain torch ops: TF32 products (f32, int8), int8
    weights times activations rounded to bf16, and for bf16 activations
    left unrounded or weights rounded to fp8 (e4m3). Each one's output."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    if dtype == "bfloat16":
        fp8 = [{"w": layer["w"].to(torch.float8_e4m3fn).float(), "b": layer["b"]}
               for layer in layers]
        return {"f32-activations": mlp_stack_plain(layers, X, None),
                "fp8-weights": mlp_stack_plain(fp8, X, "bfloat16")}
    if dtype == "int8":
        layers = [{"w": layer["w"].float() * layer["scale"][None, :], "b": layer["b"]}
                  for layer in layers]
    out = {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["tf32"] = mlp_stack_plain(layers, X, None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    if dtype == "int8":
        out["bf16-activations"] = mlp_stack_plain(layers, X, "bfloat16")
    return out


def make_params(torch, dev, X: "torch.Tensor", y: "torch.Tensor", seed: int = 0,
                widths: tuple = WIDTHS) -> dict:
    """Seeded He-init weights (an explicit torch.Generator) and the
    scaler's statistics over the generated days."""
    from bodywork_tpu_torch.models.mlp import _masked_stats, init_mlp_params

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    net = init_mlp_params(gen, widths, device=dev)
    w = torch.ones(X.shape[0], device=dev)
    x_mean, x_std = _masked_stats(X, w)
    y_mean, y_std = _masked_stats(y, w)
    return {
        "net": net,
        "scaler": {"x_mean": x_mean[None], "x_std": x_std[None],
                   "y_mean": y_mean, "y_std": y_std},
    }


def post(url: str, payload) -> dict:
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(request, timeout=60) as resp:
        return json.loads(resp.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", name=name, capability=list(cap), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    return {"name": name, "smi": smi, **peaks(name)}


def _ulps(torch, a: "torch.Tensor", b: "torch.Tensor") -> int:
    """The most float32 ulps between two arrays of draws."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def phase_generator(torch, dev) -> dict:
    """The drift generator's draws for every date of 2026, on the card
    and on the CPU: ``X`` and the kept-row mask must be bit-equal."""
    from bodywork_tpu_torch.data import prng
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.data.generator import _sample_day, generate_day, key_for_date
    from bodywork_tpu_torch.utils.dates import day_of_year

    cfg = DriftConfig()

    def draws(d, device):  # generate_day's draws, before the mask's compaction
        bits = prng.random_bits(prng.split(key_for_date(d, cfg, device=device)), cfg.n_samples)
        x = prng.uniform_from_bits(bits[0], cfg.x_low, cfg.x_high)
        eps = prng.normal_from_bits(bits[1])
        return eps, _sample_day(x, eps, day_of_year(d), cfg)

    dates = [GENERATOR_YEAR + timedelta(days=i) for i in range(365)]
    x_equal = mask_equal = eps_equal = y_equal = 0
    eps_ulps = y_ulps = 0
    for d in dates:
        eps_card, card = (t.cpu() for t in draws(d, dev))
        eps_cpu, cpu = draws(d, torch.device("cpu"))
        x_equal += bool(torch.equal(card[0].view(torch.int32), cpu[0].view(torch.int32)))
        mask_equal += bool(torch.equal(card[2], cpu[2]))
        eps_equal += bool(torch.equal(eps_card.view(torch.int32), eps_cpu.view(torch.int32)))
        y_equal += bool(torch.equal(card[1].view(torch.int32), cpu[1].view(torch.int32)))
        eps_ulps = max(eps_ulps, _ulps(torch, eps_card, eps_cpu))
        y_ulps = max(y_ulps, _ulps(torch, card[1], cpu[1]))
    times = []
    for d in dates[:GENERATOR_TIMED_DAYS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_day(d, cfg, device=dev)  # ends on the device-to-host copy
        times.append(time.perf_counter() - t0)
    out = {"dates": len(dates), "x_bit_equal": x_equal, "mask_equal": mask_equal,
           "eps_bit_equal": eps_equal, "y_bit_equal": y_equal,
           "eps_max_ulps": eps_ulps, "y_max_ulps": y_ulps,
           "generate_day_ms_median": 1e3 * statistics.median(times),
           "generate_day_timed_days": len(times)}
    emit("generator", **out)
    if x_equal != len(dates) or mask_equal != len(dates):
        raise RuntimeError(f"the card's draws differ from the CPU's: {out}")
    return out


def phase_build() -> None:
    from bodywork_tpu_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    seconds = time.perf_counter() - t0
    report = {
        name: [line.strip() for line in r["log"].splitlines()
               if "registers" in line or "spill" in line or "Compiling entry" in line
               or "warning" in line.lower() or "Performance Loss" in line]
        for name, r in info.items()
    }
    emit("build", seconds=seconds,
         libraries={n: {"built": r["built"], "nvcc_seconds": r["seconds"]} for n, r in info.items()},
         ptxas=report)


def phase_kernels(torch, dev) -> dict:
    from bodywork_tpu_torch.ops.mlp_kernel import (
        LAUNCHES,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    X_all = torch.rand(4096, 1, generator=gen, device=dev) * 100.0
    params = make_params(torch, dev, X_all[:, 0], 0.5 * X_all[:, 0] + 1.0)
    errors = {}
    for engine, dtype in VARIANTS.items():
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        before = LAUNCHES[engine]
        per_rows = {}
        for rows in KERNEL_ROWS:
            X = X_all[:rows]
            got = apply(X)
            want = mlp_stack_plain(apply.layers, X, dtype)
            torch.cuda.synchronize()
            if got.shape != (rows,) or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{engine}: bad output at {rows} rows")
            max_abs, rel = rel_err(got, want)
            per_rows[rows] = {"max_abs_err": max_abs, "err_over_scale": rel}
            if rel >= BARS[engine]:
                raise RuntimeError(
                    f"{engine} disagrees with its plain version at {rows} rows: "
                    f"{rel:.3g} >= {BARS[engine]}"
                )
        launched = LAUNCHES[engine] - before
        if launched != len(KERNEL_ROWS):
            raise RuntimeError(f"{engine}: {launched} launches for {len(KERNEL_ROWS)} calls")
        errors[engine] = per_rows[4096]["max_abs_err"]
        # the bar must refuse each cheaper arithmetic, on the last batch
        # (4096 rows)
        control_errs = {name: rel_err(c, want)[1]
                        for name, c in controls(torch, apply.layers, X, dtype).items()}
        passing = [name for name, rel in control_errs.items() if rel < BARS[engine]]
        if passing:
            raise RuntimeError(f"{engine}: the bar {BARS[engine]} does not refuse "
                               f"{passing}: {control_errs}")
        emit("kernels", engine=engine, bar=BARS[engine], rows=per_rows,
             controls=control_errs, **_launch_shape(apply, KERNEL_ROWS))
        _check_ragged(torch, dev, engine, dtype)
    torch.cuda.synchronize()
    return errors


def _launch_shape(apply, rows_list) -> dict:
    """What each launch of ``apply`` looks like per batch size: [row tile,
    cluster size, ring stages (0 where the source fixes its ring), dynamic
    shared memory bytes a CTA]."""
    plans = {rows: apply.launch.plan(rows) for rows in rows_list}
    return {"launch_plan": {
        rows: [p.rows_per_tile, p.cluster, p.stages, p.smem_bytes] for rows, p in plans.items()
    }}


def _check_ragged(torch, dev, engine: str, dtype) -> None:
    """The kernels' other paths at small cost: 3 features, ragged widths
    and a 1100-wide layer, held against the plain version at the kernel's
    row tile and every cluster size the card schedules for it. Each kernel
    must refuse a 2048-wide layer, past its shared-memory limit (1280
    features for f32, 1536 for bf16, 1600 for int8: the headers of their
    sources)."""
    from bodywork_tpu_torch.models.mlp import init_mlp_params
    from bodywork_tpu_torch.ops.mlp_kernel import (
        CLUSTER_KERNELS,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def params_for(widths):
        return {
            "net": init_mlp_params(gen, widths, device=dev),
            "scaler": {"x_mean": torch.full((widths[0],), 50.0, device=dev),
                       "x_std": torch.full((widths[0],), 29.0, device=dev),
                       "y_mean": torch.tensor(26.0, device=dev),
                       "y_std": torch.tensor(15.0, device=dev)},
        }

    params = params_for((3, 1100, 40, 1))
    X = torch.rand(37, 3, generator=gen, device=dev) * 100.0
    rows = CLUSTER_KERNELS[engine].rows
    probe = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, block_rows=rows)
    shapes = [{"block_rows": rows, "cluster": c} for c in sorted(probe.launch.clusters)]
    refuse = dict(params=params_for((3, 2048, 1)), block_rows=rows)
    worst = 0.0
    for shape in shapes:
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, **shape)
        worst = max(worst, rel_err(apply(X), mlp_stack_plain(apply.layers, X, dtype))[1])
    torch.cuda.synchronize()
    if worst >= BARS[engine]:
        raise RuntimeError(f"{engine} disagrees on the ragged stack: {worst:.3g}")
    try:
        make_kernel_mlp_apply(refuse["params"], dev, compute_dtype=dtype,
                              block_rows=refuse["block_rows"])
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise RuntimeError(f"{engine}: a stack past its shared memory was not refused")
    emit("kernels-ragged", engine=engine, widths=[3, 1100, 40, 1], rows=37,
         shapes=shapes, err_over_scale=worst, refused=refusal)


def _serve_path(torch, dev, store, engine: str, singles, batches) -> dict:
    """Serve the store's newest checkpoint through ``engine``, send the
    requests over HTTP and hold every answer against the plain version.
    Returns the handle (started) and the check summary."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain
    from bodywork_tpu_torch.serve import serve_latest_model

    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                engine=engine, device=dev)
    health = get(handle.base_url + "/healthz")
    predictor = handle.app.predictor
    layers, dtype = predictor.kernel.layers, {"float32": None}.get(predictor.dtype, predictor.dtype)
    worst = 0.0
    latencies = []
    for x in singles:
        t0 = time.perf_counter()
        got = post(handle.url, {"X": x})["prediction"]
        latencies.append(time.perf_counter() - t0)
        want = mlp_stack_plain(layers, torch.tensor([[x]], device=dev), dtype)
        worst = max(worst, rel_err(torch.tensor([got], device=dev), want)[1])
    for X in batches:
        body = post(handle.url + "/batch", {"X": X.tolist()})
        got = torch.tensor(body["predictions"], device=dev)
        if body["n"] != len(X) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{engine}: bad batch answer for {len(X)} rows")
        worst = max(worst, rel_err(got, mlp_stack_plain(layers, X[:, None], dtype))[1])
    return handle, health, {"worst_err_over_scale": worst,
                            "single_latency_ms": [1e3 * t for t in latencies]}


def phase_slice(torch, dev, workdir: str) -> dict:
    import numpy as np

    from bodywork_tpu_torch.data import Dataset, generate_day, load_latest_dataset, persist_dataset
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, save_model
    from bodywork_tpu_torch.monitor import HttpScoringClient, run_service_test, scoring_endpoint
    from bodywork_tpu_torch.monitor.tester import DEFAULT_BATCH_SIZE
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import test_metrics_key as metrics_key

    store = FilesystemStore(os.path.join(workdir, "store"))
    days = [date(2026, 7, d) for d in (1, 2, 3)]
    Xs, ys = [], []
    for d in days:
        X, y = generate_day(d, device=dev)
        persist_dataset(store, Dataset(X, y, d))
        Xs.append(X)
        ys.append(y)
    X_hist = torch.as_tensor(np.concatenate(Xs), device=dev)
    y_hist = torch.as_tensor(np.concatenate(ys), device=dev)
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), make_params(torch, dev, X_hist, y_hist))
    save_model(store, model, days[-1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    launches = {}

    # the main path: engine auto -> kernel, then the test stage over HTTP
    reset_launches()
    handle, health, checks = _serve_path(torch, dev, store, "auto", singles, batches)
    try:
        if health["engine"] != "kernel" or health["device"] != "cuda":
            raise RuntimeError(f"auto served {health['engine']} on {health['device']}")
        if checks["worst_err_over_scale"] >= BARS["kernel"]:
            raise RuntimeError(f"served answers disagree with the plain version: {checks}")
        client = HttpScoringClient(scoring_endpoint(handle.url, "batch"))
        t0 = time.perf_counter()
        metrics = run_service_test(store, client, mode="batch")
        test_seconds = time.perf_counter() - t0
    finally:
        handle.stop()
    launches["kernel"] = LAUNCHES["kernel"]
    n_rows = len(load_latest_dataset(store))
    n_requests = len(singles) + len(batches) + -(-n_rows // DEFAULT_BATCH_SIZE)
    if not store.exists(metrics_key(days[-1])) or metrics["n_failures"] != 0:
        raise RuntimeError(f"test stage failed: {metrics}")
    if metrics["n_scored"] != n_rows:
        raise RuntimeError(f"test stage scored {metrics['n_scored']} of {n_rows} rows")
    if launches["kernel"] < n_requests:
        raise RuntimeError(f"{launches['kernel']} kernel launches for {n_requests} requests")
    emit("slice", engine=health["engine"], device=health["device"],
         model_info=health["model_info"], model_key=health["model_key"],
         requests=n_requests, launches=launches["kernel"], test_rows=n_rows,
         test_seconds=test_seconds,
         test_metrics={k: (str(v) if isinstance(v, date) else v) for k, v in metrics.items()},
         **checks)

    # the other two kernels serve the same checkpoint on their own paths
    for engine in ("kernel-bf16", "kernel-int8"):
        reset_launches()
        handle, health, checks = _serve_path(torch, dev, store, engine, singles[:2], batches[:1])
        handle.stop()
        launches[engine] = LAUNCHES[engine]
        if health["engine"] != engine or checks["worst_err_over_scale"] >= BARS[engine]:
            raise RuntimeError(f"{engine} path failed: {health} {checks}")
        if launches[engine] < 3:
            raise RuntimeError(f"{engine}: {launches[engine]} launches for 3 requests")
        emit(f"slice-{engine.split('-')[1]}", engine=engine, launches=launches[engine], **checks)
    _serve_too_wide(torch, dev, X_hist, y_hist, batches[0])
    _serve_nan_model(torch, dev, X_hist, y_hist)
    torch.cuda.synchronize()
    return launches


def _serve_too_wide(torch, dev, X_hist, y_hist, X) -> None:
    """A stack the f32 kernel cannot launch, on ``auto``: the plan-time
    check must pick the ``torch`` engine, which serves it on the card."""
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_model

    model = MLPRegressor(MLPConfig(hidden=TOO_WIDE[1:-1]),
                         make_params(torch, dev, X_hist, y_hist, widths=TOO_WIDE))
    reset_launches()
    handle = serve_model(model, None, host="127.0.0.1", port=0, block=False, engine="auto")
    try:
        health = get(handle.base_url + "/healthz")
        got = torch.tensor(post(handle.url + "/batch", {"X": X.tolist()})["predictions"],
                           device=dev)
    finally:
        handle.stop()
    launched = sum(LAUNCHES.values())
    with torch.no_grad():
        want = mlp_apply(model.params, X[:, None])
    err = rel_err(got, want)[1]
    emit("slice-auto-wide", hidden=list(TOO_WIDE[1:-1]), engine=health["engine"],
         device=health["device"], launches=launched, rows=int(X.shape[0]),
         err_over_scale_vs_plain=err)
    if health["engine"] != "torch" or health["device"] != "cuda" or launched:
        raise RuntimeError(f"auto on a too-wide stack: {health} ({launched} launches)")
    if err >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the torch engine's answers disagree: {err:.3g}")


def _serve_nan_model(torch, dev, X_hist, y_hist) -> None:
    """A model whose output is NaN, served through the f32 kernel: the
    prediction-sanity firewall must answer 500 over HTTP, without the
    value, for a single row and a batch."""
    import urllib.error

    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_model

    params = make_params(torch, dev, X_hist, y_hist)
    params["net"]["layers"][-1]["b"] = torch.full_like(params["net"]["layers"][-1]["b"],
                                                       float("nan"))
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), params)
    reset_launches()
    handle = serve_model(model, None, host="127.0.0.1", port=0, block=False, engine="auto",
                         model_source="production")
    answers = []
    try:
        health = get(handle.base_url + "/healthz")
        for url, body in ((handle.url, {"X": 50.0}), (handle.url + "/batch", {"X": [1.0, 2.0]})):
            try:
                post(url, body)
                answers.append((200, b""))
            except urllib.error.HTTPError as exc:
                answers.append((exc.code, exc.read()))
    finally:
        handle.stop()
    launched = LAUNCHES["kernel"]
    emit("slice-nan", engine=health["engine"], launches=launched,
         statuses=[code for code, _ in answers], bodies=[b.decode() for _, b in answers])
    if health["engine"] != "kernel" or launched < 2:
        raise RuntimeError(f"the NaN model was not served through the kernel: {health}")
    if any(code != 500 or b"nan" in body.lower() for code, body in answers):
        raise RuntimeError(f"a NaN prediction was not refused: {answers}")


def _day_line(model_type: str, r, launched: int) -> dict:
    """One simulated day's readings from its ``DayResult``."""
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TEST_STAGE, TRAIN_STAGE

    from bodywork_tpu_torch.pipeline.runner import GATE_RESULT
    from bodywork_tpu_torch.registry import GateDecision

    train = r.stage_results[TRAIN_STAGE]
    test = r.stage_results[TEST_STAGE]
    gate = r.stage_results.get(GATE_RESULT)
    health = r.stage_results[SERVE_STAGE].app.healthz_payload()
    line = {
        "model": model_type, "day": str(r.day), "engine": health["engine"],
        "device": health["device"], "model_info": health["model_info"],
        "launches": launched,
        "gate": ({"promote": gate.promote, "candidate": gate.model_key,
                  "checks": {c["name"]: c["ok"] for c in gate.checks}}
                 if isinstance(gate, GateDecision) else repr(gate)),
        "gate_seconds": r.gate_seconds,
        "served_key": health["model_key"], "served_source": health["model_source"],
        "train_rows": train.n_rows,
        "train_metrics": train.metrics,
        "test_metrics": {k: test[k] for k in ("MAPE", "r_squared", "max_residual",
                                             "n_failures", "n_scored")},
        "wall_clock_s": r.wall_clock_s, "stage_seconds": r.stage_seconds,
    }
    values = [*train.metrics.values(), test["MAPE"]]
    if not all(math.isfinite(v) for v in values) or test["n_failures"] != 0:
        raise RuntimeError(f"{model_type} day {r.day} is not healthy: {line}")
    # a gate that raised is logged and the day goes on; here it fails the phase
    if not isinstance(gate, GateDecision) or health["model_source"] != "production":
        raise RuntimeError(f"{model_type} day {r.day} was not gated and served from "
                           f"production: {line}")
    return line


def _run_loop(torch, dev, root: str, model_type: str, train_args: dict) -> dict:
    """7 days of the default pipeline on the card, through
    ``run_simulation``; the kernels' launch counts are set to 0 just
    before it and read just after."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline(model_type, "batch")
    spec.stages[TRAIN_STAGE].args.update(train_args)
    runner = LocalRunner(spec, FilesystemStore(os.path.join(root, model_type)), device=dev)
    days, seen = [], {"kernel": 0}

    def on_day(r):
        launched = LAUNCHES["kernel"] - seen["kernel"]
        seen["kernel"] = LAUNCHES["kernel"]
        days.append(_day_line(model_type, r, launched))
        emit("day-loop-day", **days[-1])

    reset_launches()
    results = runner.run_simulation(LOOP_START, LOOP_DAYS, on_day=on_day)
    launches = dict(LAUNCHES)
    walls = [r.wall_clock_s for r in results]
    stages = {name: statistics.median(r.stage_seconds[name] for r in results[1:])
              for name in results[0].stage_seconds}
    summary = {"model": model_type, "days": LOOP_DAYS, "launches": launches,
               "engines": sorted({d["engine"] for d in days}),
               "gate_verdicts": [d["gate"]["promote"] for d in days],
               "served_sources": sorted({d["served_source"] for d in days}),
               "gate_seconds": [r.gate_seconds for r in results],
               "median_gate_seconds_days_2_7": statistics.median(
                   r.gate_seconds for r in results[1:]),
               "wall_clock_s": walls, "day1_s": walls[0],
               "median_days_2_7_s": statistics.median(walls[1:]),
               "median_stage_seconds_days_2_7": stages}
    return {"summary": summary, "days": days, "runner": runner}


def phase_day_loop(torch, dev, workdir: str) -> dict:
    """The daily loop on the card for the MLP (gated, and served from the
    production alias by the f32 kernel) and the linear model, a forced
    gate rejection, then the card-against-CPU training check."""
    from bodywork_tpu_torch.data import load_latest_dataset
    from bodywork_tpu_torch.device import matmul_precision
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply, mlp_stack_plain

    emit("day-loop-precision", **matmul_precision())
    mlp = _run_loop(torch, dev, workdir, "mlp", LOOP_MLP)
    bad = [d["day"] for d in mlp["days"] if d["engine"] != "kernel" or d["launches"] < 1]
    if bad:
        raise RuntimeError(f"the MLP loop did not serve through the kernel on {bad}")
    emit("day-loop", **mlp["summary"])

    # the last day's checkpoint once more: through the kernel on the rows
    # its service was tested on, against its plain version and the plain
    # torch engine
    store = mlp["runner"].store
    model, model_date = load_model(store, device=dev)
    tested = load_latest_dataset(store)
    X = torch.as_tensor(tested.X, device=dev)
    apply = make_kernel_mlp_apply(model.params, dev)
    got = apply(X)
    want = mlp_stack_plain(apply.layers, X, None)
    with torch.no_grad():
        unfolded = mlp_apply(model.params, X)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    rel_unfolded = rel_err(got, unfolded)[1]
    if rel >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the trained model's kernel answers disagree: {rel:.3g}")
    emit("day-loop-served", model_date=str(model_date), rows_of=str(tested.date),
         rows=int(X.shape[0]),
         max_abs_err=err, err_over_scale=rel, bar=BARS["kernel"],
         err_over_scale_vs_unfolded=rel_unfolded)
    rejection = _forced_rejection(torch, dev, store, workdir)

    linear = _run_loop(torch, dev, workdir, "linear", {})
    if linear["summary"]["engines"] != ["torch"] or any(linear["summary"]["launches"].values()):
        raise RuntimeError(f"the linear loop should run no kernel: {linear['summary']}")
    emit("day-loop", **linear["summary"], note="the torch engine: this loop runs no kernel")

    parity = _card_against_cpu(torch, dev, mlp["runner"].store)
    emit("day-loop-train-profile", **_train_profile(torch, dev, mlp["runner"].store))
    return {"mlp": mlp["summary"], "linear": linear["summary"], "served_err": err,
            "card_vs_cpu": parity["max_rel_gap"], "rejection": rejection}


def _forced_rejection(torch, dev, store, workdir: str) -> dict:
    """On a copy of the MLP loop's store: a day-8 candidate whose held-out
    metrics fail the gate's ``min_r2`` is rejected, and the serve stage
    then serves the previous production through the f32 kernel (launches
    counted from 0 just before the serve stage, read after one request),
    whose answers are held against the plain version of that model."""
    from bodywork_tpu_torch.data.io import csv_record
    from bodywork_tpu_torch.models.checkpoint import load_model, save_model
    from bodywork_tpu_torch.models.mlp import mlp_apply
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline.stages import StageContext, serve_stage
    from bodywork_tpu_torch.registry import GatePolicy, ModelRegistry, register_candidate
    from bodywork_tpu_torch.registry.records import resolve_alias
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import model_metrics_key
    from bodywork_tpu_torch.train.trainer import METRIC_COLUMNS

    copy = FilesystemStore(shutil.copytree(store.root, os.path.join(workdir, "rejection")))
    production = resolve_alias(copy)
    model, _ = load_model(copy, production, device=dev)
    day = LOOP_START + timedelta(days=LOOP_DAYS)
    key = save_model(copy, model, day)
    copy.put_text(model_metrics_key(day), csv_record(
        METRIC_COLUMNS, {"date": day, "MAPE": 5.0, "r_squared": 0.05, "max_residual": 99.0}))
    register_candidate(copy, key, day=day)
    t0 = time.perf_counter()
    decision = ModelRegistry(copy, device=dev).gate(day=day)
    gate_seconds = time.perf_counter() - t0
    failed = [c["name"] for c in decision.checks if not c["ok"]]
    rows = [10.0, 50.0, 90.0]
    reset_launches()
    handle = serve_stage(StageContext(store=copy, today=day, device=dev),
                         buckets=[2048], replicas=2)
    try:
        health = handle.app.healthz_payload()
        got = torch.tensor(post(handle.url + "/batch", {"X": rows})["predictions"],
                           device=dev)
    finally:
        handle.stop()
    launches = dict(LAUNCHES)
    with torch.no_grad():
        want = mlp_apply(model.params, torch.tensor(rows, device=dev)[:, None])
    err = rel_err(got, want)[1]
    out = {"candidate": key, "promote": decision.promote, "failed_checks": failed,
           "min_r2": GatePolicy().min_r2, "gate_seconds": gate_seconds,
           "served_key": health["model_key"], "served_source": health["model_source"],
           "previous_production": production, "engine": health["engine"],
           "launches": launches, "err_over_scale_vs_plain": err}
    emit("day-loop-gate-rejection", **out)
    if decision.promote or "candidate-metrics" not in failed:
        raise RuntimeError(f"the failing candidate was not rejected by min_r2: {out}")
    if (health["model_key"], health["model_source"]) != (production, "production"):
        raise RuntimeError(f"the serve stage did not keep the previous production: {out}")
    if health["engine"] != "kernel" or launches["kernel"] < 2:
        raise RuntimeError(f"the previous production was not served by the kernel: {out}")
    if err >= BARS["kernel"] or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"the previous production's answers disagree: {err:.3g}")
    return out


def _card_against_cpu(torch, dev, store) -> dict:
    """Training on the card against the CPU, at width 1024 on the loop's
    history, from one init and one index stream: the first step's loss
    and gradients (the same params on both: no step amplifies a rounding
    difference) and the loss trajectory over 20 Adam steps, as largest
    relative gaps. The same with TF32 products on the card is the
    control: it must fail both step-0 bars, so that they tell IEEE
    float32 from TF32."""
    from bodywork_tpu_torch.data import load_all_datasets
    from bodywork_tpu_torch.device import matmul_precision
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        MLPConfig,
        _loss,
        _scaled_splits,
        draw_indices,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PARITY_STEPS})
    ds = load_all_datasets(store)
    arrays = [torch.as_tensor(a) for a in pad_rows(ds.X, ds.y)]
    gen = torch.Generator()
    gen.manual_seed(11)
    net = init_mlp_params(gen, WIDTHS)
    idx = draw_indices(gen, PARITY_STEPS, cfg.batch_size, arrays[0].shape[0])

    def run(device):
        Xs, ys, _ = _scaled_splits(*(a.to(device) for a in arrays))
        w = arrays[2].to(device)
        on = {"layers": [{k: t.to(device) for k, t in layer.items()} for layer in net["layers"]]}
        leaves = [t.clone().requires_grad_(True) for layer in on["layers"] for t in layer.values()]
        shaped = {"layers": [dict(zip(layer, leaves[2 * i:2 * i + 2]))
                             for i, layer in enumerate(on["layers"])]}
        i0 = idx[0].to(device)
        loss0 = _loss(shaped, Xs[i0], ys[i0], w[i0])
        grads = torch.autograd.grad(loss0, leaves)
        _, losses = train_core(on, Xs, ys, w, idx.to(device), cfg)
        return losses.double().cpu(), [g.double().cpu() for g in grads]

    def gaps(got, want) -> dict:
        traj = ((got[0] - want[0]).abs() / want[0].abs()).tolist()
        return {"loss_step0": traj[0], "loss_max": max(traj), "loss_per_step": traj,
                "grad_step0": max(float((a - b).norm() / b.norm()) for a, b in zip(got[1], want[1]))}

    cpu = run(torch.device("cpu"))
    card = run(dev)
    measured = gaps(card, cpu)
    setting = matmul_precision()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = gaps(run(dev), cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    out = {"steps": PARITY_STEPS, "widths": list(WIDTHS), "batch_size": cfg.batch_size,
           "rows": int(arrays[0].shape[0]), "precision": setting,
           "loss_card": card[0].tolist(), "loss_cpu": cpu[0].tolist(),
           "max_rel_gap": measured["loss_max"], "gaps": measured, "bars": PARITY_BARS,
           "tf32_control": control}
    emit("day-loop-card-vs-cpu", **out)
    over = [k for k, bar in PARITY_BARS.items() if measured[k] >= bar]
    if over:
        raise RuntimeError(f"training on the card drifts from the CPU: {over}")
    if any(control[k] < bar for k, bar in PARITY_BARS.items()):
        raise RuntimeError(f"the step-0 bars do not refuse TF32 products: {control}")
    return out


def _train_profile(torch, dev, store) -> dict:
    """Where a training step's time goes on the card: PROFILE_STEPS Adam
    steps of the loop's MLP on its history, timed on the host clock
    (ending in a synchronize) without and then with ``torch.profiler``,
    whose kernel times give the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from bodywork_tpu_torch.data import load_all_datasets
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        MLPConfig,
        _scaled_splits,
        draw_indices,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PROFILE_STEPS})
    ds = load_all_datasets(store)
    Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(ds.X, ds.y))
    Xs, ys, _ = _scaled_splits(Xp, yp, w)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    net = init_mlp_params(gen, WIDTHS, device=dev)
    idx = draw_indices(gen, PROFILE_STEPS, cfg.batch_size, Xp.shape[0], device=dev)

    def window() -> float:
        t0 = time.perf_counter()
        train_core(net, Xs, ys, w, idx, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()  # warm-up
    wall_s = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = window()
    # the kernels' own rows: an operator's row also carries its kernels' time
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(float(r.self_device_time_total) for r in kernels)
    top = sorted(kernels, key=lambda r: r.self_device_time_total, reverse=True)[:6]
    return {
        "steps": PROFILE_STEPS, "ms_per_step": 1e3 * wall_s / PROFILE_STEPS,
        "profiled_ms_per_step": 1e3 * profiled_s / PROFILE_STEPS,
        "device_ms_per_step": busy_us / 1e3 / PROFILE_STEPS if busy_us else "not measured",
        # of the profiled window, and of an unprofiled step (the profiler
        # slows the host, not the kernels)
        "device_busy_share": busy_us / 1e6 / profiled_s if busy_us else "not measured",
        "device_share_of_unprofiled_step": busy_us / 1e6 / wall_s if busy_us else "not measured",
        "kernels_per_step": sum(r.count for r in kernels) / PROFILE_STEPS,
        "top_kernels_ms_per_step": {
            r.key[:70]: float(r.self_device_time_total) / 1e3 / PROFILE_STEPS for r in top},
    }


def _median_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(torch, fn) -> float:
    """``fn`` captured once into a CUDA graph and timed as graph replays:
    the device time of its kernels without the host's launch gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_ms(torch, graph.replay)


def phase_timing(torch, dev, card: dict) -> dict:
    from bodywork_tpu_torch.ops.mlp_kernel import (
        CLUSTER_KERNELS,
        make_kernel_mlp_apply,
        mlp_stack_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    X_all = torch.rand(4096, 1, generator=gen, device=dev) * 100.0
    params = make_params(torch, dev, X_all[:, 0], 0.5 * X_all[:, 0] + 1.0)
    out = {}
    for engine, dtype in VARIANTS.items():
        apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        # the library yardstick: one addmm per layer in the variant's dtype
        # (int8 has no f32-activation int8 product: dequantized f32 weights)
        lib_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        lib_layers = [
            ((layer["w"].float() * layer["scale"][None, :]) if dtype == "int8"
             else layer["w"]).to(lib_dtype).contiguous()
            for layer in apply.layers
        ]
        lib_bias = [layer["b"].to(lib_dtype) for layer in apply.layers]

        def library(X, lib_layers=lib_layers, lib_bias=lib_bias):
            h = X.to(lib_dtype)
            for i, (w, b) in enumerate(zip(lib_layers, lib_bias)):
                h = torch.addmm(b, h, w)
                if i < len(lib_layers) - 1:
                    h = torch.relu(h)
            return h[:, 0]

        out[engine] = {}
        for rows in TIMING_ROWS:
            X = X_all[:rows].contiguous()
            bound_ms, bound_by = bound(rows, engine, card)
            row = {
                "kernel_ms": _median_ms(torch, lambda: apply.launch(X)),
                "kernel_graph_ms": _graph_ms(torch, lambda: apply.launch(X)),
                "plain_ms": _median_ms(torch, lambda: mlp_stack_plain(apply.layers, X, dtype)),
                "library_ms": _median_ms(torch, lambda: library(X)),
                "library_graph_ms": _graph_ms(torch, lambda: library(X)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if engine != "kernel-bf16":
                row["bound_products_ms"] = f32_product_ms(rows, card)
            out[engine][rows] = row
            emit("timing", engine=engine, rows=rows, reps=TIMING_REPS,
                 **_launch_shape(apply, [rows]), **row)
    # the cluster kernels' launch plan: (row tile, cluster size) per batch;
    # time every cluster size the card schedules, beside the planner's pick
    for engine in CLUSTER_KERNELS:
        dtype = VARIANTS[engine]
        picked = make_kernel_mlp_apply(params, dev, compute_dtype=dtype)
        sweep = {}
        for cluster in sorted(picked.launch.clusters):
            apply = make_kernel_mlp_apply(params, dev, compute_dtype=dtype, cluster=cluster)
            sweep[cluster] = {
                rows: _median_ms(torch, lambda: apply.launch(X_all[:rows].contiguous()))
                for rows in (256, 512, 4096)
            }
        emit("timing-launch-plan", engine=engine,
             rows_per_tile=CLUSTER_KERNELS[engine].rows,
             clusters_resident=picked.launch.clusters,
             picked={rows: picked.launch.plan(rows).cluster for rows in (256, 512, 4096)},
             kernel_ms=sweep)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--phases", default="device,generator,build,kernels,slice,day-loop,timing",
        help="comma-separated subset of the phases to run (default: all)",
    )
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bodywork_tpu_torch")):
        print("chip_smoke: bodywork_tpu_torch/ is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.utils.logging import configure_logger

    # stdout carries the JSON lines; the port's logs go to stderr
    configure_logger("WARNING", stream=sys.stderr)

    dev = resolve_device("cuda")
    card = phase_device(torch)
    if "generator" in phases:
        phase_generator(torch, dev)
    if "build" in phases:
        phase_build()
    errors = phase_kernels(torch, dev) if "kernels" in phases else {}
    launches, loop, timing = {}, {}, {}
    for phase in ("slice", "day-loop"):
        if phase not in phases:
            continue
        workdir = tempfile.mkdtemp(prefix="chip-smoke-", dir=_scratch_dir())
        try:
            if phase == "slice":
                launches = phase_slice(torch, dev, workdir)
            else:
                loop = phase_day_loop(torch, dev, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    if "timing" in phases:
        timing = phase_timing(torch, dev, card)
    if phases >= {"kernels", "slice", "day-loop", "timing"}:
        kernels = []
        for engine in VARIANTS:
            t = timing[engine][4096]
            by_path = {"slice": launches[engine], "day-loop": loop["mlp"]["launches"][engine],
                       "gate-rejection": loop["rejection"]["launches"][engine]}
            kernels.append({
                "name": engine, "route": "cuda", "source": SOURCES[engine],
                "replaces": REPLACES[engine], "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": errors[engine], "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "kernel_graph_ms": t["kernel_graph_ms"],
                "library_graph_ms": t["library_graph_ms"],
            })
        print(card["smi"], flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _scratch_dir() -> str:
    """A scratch directory inside the checkout (``build/`` is ignored by
    git), so the run writes nothing outside the repository."""
    path = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


if __name__ == "__main__":
    sys.exit(main())
