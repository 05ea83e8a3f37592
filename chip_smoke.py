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
   one day; then ``mlp-draws``: the seeded MLP fit's threefry draws (the
   2000-step minibatch index stream and the 1024-wide He init) on the
   card against the CPU, bit-equal, with the card's draw times;
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
   are set to 0 just before each path and read just after it; then
   ``serving``, the serving machinery on a checkpoint of the same model:
   ``serve-graph`` serves it on ``auto`` (-> ``kernel``), ``kernel-bf16``
   and ``kernel-int8``, each from a cold graph cache (``serve.predictor``):
   the CUDA-graph captures must equal the buckets at warm-up and stay 0
   over the requests, every bucket's replay must be bit-equal to the same
   predictor's eager kernel launch, and the served answers, which fill
   every bucket, within the engine's bar of the plain version, with the
   host ms of a dispatch eager against replayed;
   ``serve-graph-swap`` serves a second checkpoint of the same
   architecture beside the first (no capture, one rebind; each service
   answering with its own weights); ``serve-graph-overlap`` captures while
   another thread runs 800 Adam steps of the 1024-wide MLP (the losses
   bit-equal to an unshared run); ``serve-coalesce`` runs config 7's
   shape (300 sequential single rows, then 16 clients x 25) on the
   ``thread`` and ``aio`` front ends with the coalescer off and on (2 ms,
   64 rows): p50/p99, rows per dispatch, every answer byte-identical to the
   uncoalesced thread engine's; ``serve-admission`` bursts 64 simultaneous
   rows at ``aio`` with ``max_pending`` 8: 429s with ``Retry-After``, every
   200 the unshed answer, the ``/metrics`` shed count equal to the 429s;
   then ``trace``: request tracing on that model, served on ``auto``
   (-> ``kernel``) on both front ends, coalescer off and on, at trace
   fraction 1.0: single rows, one with an ingress ``traceparent`` (whose
   id must be kept), one 4096-row batch, then 16 clients x 25: every
   response's 32-hex ``X-Bodywork-Trace-Id`` in a header and in no body,
   every trace with the JAX package's spans (``parse``, ``device-dispatch``
   with ``aot_cache`` and ``bucket``, ``serialize``, and ``queue-wait``
   when coalesced, every coalesced member linked to the one shared
   dispatch span), ``/healthz`` exemplars that resolve to recorded traces,
   and the median span breakdown of the 16 clients' requests;
   ``trace-overhead``: config 7 on ``thread`` (coalescer off) at fractions
   0, 0.1, 1.0, 1.0, 0.1, 0;
5. ``day-loop`` — the daily train -> registry gate -> serve -> generate
   -> test loop (``run_simulation``, which journals every day, prefetches
   the horizon's draws, trains each next day as a lookahead on a
   background thread and refreshes the history snapshot; every loop of
   the script fails unless every day used its prefetched draws and every
   day but the first collected its lookahead) for 7 simulated days on the card: the
   MLP at hidden (1024, 1024, 1024) trained with Adam (lr 1e-3, batch 256,
   2000 steps), registered as a candidate, gated, and served from the
   registry's ``production`` alias by ``auto``, which must resolve to
   ``kernel`` every day, with the kernel's launches counted over the loop
   (counts set to 0 just before it, read just after) and the serving
   graph cache cold before it (day 1 must capture its buckets, later days
   none: a new day's checkpoint rebinds the captured graphs); every day's gate
   must have reached a decision and every day's served key must come from
   ``production``. Then the last day's checkpoint through the kernel held
   against its plain version; then a forced rejection on a copy of the
   store (``day-loop-gate-rejection``: a candidate whose metrics fail
   ``min_r2`` is rejected, and the serve stage serves the previous
   production through ``kernel``, launches counted); ``pipelined``: the
   MLP loop's first 3 days against a serial loop of plain ``run_day``
   calls with nothing prefetched or trained ahead, datasets, checkpoints,
   metrics and registry records byte-identical, with each day's train
   stage seconds (the wait for the lookahead), the lookahead's own train
   seconds, the test stage's seconds and what the prefetch box and the
   lookahead's result hold; then the linear
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
6. ``incremental`` — incremental training on the card: (a) the linear
   loop for 30 days in ``mode="incremental"``, its train seconds a day
   and their last-third over first-third ratio (days 2-30; day 1 builds
   the trainstate and is reported apart), the final coefficients
   within 1e-4 of a float64 refit, and the trainstate bytes equal to the
   same days folded on the CPU (``incremental-linear``), then
   ``snapshot``: a fresh ``cli train`` process on that store must read
   every covered day from the history snapshot, whose load is
   byte-identical to a plain load without it (both cold loads timed, the
   snapshot's bytes printed); (b) the
   1024-wide MLP loop for 7 days, day 1 a full refit, days 2-7 fine-tunes
   of production (500 steps), each gated with 3 shadow days and served
   through ``kernel`` (``incremental-day`` lines, ``incremental-mlp``);
   (c) on a copy of (b)'s store, a day whose fine-tune is made to fail:
   the gate rejects it and the runner refits in full the same day,
   re-gates and serves the refit (``incremental-gate-rejection``); then
   ``quantized``: the serve stage with ``BODYWORK_TPU_SERVE_DTYPE`` at
   ``bfloat16`` and ``int8`` on (b)'s production, which ``auto`` resolves
   to ``kernel``, so the shadow quantization gate must admit
   ``kernel-bf16`` / ``kernel-int8``, whose answers over HTTP are held
   against their plain versions (the gate's report and verdict and the
   launches per kernel printed); and ``quantized-torch``: ``--engine
   torch`` at each dtype (``torch-bf16`` / ``torch-int8``) on the card
   against the same predictor on the CPU;
7. ``resume`` — the 1024-wide MLP day through ``python -m
   bodywork_tpu_torch.cli run-day`` subprocesses: killed by
   ``BODYWORK_TPU_CRASH_SCHEDULE`` at the step boundary after train (exit
   86), restarted (exit 0, train skipped on the journal's digests,
   ``production`` served through ``kernel``), run again (exit 6, a no-op)
   and run under a live foreign lease (exit 5); every artefact
   byte-identical to an uncrashed twin day run in this process, with the
   wall-clocks, the digest re-hash seconds and a day's journal writes;
   then ``sigterm``: SIGTERM to a ``run-day`` mid-train exits 143 with the
   journal ``interrupted``, and the next ``run-day`` resumes the day;
   the killed, restarted and no-op processes must count
   ``runner_resumes_total`` ``fresh``, ``resumed`` and ``noop``; then
   ``day-report``: a ``run-day`` of that day on a fresh store with
   ``--trace-out``/``--report-out``: the report's schema, every stage
   span's trace duration equal to its ``stage_seconds``, the gate and day
   spans, the gate's seconds and the day's seconds outside its stage and
   gate spans; then ``profile``: ``run-sim --profile-dir`` for 2 days of
   the MLP with its fits cut to 200 steps, between two unprofiled runs:
   the trace's CUDA device events, the f32 kernel by name (one event per
   counted launch) or inside graph launches, the trace's bytes and the
   run's seconds with the profiler on and off;
8. ``timing``  — per variant at the 256- and 4096-row buckets, with CUDA
   events (warm-up, then the median of 30): the kernel as one call
   (``kernel_ms``) and as replays of a captured CUDA graph, which leaves
   out the host's launch gaps (``kernel_graph_ms``), its plain version,
   and the folded stack through ``torch.addmm`` in the variant's dtype
   with TF32 off (a yardstick the port never calls), eager
   (``library_ms``) and from a graph (``library_graph_ms``), beside the
   card's bound; ``timing-launch-plan`` times every cluster size each
   kernel can take at 256, 512 and 4096 rows; then one ``kernels`` line
   summing every kernel up.

A ``total`` line gives the script's seconds. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device,
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
#: order. bf16 rounds every activation, so a change of summation order
#: flips some roundings and moves the output: on an H100, over 4096
#: uniform rows and 8 seeded inits (``tools/bf16_witness.py``), two IEEE
#: f32 orders differ by up to 2.07e-3 of scale, and the kernel, bit-equal
#: there to cuBLAS's bf16 tensor-core GEMM, by up to 2.74e-3 from the
#: plain version. Its bar sits between that and the cheapest control it
#: must refuse (f32 activations, 8.2e-3), near their geometric mean. Each
#: bar must refuse the cheaper arithmetic of :func:`controls` (checked in
#: ``kernels``), so that it tells the kernel's design from a shortcut
BARS = {"kernel": 1e-4, "kernel-bf16": 4.5e-3, "kernel-int8": 1e-4}
KERNEL_ROWS = (1, 8, 300, 4096)
TIMING_ROWS = (256, 4096)
TIMING_REPS = 30
#: the day loop: 7 simulated days from this date; the MLP trained with the
#: repository's wide-training settings (``bench.py:1092-1094``)
LOOP_DAYS = 7
LOOP_START = date(2026, 7, 1)
LOOP_MLP = {"hidden": HIDDEN, "learning_rate": 1e-3, "batch_size": 256, "n_steps": 2000}
#: the serial loop the pipelined MLP loop is held to, over its first days
SERIAL_DAYS = 3
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
#: the MLP fit's index stream: over the 7-day loop's padded rows and a
#: count that is not a power of two; timed reps
DRAW_ROWS = (16384, 10000)
DRAW_REPS = 5
#: the incremental linear loop's days, and its coefficients' bar against
#: a float64 refit (``bench.py:2548``)
INC_LINEAR_DAYS = 30
REFIT_ATOL = 1e-4
#: the plain quantized engines on the card against the same predictor on
#: the CPU, as max|card - cpu| / max(1, max|cpu|): int8 differs by f32
#: summation order alone; bf16 also where a bf16 rounding of an activation
#: flips (the JAX package's bf16 bar)
CARD_CPU_BARS = {"torch-int8": 1e-4, "torch-bf16": 2e-2}
#: serve-graph-overlap: Adam steps on the training thread beside the capture
OVERLAP_STEPS = 800
#: serve-coalesce: the JAX benchmark's config 7 (``bench.py:646``)
COALESCE = {"sequential": 300, "clients": 16, "per_client": 25, "windows": (0, 2.0),
            "max_rows": 64}
#: serve-admission: the aio budget and the burst past it
ADMISSION = {"max_pending": 8, "burst": 64}
#: trace: single rows sent one after another, the batch's rows, the
#: ingress traceparent, and the trace fractions config 7 is served at, in
#: turns (each fraction twice, mirrored: the spread between calls is wide)
TRACE = {"singles": 20, "batch_rows": 4096, "ingress": f"00-{'4b' * 16}-{'9c' * 8}-01",
         "fractions": (0.0, 0.1, 1.0, 1.0, 0.1, 0.0)}
#: profile: the 2-day MLP simulation's Adam steps a fit, cut from the
#: loop's 2000 so the profile holds ~25k kernel events a day, not ~125k
PROFILE_SIM = {"days": 2, "n_steps": 200}


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


def bf16_exact(torch, layers, X):
    """The bf16 variant's function with exact sums: each layer's input
    rounded to bf16 as the kernel rounds it, then float64 products and
    sums rounded once to f32 (an order-free witness)."""
    h = X.to(torch.float32)
    for i, layer in enumerate(layers):
        h = (h.to(torch.bfloat16).double() @ layer["w"].double()
             + layer["b"].double()).to(torch.float32)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[:, 0]


def bf16_library(torch, layers, X):
    """The bf16 variant's function through cuBLAS's bf16 tensor-core GEMM
    with f32 output (``torch.mm(..., out_dtype=torch.float32)``), or None
    where this PyTorch lacks it. A witness only: the port never calls it."""
    h = X.to(torch.float32)
    try:
        for i, layer in enumerate(layers):
            h = torch.mm(h.to(torch.bfloat16), layer["w"].to(torch.bfloat16),
                         out_dtype=torch.float32) + layer["b"]
            if i < len(layers) - 1:
                h = torch.relu(h)
    except (RuntimeError, TypeError):
        return None
    return h[:, 0]


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
    """Seeded He-init weights (the JAX fit's threefry init for ``seed``)
    and the scaler's statistics over the generated days."""
    from bodywork_tpu_torch.models.mlp import _masked_stats, fit_keys, init_mlp_params

    net = init_mlp_params(fit_keys(seed)[0], widths, device=dev)
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
        witnesses = {}
        if dtype == "bfloat16":
            # two more witnesses on the last batch: exact sums, held to the
            # bar too, and cuBLAS's tensor cores (reported)
            got = apply(X)
            witnesses["exact_f64"] = rel_err(got, bf16_exact(torch, apply.layers, X))[1]
            library = bf16_library(torch, apply.layers, X)
            if library is not None:
                witnesses["library_tc"] = rel_err(got, library)[1]
                witnesses["bit_equal_to_library_tc"] = bool(torch.equal(got, library))
            if witnesses["exact_f64"] >= BARS[engine]:
                raise RuntimeError(f"{engine} disagrees with exact sums: {witnesses}")
        emit("kernels", engine=engine, bar=BARS[engine], rows=per_rows,
             controls=control_errs, witnesses=witnesses,
             **_launch_shape(apply, KERNEL_ROWS))
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
    from bodywork_tpu_torch.data.prng import PRNGKey
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
            "net": init_mlp_params(PRNGKey(sum(widths)), widths, device=dev),
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
    from bodywork_tpu_torch.serve import serve_latest_model

    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                engine=engine, device=dev)
    return (handle, *_check_served(torch, dev, handle, singles, batches))


def _check_served(torch, dev, handle, singles, batches) -> tuple[dict, dict]:
    """Send the requests over HTTP to a started kernel service and hold
    every answer against the kernel's plain version; returns ``/healthz``
    and the check summary."""
    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

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
    return health, {"worst_err_over_scale": worst,
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


# -- the serving machinery: graph cache, coalescer, admission, aio ------------

def _connect(base_url: str):
    """A keep-alive HTTP/1.1 connection to a service (one per client)."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(base_url)
    return http.client.HTTPConnection(parts.hostname, parts.port, timeout=60)


def _score(conn, x: float) -> tuple[int, dict, bytes, float]:
    """One single-row ``/score/v1`` on a keep-alive connection: status,
    headers, body and seconds."""
    status, headers, _sent, payload, seconds = _post_json(conn, "/score/v1", {"X": x})
    return status, headers, payload, seconds


def _post_json(conn, path: str, payload, headers=None) -> tuple[int, dict, bytes, bytes, float]:
    """One POST of ``payload`` as JSON on a keep-alive connection: status,
    headers, the request body sent, the response body, and seconds."""
    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    payload = resp.read()
    return resp.status, dict(resp.getheaders()), body, payload, time.perf_counter() - t0


def _nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile (the JAX benchmark's ``_percentile``)."""
    ordered = sorted(values)
    return ordered[min(int(round(q / 100.0 * (len(ordered) - 1))), len(ordered) - 1)]


def _serving_models(torch, dev, workdir: str):
    """The served 1024-wide MLP (seed 0) checkpointed in a store of three
    generated days, and a second checkpoint of the same architecture
    (seed 1) in memory."""
    import numpy as np

    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, save_model
    from bodywork_tpu_torch.store import FilesystemStore

    store = FilesystemStore(os.path.join(workdir, "serving-store"))
    Xs, ys = [], []
    for d in (date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3)):
        X, y = generate_day(d, device=dev)
        persist_dataset(store, Dataset(X, y, d))
        Xs.append(X)
        ys.append(y)
    X_hist = torch.as_tensor(np.concatenate(Xs), device=dev)
    y_hist = torch.as_tensor(np.concatenate(ys), device=dev)
    first = MLPRegressor(MLPConfig(hidden=HIDDEN), make_params(torch, dev, X_hist, y_hist))
    save_model(store, first, date(2026, 7, 3))
    second = MLPRegressor(MLPConfig(hidden=HIDDEN),
                          make_params(torch, dev, X_hist, y_hist, seed=1))
    return store, second, (X_hist, y_hist)


def _bucket_checks(torch, dev, predictor, engine: str, seed: int) -> dict:
    """Per bucket of a warmed kernel predictor, on a full bucket of seeded
    uniform rows: its graph replay against the same predictor's eager
    kernel launch on the same input (bit-equal: the graph's contract) and
    within the engine's bar of the plain version; then the host
    milliseconds a request's dispatch takes at that bucket, eager (host
    batch to the card, one launch, read back: the dispatch before the
    graph cache) against the graph (staging, replay, read back), medians
    of TIMING_REPS in turns."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import mlp_stack_plain

    dtype = {"float32": None}.get(predictor.dtype, predictor.dtype)
    rng = np.random.default_rng(seed)
    out = {}
    for b in predictor.buckets:
        Xp = rng.uniform(0, 100, (b, 1)).astype(np.float32)
        replay = predictor._predict_padded(Xp)
        X = torch.as_tensor(Xp, device=dev)
        eager = predictor.kernel(X).cpu().numpy()
        plain = mlp_stack_plain(predictor.kernel.layers, X, dtype)
        rel = rel_err(torch.as_tensor(replay, device=dev), plain)[1]
        times = {"eager": [], "graph": []}
        for _ in range(TIMING_REPS):
            for name, fn in (("eager", lambda: predictor.kernel(
                                 torch.as_tensor(Xp, device=dev)).cpu().numpy()),
                             ("graph", lambda: predictor._predict_padded(Xp))):
                t0 = time.perf_counter()
                fn()
                times[name].append(1e3 * (time.perf_counter() - t0))
        out[b] = {"bit_equal_to_eager": bool(np.array_equal(replay, eager)),
                  "err_over_scale_vs_plain": rel,
                  "host_ms_eager": statistics.median(times["eager"]),
                  "host_ms_graph": statistics.median(times["graph"])}
        if not out[b]["bit_equal_to_eager"] or rel >= BARS[engine]:
            raise RuntimeError(f"{engine} bucket {b}: the graph replay disagrees with the "
                               f"eager kernel or the plain version (bar {BARS[engine]}): "
                               f"{out[b]}")
    return out


def _serve_graph(torch, dev, store) -> dict:
    """``serve-graph``: the checkpoint served on ``auto`` (-> ``kernel``),
    then on ``kernel-bf16`` and ``kernel-int8``, each from a cold cache:
    the captures equal the buckets at warm-up and stay 0 over the
    requests; every bucket's replay bit-equal to the eager kernel and
    within the engine's bar of the plain version."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    # the singles pad to the 256-row bucket, the batches to 512 and 4096
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    out = {}
    for requested, engine in (("auto", "kernel"), ("kernel-bf16", "kernel-bf16"),
                              ("kernel-int8", "kernel-int8")):
        GRAPH_CACHE.reset()
        reset_launches()
        handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                    engine=requested, device=dev)
        try:
            warm = GRAPH_CACHE.stats()
            health, checks = _check_served(torch, dev, handle, singles, batches)
            served = GRAPH_CACHE.stats()
            launches = dict(LAUNCHES)
            predictor = handle.app.predictor
            buckets = _bucket_checks(torch, dev, predictor, engine, seed=len(out))
        finally:
            handle.stop()
        line = {"requested": requested, "engine": health["engine"],
                "buckets": list(predictor.buckets), "captures_at_warmup": warm["captures"],
                "captures_over_requests": served["captures"] - warm["captures"],
                "replays_over_requests": served["replays"] - warm["replays"],
                "launches": launches, "per_bucket": buckets, "bar": BARS[engine], **checks}
        emit("serve-graph", **line)
        if health["engine"] != engine or warm["captures"] != len(predictor.buckets):
            raise RuntimeError(f"{engine}: {warm['captures']} captures at warm-up for "
                               f"{len(predictor.buckets)} buckets ({health['engine']})")
        if line["captures_over_requests"] or checks["worst_err_over_scale"] >= BARS[engine]:
            raise RuntimeError(f"{engine}: a request captured, or an answer is off: {line}")
        if launches[engine] < line["replays_over_requests"] + warm["replays"]:
            raise RuntimeError(f"{engine}: replays went uncounted: {line}")
        out[engine] = line
    return out


def _serve_graph_swap(torch, dev, store, second) -> dict:
    """``serve-graph-swap``: a second checkpoint of the same architecture
    served in the same process while the first still serves: no capture,
    one rebind; each service answers with its own weights (held against
    its own eager kernel, bit-equal), and the first again after the second."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, serve_latest_model, serve_model

    GRAPH_CACHE.reset()
    reset_launches()
    first = serve_latest_model(store, host="127.0.0.1", port=0, block=False, engine="auto",
                               device=dev)
    try:
        before = GRAPH_CACHE.stats()
        swap = serve_model(second, date(2026, 7, 4), host="127.0.0.1", port=0, block=False,
                           engine="auto")
        try:
            after_warm = GRAPH_CACHE.stats()
            xs = [float(x) for x in np.linspace(1, 99, 9)]
            got_second = [post(swap.url, {"X": x})["prediction"] for x in xs]
            got_first = [post(first.url, {"X": x})["prediction"] for x in xs]
            end = GRAPH_CACHE.stats()
            launches = dict(LAUNCHES)
            # each single row pads to the 256-row bucket, whose launch plan
            # fixes the kernel's summation order: the eager reference runs
            # the rows in one batch of that bucket
            bucket = first.app.predictor.buckets[0]
            X = torch.zeros(bucket, 1, device=dev)
            X[:len(xs), 0] = torch.tensor(xs, device=dev)
            eager = {name: [float(v) for v in h.app.predictor.kernel(X)[:len(xs)].cpu()]
                     for name, h in (("first", first), ("second", swap))}
        finally:
            swap.stop()
    finally:
        first.stop()
    out = {"captures_at_swap": after_warm["captures"] - before["captures"],
           "rebinds_at_swap": after_warm["rebinds"] - before["rebinds"],
           "misses_at_swap": after_warm["misses"] - before["misses"],
           "rebinds_serving_both_in_turn": end["rebinds"] - after_warm["rebinds"],
           "captures_total": end["captures"],
           "second_equals_its_eager": got_second == eager["second"],
           "first_equals_its_eager": got_first == eager["first"],
           "second_differs_from_first": all(a != b for a, b in zip(got_second, got_first)),
           "launches": launches, "requests": 2 * len(xs)}
    emit("serve-graph-swap", **out)
    if out["captures_at_swap"] or out["misses_at_swap"] or out["rebinds_at_swap"] != 1:
        raise RuntimeError(f"the same-architecture swap captured or did not rebind once: {out}")
    if not (out["second_equals_its_eager"] and out["first_equals_its_eager"]
            and out["second_differs_from_first"]):
        raise RuntimeError(f"a service answered with another checkpoint's weights: {out}")
    return out


def _serve_graph_overlap(torch, dev, store, hist) -> dict:
    """``serve-graph-overlap``: the kernel predictor's buckets captured on
    this thread while another thread runs OVERLAP_STEPS Adam steps of the
    1024-wide MLP on the card; both finish, the capture lies inside the
    training, its replays equal the eager kernel, and the losses equal an
    unshared run of the same steps bit for bit."""
    import threading

    import numpy as np

    from bodywork_tpu_torch.models import MLPConfig
    from bodywork_tpu_torch.models.base import pad_rows
    from bodywork_tpu_torch.models.mlp import (
        _scaled_splits,
        draw_indices,
        fit_keys,
        init_mlp_params,
        train_core,
    )
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import GRAPH_CACHE, build_predictor

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": OVERLAP_STEPS})
    X_hist, y_hist = hist
    Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(
        X_hist.cpu().numpy()[:, None], y_hist.cpu().numpy()))
    Xs, ys, _ = _scaled_splits(Xp, yp, w)
    k_init, k_train = fit_keys(13)
    idx = draw_indices(k_train, OVERLAP_STEPS, cfg.batch_size, Xp.shape[0], device=dev)

    def train(started=None) -> tuple:
        net = init_mlp_params(k_init, WIDTHS, device=dev)
        torch.cuda.synchronize()
        if started is not None:
            started.set()
        t0 = time.perf_counter()
        _, losses = train_core(net, Xs, ys, w, idx, cfg)
        torch.cuda.synchronize()
        return losses.cpu(), t0, time.perf_counter()

    alone = train()[0]
    box, started = {}, threading.Event()

    def worker():
        box["losses"], box["t0"], box["t1"] = train(started)

    from bodywork_tpu_torch.models.checkpoint import load_model

    model, _ = load_model(store, device=dev)
    predictor = build_predictor(model, "kernel")
    GRAPH_CACHE.reset()
    reset_launches()
    thread = threading.Thread(target=worker, name="overlap-train")
    thread.start()
    started.wait()
    time.sleep(0.02)  # the Adam loop is issuing its kernels
    t0 = time.perf_counter()
    predictor.warmup()
    t1 = time.perf_counter()
    thread.join()
    stats, launches = GRAPH_CACHE.stats(), dict(LAUNCHES)
    rng = np.random.default_rng(14)
    Xq = rng.uniform(0, 100, (predictor.buckets[0], 1)).astype(np.float32)
    replay_equal = bool(np.array_equal(
        predictor._predict_padded(Xq),
        predictor.kernel(torch.as_tensor(Xq, device=dev)).cpu().numpy()))
    shared = box["losses"]
    out = {"steps": OVERLAP_STEPS, "captures": stats["captures"],
           "capture_s": t1 - t0, "train_s": box["t1"] - box["t0"],
           "capture_inside_training": box["t0"] < t0 and t1 < box["t1"],
           "losses_equal_unshared": bool(torch.equal(shared, alone)),
           "max_abs_loss_gap": float((shared - alone).abs().max()),
           "final_loss": float(shared[-1]), "replay_bit_equal_to_eager": replay_equal,
           "launches": launches}
    emit("serve-graph-overlap", **out)
    if stats["captures"] != len(predictor.buckets) or not replay_equal:
        raise RuntimeError(f"the capture beside training failed: {out}")
    if not out["capture_inside_training"]:
        raise RuntimeError(f"the capture did not run beside the training: {out}")
    if not out["losses_equal_unshared"]:
        raise RuntimeError(f"training beside a capture drifted from an unshared run: {out}")
    return out


def _config7(handle, seq_x, client_x) -> dict:
    """Config 7's load on a started service: 20 untimed requests, then
    ``seq_x`` as sequential single rows on one keep-alive connection, then
    one closed-loop client per list of ``client_x``, each on its own
    connection after one untimed request. p50/p99 (nearest rank) of both
    parts, the concurrent part's requests/s, and the realised rows per
    dispatch (the part's requests, each client's untimed first one
    included, over the ``kernel`` launches in that part); ``answers`` holds
    every timed ``(status, headers, body, seconds)``, sequential first."""
    import threading

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES

    conn = _connect(handle.base_url)
    for _ in range(20):
        _score(conn, 50.0)
    at_seq = LAUNCHES["kernel"]
    seq = [_score(conn, x) for x in seq_x]
    conn.close()
    at_conc = LAUNCHES["kernel"]
    conc = [[] for _ in client_x]
    start = threading.Barrier(len(client_x))

    def client(i):
        c = _connect(handle.base_url)
        _score(c, 50.0)
        start.wait()
        conc[i] = [_score(c, x) for x in client_x[i]]
        c.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(client_x))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    end = LAUNCHES["kernel"]
    seq_s = [s for _, _, _, s in seq]
    conc_s = [s for per in conc for _, _, _, s in per]
    return {
        "answers": seq + [a for per in conc for a in per],
        "sequential": {"requests": len(seq_s), "p50_ms": 1e3 * _nearest_rank(seq_s, 50),
                       "p99_ms": 1e3 * _nearest_rank(seq_s, 99),
                       "rows_per_dispatch": len(seq_s) / max(1, at_conc - at_seq)}
        if seq_s else None,
        "concurrent": {"clients": len(client_x), "requests": len(conc_s),
                       "p50_ms": 1e3 * _nearest_rank(conc_s, 50),
                       "p99_ms": 1e3 * _nearest_rank(conc_s, 99),
                       "requests_per_s": len(conc_s) / wall,
                       "rows_per_dispatch": (len(conc_s) + len(client_x))
                       / max(1, end - at_conc)},
    }


def _serve_coalesce(torch, dev, store) -> dict:
    """``serve-coalesce``: config 7's shape (``bench.py:646``) on both
    front ends, coalescer off (window 0) and on (2 ms, 64 rows): 20
    untimed requests, 300 sequential single rows on one keep-alive
    connection, then 16 closed-loop clients x 25, each on its own
    connection. p50/p99 (nearest rank) of both parts, realised rows per
    dispatch (the part's requests, each client's untimed first one
    included, over the kernel's launches in that part), and every answer
    byte-identical across the four services."""
    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    rng = np.random.default_rng(7)
    seq_x = [round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["sequential"])]
    client_x = [[round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["per_client"])]
                for _ in range(COALESCE["clients"])]
    runs, bodies, launches_by_run = {}, {}, {}
    for engine in ("thread", "aio"):
        for window in COALESCE["windows"]:
            name = f"{engine}-window-{window:g}ms"
            reset_launches()
            handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                        engine="auto", device=dev, server_engine=engine,
                                        batch_window_ms=window,
                                        batch_max_rows=COALESCE["max_rows"])
            try:
                load = _config7(handle, seq_x, client_x)
                batcher = handle.app.batcher
                stats = batcher.stats() if batcher is not None else None
                launches_by_run[name] = dict(LAUNCHES)
            finally:
                handle.stop()
            if any(status != 200 for status, _, _, _ in load["answers"]):
                raise RuntimeError(f"{name}: a request failed")
            bodies[name] = [body for _, _, body, _ in load["answers"]]
            runs[name] = {
                "engine": engine, "window_ms": window, "max_rows": COALESCE["max_rows"],
                "sequential": load["sequential"], "concurrent": load["concurrent"],
                "coalescer": stats, "launches": launches_by_run[name],
            }
            emit("serve-coalesce", name=name, **runs[name])
    reference = bodies["thread-window-0ms"]
    identical = {name: b == reference for name, b in bodies.items()}
    emit("serve-coalesce-identity", requests=len(reference), identical_to_uncoalesced=identical)
    if not all(identical.values()):
        raise RuntimeError(f"coalesced or aio answers differ from the uncoalesced "
                           f"thread engine's: {identical}")
    return {"runs": runs, "launches": launches_by_run}


def _metrics_value(base_url: str, series: str) -> float:
    with urllib.request.urlopen(base_url + "/metrics", timeout=60) as resp:
        for line in resp.read().decode().splitlines():
            if line.startswith(series + " "):
                return float(line.rsplit(" ", 1)[1])
    return 0.0


def _serve_admission(torch, dev, store) -> dict:
    """``serve-admission``: the aio front end with ``max_pending`` 8 and
    the coalescer on, under a burst of 64 simultaneous single rows, each
    on its own connection: the 429s carry ``Retry-After``, every 200 is
    the answer the same row gets unshed, and the ``/metrics`` shed count
    rises by exactly the 429s."""
    import threading

    import numpy as np

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    xs = [round(float(x), 3) for x in
          np.random.default_rng(9).uniform(0, 100, ADMISSION["burst"])]
    series = 'bodywork_tpu_serve_shed_total{reason="admission"}'
    reset_launches()
    handle = serve_latest_model(store, host="127.0.0.1", port=0, block=False, engine="auto",
                                device=dev, server_engine="aio", batch_window_ms=2.0,
                                max_pending=ADMISSION["max_pending"])
    try:
        conn = _connect(handle.base_url)
        unshed = {x: _score(conn, x)[2] for x in xs}
        conn.close()
        shed_before = _metrics_value(handle.base_url, series)
        conns = [_connect(handle.base_url) for _ in xs]
        for c in conns:
            c.connect()
        results = [None] * len(xs)
        start = threading.Barrier(len(xs))

        def one(i):
            start.wait()
            results[i] = _score(conns[i], xs[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c in conns:
            c.close()
        shed_after = _metrics_value(handle.base_url, series)
        state = handle.app.admission.state()
        high_water = handle.app.admission.max_observed_pending
        launches = dict(LAUNCHES)
    finally:
        handle.stop()
    statuses = [r[0] for r in results]
    sheds = [r for r in results if r[0] == 429]
    out = {"max_pending": ADMISSION["max_pending"], "burst": len(xs),
           "ok": statuses.count(200), "shed_429": len(sheds),
           "other": len(xs) - statuses.count(200) - len(sheds),
           "retry_after_s": sorted({r[1].get("Retry-After") for r in sheds}),
           "metrics_shed_delta": shed_after - shed_before,
           "max_observed_pending": high_water,
           "every_200_equals_unshed": all(r[2] == unshed[x] for x, r in zip(xs, results)
                                          if r[0] == 200),
           "admission_state": state, "launches": launches}
    emit("serve-admission", **out)
    if not sheds or out["other"] or None in out["retry_after_s"] \
            or high_water > ADMISSION["max_pending"]:
        raise RuntimeError(f"the burst was not shed with 429 + Retry-After: {out}")
    if not out["every_200_equals_unshed"] or out["metrics_shed_delta"] != len(sheds):
        raise RuntimeError(f"admission answers or counts are off: {out}")
    return out


def phase_serving(torch, dev, workdir: str) -> dict:
    """The serving machinery on the card (see the module docstring)."""
    store, second, hist = _serving_models(torch, dev, workdir)
    graph = _serve_graph(torch, dev, store)
    swap = _serve_graph_swap(torch, dev, store, second)
    overlap = _serve_graph_overlap(torch, dev, store, hist)
    coalesce = _serve_coalesce(torch, dev, store)
    admission = _serve_admission(torch, dev, store)
    torch.cuda.synchronize()
    launches = {engine: graph[engine]["launches"][engine] for engine in graph}
    return {"graph": graph, "swap": swap, "overlap": overlap, "coalesce": coalesce,
            "admission": admission, "launches_by_path": {
                "serve-graph": launches,
                "serve-graph-swap": swap["launches"],
                "serve-graph-overlap": overlap["launches"],
                "serve-coalesce": {e: sum(r[e] for r in coalesce["launches"].values())
                                   for e in VARIANTS},
                "serve-admission": admission["launches"]}}


def _check_traces(name: str, traces: list, coalesced_singles: bool) -> dict:
    """Hold one service's recorded traces to the tracing contract: the
    JAX package's spans in its order (``queue-wait`` on a coalesced single
    row), every coalesced member linked to one shared dispatch span, and
    the graph cache's ``aot_cache``/``bucket`` on every direct dispatch."""
    # identical bodies mint identical ids (the determinism contract), so a
    # root span id may name several requests
    by_root: dict = {}
    for t in traces:
        by_root.setdefault(t["root_span_id"], []).append(
            [s for s in t["spans"] if s["name"] == "device-dispatch"])
    shared = 0
    for t in traces:
        names = [s["name"] for s in t["spans"]]
        single = t["route"] == "/score/v1"
        want = (["parse", "queue-wait", "device-dispatch", "serialize"]
                if single and coalesced_singles else ["parse", "device-dispatch", "serialize"])
        if names != want or t["status"] != 200:
            raise RuntimeError(f"{name}: trace {t['trace_id']} spans {names} != {want}")
        dispatch = t["spans"][names.index("device-dispatch")]
        meta = dispatch["meta"]
        if meta.get("coalesced"):
            if t["root_span_id"] not in meta["links"] or len(meta["links"]) != meta["batch_rows"]:
                raise RuntimeError(f"{name}: a coalesced member's links are off: {meta}")
            for root in meta["links"]:
                if not any(o and o[0]["meta"] == meta
                           and o[0]["duration_s"] == dispatch["duration_s"]
                           for o in by_root.get(root, ())):
                    raise RuntimeError(f"{name}: linked member {root} does not hold the "
                                       f"shared dispatch span")
            shared += len(meta["links"]) > 1
        elif meta.get("aot_cache") not in ("warm", "hit", "miss") or "bucket" not in meta:
            raise RuntimeError(f"{name}: a direct dispatch span lacks aot_cache/bucket: {meta}")
    return {"traces": len(traces), "dispatches_shared_by_several": shared,
            "aot_cache": sorted({s["meta"].get("aot_cache", "-") for t in traces
                                 for s in t["spans"] if s["name"] == "device-dispatch"})}


def _span_breakdown(traces: list) -> dict:
    """Median ms of each span of single-row traces, and of the remainder
    (the trace's duration outside its spans: routing, the firewall, the
    coalescer's hand-off back)."""
    per: dict = {"parse": [], "queue-wait": [], "device-dispatch": [], "serialize": [],
                 "remainder": [], "trace": []}
    for t in traces:
        spans = {s["name"]: s["duration_s"] for s in t["spans"]}
        for key in ("parse", "queue-wait", "device-dispatch", "serialize"):
            if key in spans:
                per[key].append(spans[key])
        per["remainder"].append(t["duration_s"] - sum(spans.values()))
        per["trace"].append(t["duration_s"])
    return {k: 1e3 * statistics.median(v) for k, v in per.items() if v}


def phase_trace(torch, dev, workdir: str) -> dict:
    """``trace``: the 1024-wide MLP served on ``auto`` (-> ``kernel``) on
    the ``thread`` and ``aio`` front ends, coalescer off and on (2 ms, 64
    rows), at trace fraction 1.0: single rows one after another, one with
    an ingress ``traceparent``, one 4096-row batch, then 16 clients x 25
    single rows. Every response carries its 32-hex id in a header and in
    no body, the ingress id is kept, every trace holds the JAX package's
    spans (:func:`_check_traces`), the ``/healthz`` exemplars resolve to
    recorded traces, and the span breakdown of the 16 clients' requests
    is printed. Then ``trace-overhead``: config 7 on the ``thread`` front
    end, coalescer off, at fractions 0, 0.1, 1.0, 1.0, 0.1, 0."""
    import numpy as np

    from bodywork_tpu_torch.obs import registry, tracing
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import serve_latest_model

    store = _serving_models(torch, dev, workdir)[0]
    process_registry = registry.get_registry()
    rng = np.random.default_rng(13)
    singles = [round(float(x), 3) for x in rng.uniform(0, 100, TRACE["singles"])]
    batch = [round(float(x), 3) for x in rng.uniform(0, 100, TRACE["batch_rows"])]
    client_x = [[round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["per_client"])]
                for _ in range(COALESCE["clients"])]
    tracer = tracing.get_tracer()
    previous = (tracer.sample_fraction, tracer.seed)

    def serve(engine, window):
        return serve_latest_model(store, host="127.0.0.1", port=0, block=False,
                                  engine="auto", device=dev, server_engine=engine,
                                  batch_window_ms=window, batch_max_rows=COALESCE["max_rows"])

    runs = {}
    reset_launches()
    try:
        # room for every trace of a run: the exemplars must resolve
        tracing.configure_tracing(1.0, seed=0, recorder_capacity=4096)
        for engine in ("thread", "aio"):
            for window in COALESCE["windows"]:
                name = f"{engine}-window-{window:g}ms"
                tracer.recorder.clear()
                # a metrics registry of the service's own: the process's
                # latency histogram holds earlier phases' exemplars
                registry._DEFAULT = registry.Registry()
                handle = serve(engine, window)
                try:
                    conn = _connect(handle.base_url)
                    answers = [_post_json(conn, "/score/v1", {"X": x}) for x in singles]
                    ingress = _post_json(conn, "/score/v1", {"X": 50.0},
                                         {"traceparent": TRACE["ingress"]})
                    answers.append(_post_json(conn, "/score/v1/batch", {"X": batch}))
                    conn.close()
                    n_before = len(tracer.recorder)
                    load = _config7(handle, [], client_x)
                    health = get(handle.base_url + "/healthz")
                finally:
                    handle.stop()
                traces = tracer.recorder.snapshot()
                header = "X-Bodywork-Trace-Id"
                for status, headers, sent, body, _s in answers:
                    trace_id = headers.get(header, "")
                    if (status != 200 or trace_id != tracing.mint_trace_id(0, sent)
                            or trace_id.encode() in body):
                        raise RuntimeError(f"{name}: a response's trace id is off: "
                                           f"{status} {trace_id!r}")
                load_ids = [h.get(header) for _st, h, _b, _s in load["answers"]]
                if not all(i and len(i) == 32 for i in load_ids):
                    raise RuntimeError(f"{name}: a concurrent response lacks its trace id")
                by_id = {t["trace_id"]: t for t in traces}
                kept = ingress[1].get(header) == TRACE["ingress"][3:35]
                ingress_doc = by_id.get(TRACE["ingress"][3:35], {})
                exemplars = health["latency_exemplars"] or {}
                checks = _check_traces(name, traces, coalesced_singles=window > 0)
                runs[name] = {
                    "engine": engine, "window_ms": window, "requests": len(answers) + 1
                    + len(load["answers"]) + len(client_x) + 20, **checks,
                    "ingress_id_kept": kept,
                    "ingress_parent_span_id": ingress_doc.get("parent_span_id"),
                    "exemplars": len(exemplars),
                    "exemplars_resolve": bool(exemplars) and set(exemplars.values()) <= set(by_id),
                    "client_ms_16_clients": {"p50": load["concurrent"]["p50_ms"],
                                             "p99": load["concurrent"]["p99_ms"]},
                    "span_ms_16_clients_median": _span_breakdown(
                        [t for t in traces[n_before:] if t["route"] == "/score/v1"]),
                }
                emit("trace", name=name, **runs[name])
                if (checks["traces"] != runs[name]["requests"] or not kept
                        or ingress_doc.get("parent_span_id") != TRACE["ingress"][36:52]
                        or not runs[name]["exemplars_resolve"]
                        or (window > 0 and not checks["dispatches_shared_by_several"])):
                    raise RuntimeError(f"{name}: the traces break the contract: {runs[name]}")
        registry._DEFAULT = process_registry
        launches = dict(LAUNCHES)
        if launches["kernel"] < 1:
            raise RuntimeError(f"the traced services launched no kernel: {launches}")
        overhead = {}
        seq_x = [round(float(x), 3) for x in rng.uniform(0, 100, COALESCE["sequential"])]
        for i, fraction in enumerate(TRACE["fractions"]):
            tracing.configure_tracing(fraction, seed=0, recorder_capacity=4096)
            handle = serve("thread", 0)
            try:
                load = _config7(handle, seq_x, client_x)
            finally:
                handle.stop()
            if any(a[0] != 200 for a in load["answers"]):
                raise RuntimeError(f"trace-overhead: a request failed at {fraction}")
            overhead[f"{i}:{fraction:g}"] = row = {
                "fraction": fraction, "window_ms": 0, "turn": i,
                "sequential_p50_ms": load["sequential"]["p50_ms"],
                "sequential_p99_ms": load["sequential"]["p99_ms"],
                "requests_per_s_16_clients": load["concurrent"]["requests_per_s"],
                "p99_ms_16_clients": load["concurrent"]["p99_ms"],
                "traces_recorded": len(tracer.recorder),
            }
            emit("trace-overhead", engine="thread", **row)
    finally:
        registry._DEFAULT = process_registry
        tracing.configure_tracing(*previous, recorder_capacity=tracing.DEFAULT_RECORDER_CAPACITY)
    return {"runs": runs, "overhead": overhead, "launches": launches,
            "launches_all": dict(LAUNCHES)}


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
        "train_rows": train.n_rows, "train_mode": train.mode,
        "fallback_reason": train.fallback_reason, "rows_touched": train.rows_touched,
        "train_metrics": train.metrics,
        "test_metrics": {k: test[k] for k in ("MAPE", "r_squared", "max_residual",
                                             "n_failures", "n_scored")},
        "wall_clock_s": r.wall_clock_s, "stage_seconds": r.stage_seconds,
        # the overlap: whether generate persisted prefetched draws, and the
        # lookahead train's own seconds on its thread (the train stage's
        # seconds are then its wait for that thread)
        "prefetched": r.prefetched, "lookahead_train_s": r.lookahead_train_s,
    }
    values = [*train.metrics.values(), test["MAPE"]]
    if not all(math.isfinite(v) for v in values) or test["n_failures"] != 0:
        raise RuntimeError(f"{model_type} day {r.day} is not healthy: {line}")
    # a gate that raised is logged and the day goes on; here it fails the phase
    if not isinstance(gate, GateDecision) or health["model_source"] != "production":
        raise RuntimeError(f"{model_type} day {r.day} was not gated and served from "
                           f"production: {line}")
    return line


def _array_holds(a) -> dict:
    """Type, device, dtype and bytes of one array a box or result holds."""
    import torch

    if isinstance(a, torch.Tensor):
        return {"type": "torch.Tensor", "device": str(a.device), "dtype": str(a.dtype),
                "bytes": a.numel() * a.element_size()}
    return {"type": f"{type(a).__module__}.{type(a).__name__}", "device": "host",
            "dtype": str(a.dtype), "bytes": int(a.nbytes)}


def _prefetch_box(runner) -> dict:
    """What the oldest prefetch box that no generate stage has popped yet
    holds, read from the runner between two days (its draws made on the
    worker thread). Fails unless X and y are host numpy arrays, as the
    generator returns them: a box on the card would pin device memory
    across days."""
    import numpy as np

    with runner._gen_lock:
        pending = sorted(runner._dataset_boxes.items(), key=lambda kv: kv[0])
    if not pending:
        return {"pending_boxes": 0}
    target, box = pending[0]
    if not box["ready"].wait(120) or "X" not in box:
        raise RuntimeError(f"the prefetch box for {target} was not filled")
    held = {"target": str(target), "pending_boxes": len(pending),
            "X": _array_holds(box["X"]), "y": _array_holds(box["y"])}
    if not all(isinstance(box[k], np.ndarray) for k in ("X", "y")):
        raise RuntimeError(f"the prefetch box does not hold host numpy arrays: {held}")
    return held


def _run_loop(torch, dev, root: str, model_type: str, train_args: dict,
              n_days: int = LOOP_DAYS, line: str = "day-loop-day", on_day=None,
              overlap_generate: bool = False) -> dict:
    """``n_days`` days of the default pipeline on the card, through
    ``run_simulation`` (the journal, the horizon prefetch, the lookahead
    train and the compactor); the kernels' launch counts are set to 0 just
    before it and read just after. Fails unless every day persisted
    prefetched draws and every day but the first collected a lookahead: a
    background step that fell back inline would hide a failure on the
    card. ``on_day(r)`` runs after each day's line; after the first day's,
    a pending prefetch box is read (``_prefetch_box``)."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.serve import GRAPH_CACHE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline(model_type, "batch", overlap_generate=overlap_generate)
    spec.stages[TRAIN_STAGE].args.update(train_args)
    name = f"{model_type}-{train_args.get('mode', 'full')}"
    runner = LocalRunner(spec, FilesystemStore(os.path.join(root, name)), device=dev)
    days, seen, box = [], {"kernel": 0, "captures": 0}, {}

    def _on_day(r):
        launched = LAUNCHES["kernel"] - seen["kernel"]
        seen["kernel"] = LAUNCHES["kernel"]
        captures = GRAPH_CACHE.stats()["captures"]
        days.append({**_day_line(model_type, r, launched),
                     "graph_captures": captures - seen["captures"],
                     "buckets": r.stage_results[SERVE_STAGE].app.predictor.buckets})
        seen["captures"] = captures
        emit(line, **days[-1])
        if not box:
            box.update(_prefetch_box(runner))
        if on_day is not None:
            on_day(r)

    # a cold graph cache: day 1 captures its buckets, later days rebind
    GRAPH_CACHE.reset()
    reset_launches()
    results = runner.run_simulation(LOOP_START, n_days, on_day=_on_day)
    launches = dict(LAUNCHES)
    walls = [r.wall_clock_s for r in results]
    stages = {name: statistics.median(r.stage_seconds[name] for r in results[1:])
              for name in results[0].stage_seconds}
    prefetched = sum(r.prefetched for r in results)
    collected = sum(r.lookahead_train_s is not None for r in results)
    summary = {"model": model_type, "days": n_days, "launches": launches,
               "engines": sorted({d["engine"] for d in days}),
               "gate_verdicts": [d["gate"]["promote"] for d in days],
               "served_sources": sorted({d["served_source"] for d in days}),
               "gate_seconds": [r.gate_seconds for r in results],
               "median_gate_seconds_days_2_7": statistics.median(
                   r.gate_seconds for r in results[1:]),
               "wall_clock_s": walls, "day1_s": walls[0],
               "median_days_2_7_s": statistics.median(walls[1:]),
               "median_stage_seconds_days_2_7": stages,
               "prefetched": prefetched, "lookaheads_collected": collected,
               "lookahead_train_s": [r.lookahead_train_s for r in results],
               "graph_captures_per_day": [d["graph_captures"] for d in days],
               "prefetch_box_after_day_1": box,
               "runs_through": "run_simulation: journal, horizon prefetch, lookahead train and "
                       "compactor; the train stage's seconds are its wait "
                       "for the lookahead from day 2 on"}
    if prefetched != n_days or collected != n_days - 1:
        raise RuntimeError(f"{name}: {prefetched} prefetched of {n_days} days, "
                           f"{collected} lookaheads collected of {n_days - 1}: a "
                           "background step fell back inline")
    captures = summary["graph_captures_per_day"]
    if captures[0] != len(days[0]["buckets"]) or any(captures[1:]):
        raise RuntimeError(f"{name}: graph captures per day {captures}: day 1 must capture "
                           f"its {len(days[0]['buckets'])} buckets and later days none")
    return {"summary": summary, "days": days, "runner": runner, "results": results}


def _strip_column(data: bytes, column: str) -> bytes:
    """A CSV without one column, textually (every other byte kept)."""
    lines = data.decode().splitlines()
    header = lines[0].split(",")
    if column not in header:
        return data
    i = header.index(column)
    return "\n".join(",".join(f for j, f in enumerate(line.split(",")) if j != i)
                     for line in lines).encode()


def _results_of(root: str) -> dict:
    """The store's results by key: its journals and snapshots (operational
    state) left out, the test metrics without their wall-clock response
    time."""
    from bodywork_tpu_torch.store import FilesystemStore

    store = FilesystemStore(root)
    return {key: (_strip_column(store.get_bytes(key), "mean_response_time")
                  if key.startswith("test-metrics/") else store.get_bytes(key))
            for key in store.list_keys() if not key.startswith(("runs/", "snapshots/"))}


def _compare_results(a: dict, b: dict) -> dict:
    """Keys on one side only, and keys whose bytes differ."""
    return {"compared": len(set(a) & set(b)),
            "only_in_first": sorted(set(a) - set(b)),
            "only_in_second": sorted(set(b) - set(a)),
            "differ": sorted(k for k in set(a) & set(b) if a[k] != b[k])}


def _params_bytes(params) -> tuple[int, list]:
    """Bytes and devices of a model's parameter tensors."""
    import torch

    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size(), [str(params.device)]
    items = params.values() if isinstance(params, dict) else params
    total, devices = 0, []
    for p in items:
        n, d = _params_bytes(p)
        total += n
        devices += d
    return total, devices


def _pipelined(torch, dev, workdir: str, mlp: dict) -> dict:
    """The MLP loop's first SERIAL_DAYS days (``run_simulation``, its store
    copied after day SERIAL_DAYS) against a serial loop of plain
    ``run_day(..., lookahead_train=False)`` calls with no prefetch:
    datasets, checkpoints, metrics and registry records byte-identical.
    The per-day overlap readings and what the background steps hold."""
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TEST_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore

    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update(LOOP_MLP)
    serial = LocalRunner(spec, FilesystemStore(os.path.join(workdir, "serial")), device=dev)
    serial._enqueue_generate = lambda targets: None  # no prefetch: generate inline
    serial.bootstrap(LOOP_START)
    reset_launches()
    serial_days = [serial.run_day(LOOP_START + timedelta(days=i), lookahead_train=False)
                   for i in range(SERIAL_DAYS)]
    serial_launches = dict(LAUNCHES)
    gap = _compare_results(_results_of(mlp["copy"]), _results_of(serial.store.root))
    results = mlp["results"]
    model = results[1].stage_results[TRAIN_STAGE].model
    param_bytes, param_devices = _params_bytes(model.params)
    out = {
        "days": len(results), "serial_days": SERIAL_DAYS,
        "prefetched": sum(r.prefetched for r in results),
        "lookaheads_collected": sum(r.lookahead_train_s is not None for r in results),
        "per_day": [{"day": str(r.day), "train_stage_s": r.stage_seconds[TRAIN_STAGE],
                     "lookahead_train_s": r.lookahead_train_s,
                     "test_stage_s": r.stage_seconds[TEST_STAGE],
                     "wall_clock_s": r.wall_clock_s} for r in results],
        "serial_per_day": [{"day": str(r.day), "train_stage_s": r.stage_seconds[TRAIN_STAGE],
                            "test_stage_s": r.stage_seconds[TEST_STAGE],
                            "wall_clock_s": r.wall_clock_s} for r in serial_days],
        "serial_launches": serial_launches,
        "byte_identity": gap,
        # what the background steps hold while the next day runs: a box
        # read between days 1 and 2, and day 2's collected lookahead model
        "prefetch_box": mlp["summary"]["prefetch_box_after_day_1"],
        "lookahead_result": {"holds": f"TrainResult, {type(model).__name__} params",
                             "bytes": param_bytes, "devices": sorted(set(param_devices))},
    }
    emit("pipelined", **out)
    if out["prefetched"] != len(results) or out["lookaheads_collected"] != len(results) - 1:
        raise RuntimeError(f"a pipelined background step fell back inline: {out}")
    if gap["differ"] or gap["only_in_first"] or gap["only_in_second"] or not gap["compared"]:
        raise RuntimeError(f"the pipelined loop's artefacts differ from the serial ones: {gap}")
    if serial_launches["kernel"] < SERIAL_DAYS:
        raise RuntimeError(f"the serial loop did not serve through the kernel: {serial_launches}")
    overlap = _overlapped(torch, dev, workdir, serial.store.root)
    return {"serial_launches": serial_launches, "overlap_launches": overlap["launches"], **out}


def _overlapped(torch, dev, workdir: str, serial_root: str) -> dict:
    """The overlapped DAG (``default_pipeline(overlap_generate=True)``:
    generate beside serve, ``s1 >> s2,s3 >> s4``) through
    ``run_simulation`` over the serial loop's days, with the same
    no-fallback counts: byte-identical to the serial loop."""
    from bodywork_tpu_torch.pipeline.spec import GENERATE_STAGE, SERVE_STAGE

    loop = _run_loop(torch, dev, os.path.join(workdir, "overlap"), "mlp", LOOP_MLP,
                     n_days=SERIAL_DAYS, line="pipelined-overlap-day", overlap_generate=True)
    gap = _compare_results(_results_of(os.path.join(workdir, "overlap", "mlp-full")),
                           _results_of(serial_root))
    dag = loop["runner"].spec.dag
    out = {**loop["summary"], "dag": dag, "byte_identity_vs_serial": gap}
    emit("pipelined-overlap", **out)
    if [SERVE_STAGE, GENERATE_STAGE] not in dag:
        raise RuntimeError(f"the overlapped DAG does not run generate beside serve: {dag}")
    if gap["differ"] or gap["only_in_first"] or gap["only_in_second"] or not gap["compared"]:
        raise RuntimeError(f"the overlapped loop's artefacts differ from the serial ones: {gap}")
    if any(d["engine"] != "kernel" or d["launches"] < 1 for d in loop["days"]):
        raise RuntimeError(f"the overlapped loop did not serve through the kernel: {out}")
    return out


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
    copy = os.path.join(workdir, "mlp-after-serial-days")

    def copy_after(r):
        # the store as the serial loop will leave it: written by days 1-3
        # (the lookahead of day 4 computes but writes nothing yet)
        if r.day == LOOP_START + timedelta(days=SERIAL_DAYS - 1):
            shutil.copytree(os.path.join(workdir, "mlp-full"), copy,
                            ignore=shutil.ignore_patterns("snapshots", "runs"))

    mlp = _run_loop(torch, dev, workdir, "mlp", LOOP_MLP, on_day=copy_after)
    bad = [d["day"] for d in mlp["days"] if d["engine"] != "kernel" or d["launches"] < 1]
    if bad:
        raise RuntimeError(f"the MLP loop did not serve through the kernel on {bad}")
    emit("day-loop", **mlp["summary"])
    pipelined = _pipelined(torch, dev, workdir, {**mlp, "copy": copy})

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
            "card_vs_cpu": parity["max_rel_gap"], "rejection": rejection,
            "pipelined": pipelined}


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
        fit_keys,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PARITY_STEPS})
    ds = load_all_datasets(store)
    arrays = [torch.as_tensor(a) for a in pad_rows(ds.X, ds.y)]
    k_init, k_train = fit_keys(11)
    net = init_mlp_params(k_init, WIDTHS)
    idx = draw_indices(k_train, PARITY_STEPS, cfg.batch_size, arrays[0].shape[0])

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
        fit_keys,
        init_mlp_params,
        train_core,
    )

    cfg = MLPConfig(**{**LOOP_MLP, "n_steps": PROFILE_STEPS})
    ds = load_all_datasets(store)
    Xp, yp, w = (torch.as_tensor(a, device=dev) for a in pad_rows(ds.X, ds.y))
    Xs, ys, _ = _scaled_splits(Xp, yp, w)
    k_init, k_train = fit_keys(12)
    net = init_mlp_params(k_init, WIDTHS, device=dev)
    idx = draw_indices(k_train, PROFILE_STEPS, cfg.batch_size, Xp.shape[0], device=dev)

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


def phase_mlp_draws(torch, dev) -> dict:
    """The seeded MLP fit's threefry draws on the card against the CPU:
    the 2000-step minibatch index stream (batch 256) over the 7-day
    loop's padded rows and over a row count that is not a power of two,
    and the 1024-wide He init, all bit-equal; with the card's times (the
    host walk of the key chain inside the index draw, timed alone too)."""
    from bodywork_tpu_torch.data import prng
    from bodywork_tpu_torch.models.mlp import draw_indices, fit_keys, init_mlp_params

    k_init, k_train = fit_keys(0)
    steps, batch = LOOP_MLP["n_steps"], LOOP_MLP["batch_size"]
    cpu = torch.device("cpu")
    equal = {}
    for rows in DRAW_ROWS:
        card = draw_indices(k_train, steps, batch, rows, device=dev).cpu()
        host = draw_indices(k_train, steps, batch, rows, device=cpu)
        equal[rows] = bool(torch.equal(card, host)) and card.shape == (steps, batch)
    card_net = init_mlp_params(k_init, WIDTHS, device=dev)
    host_net = init_mlp_params(k_init, WIDTHS, device=cpu)
    init_equal = all(
        torch.equal(a[k].cpu().view(torch.int32), b[k].view(torch.int32))
        for a, b in zip(card_net["layers"], host_net["layers"]) for k in ("w", "b"))

    def timed_ms(fn) -> float:
        times = []
        for _ in range(DRAW_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    out = {"steps": steps, "batch": batch, "rows": list(DRAW_ROWS),
           "indices_bit_equal": equal, "init_widths": list(WIDTHS),
           "init_bit_equal": init_equal, "reps": DRAW_REPS,
           "draw_indices_ms": timed_ms(
               lambda: draw_indices(k_train, steps, batch, DRAW_ROWS[0], device=dev)),
           "key_chain_host_ms": timed_ms(lambda: prng.key_chain(k_train, steps)),
           "init_ms": timed_ms(lambda: init_mlp_params(k_init, WIDTHS, device=dev))}
    emit("mlp-draws", **out)
    if not all(equal.values()) or not init_equal:
        raise RuntimeError(f"the card's MLP draws differ from the CPU's: {out}")
    return out


def _linear_refit_gap(store, doc) -> dict:
    """The trainstate's solution against an independent float64 refit
    (``np.linalg.lstsq``) over the union of the covered days' train
    splits (``bench.py:2548``, ``_linear_coefficient_check``)."""
    import numpy as np

    from bodywork_tpu_torch.data.io import load_dataset
    from bodywork_tpu_torch.models.linear import solve_normal_eq
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
    from bodywork_tpu_torch.train.incremental import day_split_indices

    split = doc["split"]
    Xs, ys = [], []
    for key, d in store.history(DATASETS_PREFIX):
        if str(d) not in doc["days"]:
            continue
        ds = load_dataset(store, key)
        train_idx, _ = day_split_indices(len(ds), d, split["test_size"], split["seed"])
        Xs.append(np.asarray(ds.X, np.float64)[train_idx])
        ys.append(np.asarray(ds.y, np.float64)[train_idx])
    X, y = np.concatenate(Xs), np.concatenate(ys)
    theta = np.linalg.lstsq(np.concatenate([X, np.ones((len(y), 1))], axis=1), y,
                            rcond=None)[0]
    host = solve_normal_eq(doc["cum_g"], doc["cum_c"])
    got = np.concatenate([np.asarray(host["w"], np.float64).ravel(), [float(host["b"])]])
    return {"days": len(doc["days"]), "rows": int(len(y)), "coefficients": got.tolist(),
            "refit": theta.tolist(), "max_abs_gap": float(np.max(np.abs(got - theta))),
            "atol": REFIT_ATOL}


def _incremental_linear(torch, dev, workdir: str) -> dict:
    """(a) The linear loop on the card for INC_LINEAR_DAYS days in
    ``mode="incremental"`` (day 1 builds the trainstate): the per-day
    train seconds and their last-third over first-third ratio over days
    2 on, the final coefficients against a float64 refit, and the
    trainstate bytes against the same days folded on the CPU."""
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, trainstate_key
    from bodywork_tpu_torch.train import train_on_history
    from bodywork_tpu_torch.train.incremental import read_trainstate

    loop = _run_loop(torch, dev, workdir, "linear", {"mode": "incremental"},
                     n_days=INC_LINEAR_DAYS, line="incremental-day")
    store = loop["runner"].store
    train_s = [r.stage_seconds[TRAIN_STAGE] for r in loop["results"]]
    # day 1 apart: it builds the trainstate and carries the process's
    # first use of the card's solver and copies (PERF.md section 2)
    steady = train_s[1:]
    third = len(steady) // 3
    doc, _token, reason = read_trainstate(store, "linear")
    gap = _linear_refit_gap(store, doc)
    # the same days folded one by one on the CPU, from the card's datasets
    cpu_store = FilesystemStore(os.path.join(workdir, "linear-incremental-cpu"))
    for key, d in store.history(DATASETS_PREFIX):
        if str(d) in doc["days"]:
            cpu_store.put_bytes(key, store.get_bytes(key))
            train_on_history(cpu_store, "linear", mode="incremental", device="cpu")
    key = trainstate_key("linear")
    out = {"days": INC_LINEAR_DAYS, "train_seconds": train_s, "day1_train_s": train_s[0],
           "last_third_over_first_third_days_2_on": (statistics.mean(steady[-third:])
                                                     / statistics.mean(steady[:third])),
           "median_train_s_days_2_on": statistics.median(steady),
           "modes": [d["train_mode"] for d in loop["days"]],
           "fallback_reasons": [d["fallback_reason"] for d in loop["days"]],
           "rows_touched": [d["rows_touched"] for d in loop["days"]],
           "gate_verdicts": [d["gate"]["promote"] for d in loop["days"]],
           "trainstate_reason": reason, "coefficient_check": gap,
           "trainstate_bytes": len(store.get_bytes(key)),
           "trainstate_equal_to_cpu": store.get_bytes(key) == cpu_store.get_bytes(key),
           "wall_clock_s": loop["summary"]["wall_clock_s"],
           "prefetched": loop["summary"]["prefetched"],
           "lookaheads_collected": loop["summary"]["lookaheads_collected"],
           "runs_through": loop["summary"]["runs_through"]}
    emit("incremental-linear", **out)
    if reason is not None or gap["max_abs_gap"] >= REFIT_ATOL:
        raise RuntimeError(f"the incremental linear solution is off the refit: {gap}")
    if not out["trainstate_equal_to_cpu"]:
        raise RuntimeError("the card's trainstate differs from the CPU's for the same days")
    if set(out["modes"]) != {"incremental"} or out["fallback_reasons"][1:] != \
            [None] * (INC_LINEAR_DAYS - 1):
        raise RuntimeError(f"the linear loop did not fold incrementally: {out}")
    return {**out, "store": store}


def _incremental_mlp(torch, dev, workdir: str) -> dict:
    """(b) The 1024-wide MLP loop for LOOP_DAYS days in ``mode=
    "incremental"``: day 1 a full refit (no donor yet), days 2-7
    fine-tunes of production (a quarter of the steps), each gated with
    shadow evaluation, production served through ``kernel``."""
    loop = _run_loop(torch, dev, workdir, "mlp", {**LOOP_MLP, "mode": "incremental"},
                     line="incremental-day")
    days = loop["days"]
    summary = {**loop["summary"],
               "modes": [d["train_mode"] for d in days],
               "fallback_reasons": [d["fallback_reason"] for d in days],
               "train_seconds": [r.stage_seconds["stage-1-train-model"]
                                 for r in loop["results"]]}
    emit("incremental-mlp", **summary)
    # day 1 has no donor; every later day fine-tunes, or refits in full
    # after the gate rejected its fine-tune
    later = list(zip(summary["modes"], summary["fallback_reasons"]))[1:]
    if days[0]["fallback_reason"] != "no_donor" or any(
            d not in (("incremental", None), ("full", "gate_rejected")) for d in later):
        raise RuntimeError(f"the MLP loop did not train incrementally: {summary}")
    bad = [d["day"] for d in days if d["engine"] != "kernel" or d["launches"] < 1]
    if bad:
        raise RuntimeError(f"the incremental MLP loop did not serve through the kernel on {bad}")
    return {"summary": summary, "runner": loop["runner"]}


def _incremental_rejection(torch, dev, store, workdir: str) -> dict:
    """(c) On a copy of (b)'s store, day 8 with a fine-tune made to fail
    (it trains on all-zero labels): the gate rejects the incremental
    candidate, the runner refits in full the same day
    (``fallback_reason="gate_rejected"``), gates the refit and serves it
    through ``kernel`` (launches counted over the day)."""
    from bodywork_tpu_torch.models.mlp import MLPRegressor
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE, TRAIN_STAGE
    from bodywork_tpu_torch.registry.records import load_record
    from bodywork_tpu_torch.store import FilesystemStore

    copy = FilesystemStore(shutil.copytree(store.root, os.path.join(workdir, "inc-rejection")))
    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update({**LOOP_MLP, "mode": "incremental"})
    day = LOOP_START + timedelta(days=LOOP_DAYS)
    real = MLPRegressor.fine_tune

    def failing_fine_tune(self, X, y, n_steps, seed=None):
        return real(self, X, torch.zeros(len(y)).numpy(), n_steps, seed=seed)

    MLPRegressor.fine_tune = failing_fine_tune
    try:
        reset_launches()
        r = LocalRunner(spec, copy, device=dev).run_day(day)
        launches = dict(LAUNCHES)
    finally:
        MLPRegressor.fine_tune = real
    line = _day_line("mlp", r, launches["kernel"])
    final = r.stage_results[TRAIN_STAGE]
    history = [e["event"] for e in load_record(copy, final.model_artefact_key)["history"]]
    out = {**line, "record_events": history, "launches_all": launches}
    emit("incremental-gate-rejection", **out)
    served = r.stage_results[SERVE_STAGE].app.healthz_payload()
    if (final.mode, final.fallback_reason) != ("full", "gate_rejected"):
        raise RuntimeError(f"no same-day full refit after the rejection: {out}")
    if "gate_decision" not in history[:-1] or history[-1] != "promoted":
        raise RuntimeError(f"the refit was not re-gated and promoted: {history}")
    if served["model_key"] != final.model_artefact_key or launches["kernel"] < 1:
        raise RuntimeError(f"the refit was not served through the kernel: {out}")
    return out


def phase_incremental(torch, dev, workdir: str) -> dict:
    linear = _incremental_linear(torch, dev, workdir)
    snapshot = _cold_snapshot_train(torch, dev, linear.pop("store"), workdir)
    mlp = _incremental_mlp(torch, dev, workdir)
    rejection = _incremental_rejection(torch, dev, mlp["runner"].store, workdir)
    return {"linear": linear, "mlp": mlp["summary"], "rejection": rejection,
            "snapshot": snapshot, "store": mlp["runner"].store}


#: ``python -c`` driver of the cli that prints the process's
#: ``bodywork_tpu_runner_resumes_total`` series to stderr each time the
#: runner counts one, so a process the kill switch ends still reports it
_RESUME_PROBE = """
import sys
from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.pipeline import journal
real = journal.count_resume
def count_resume(outcome):
    real(outcome)
    for line in get_registry().render().splitlines():
        if line.startswith("bodywork_tpu_runner_resumes_total{"):
            print("RESUMES " + line, file=sys.stderr, flush=True)
journal.count_resume = count_resume
from bodywork_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def _cli(args: list, env: dict | None = None, timeout: float = 300,
         count_resumes: bool = False) -> dict:
    """``python -m bodywork_tpu_torch.cli ARGS`` from the checkout: its
    exit code, output and seconds; with ``count_resumes``, also the
    ``runner_resumes_total`` samples the process counted (``resumes``:
    outcome -> value at its last count)."""
    import re

    t0 = time.perf_counter()
    cmd = ["-c", _RESUME_PROBE] if count_resumes else ["-m", "bodywork_tpu_torch.cli"]
    proc = subprocess.run(
        [sys.executable, *cmd, *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, **(env or {})},
        capture_output=True, text=True, timeout=timeout,
    )
    out = {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr,
           "seconds": time.perf_counter() - t0}
    if count_resumes:
        out["resumes"] = {m[1]: float(m[2]) for m in re.finditer(
            r'^RESUMES bodywork_tpu_runner_resumes_total\{outcome="(\w+)"\} (\S+)$',
            proc.stderr, re.M)}
    return out


def _mlp_day_args(store: str, day: date) -> list:
    """``run-day`` of the 1024-wide MLP day (the loop's settings)."""
    return ["run-day", "--store", store, "--date", str(day), "--model", "mlp",
            "--mlp-hidden", ",".join(map(str, HIDDEN)),
            "--mlp-steps", str(LOOP_MLP["n_steps"]), "--mlp-lr", str(LOOP_MLP["learning_rate"])]


def _served(out: str) -> dict | None:
    """The ``served:`` line of a ``run-day`` day: key, source, engine and
    the served kernel's launches in that process, with the next line's
    launches of every kernel in that process."""
    import re

    m = re.search(r"served: (\S+) \((\w+)\) on (\S+), (\d+) kernel launches", out)
    by_kernel = re.search(r"launches by kernel in this process: (\{.*\})$", out, re.M)
    if m is None or by_kernel is None:
        return None
    return {"model_key": m[1], "model_source": m[2], "engine": m[3],
            "launches": int(m[4]), "launches_by_kernel": json.loads(by_kernel[1])}


def _day_seconds(out: str, day: date) -> float | None:
    import re

    m = re.search(rf"^day {day}: ([0-9.]+)s$", out, re.M)
    return None if m is None else float(m[1])


def _rehash_seconds(store, day: date) -> tuple[float, int]:
    """Seconds to re-hash every artefact the day's journal recorded (the
    digest check a resume makes), and the bytes hashed."""
    from bodywork_tpu_torch.pipeline.journal import artefact_digest
    from bodywork_tpu_torch.store.schema import run_journal_key

    doc = json.loads(store.get_bytes(run_journal_key(day)))
    keys = [k for e in doc["stages"].values() for k in (e.get("artefacts") or {})]
    t0 = time.perf_counter()
    n = 0
    for key in keys:
        data = store.get_bytes(key)
        n += len(data)
        artefact_digest(data)
    return time.perf_counter() - t0, n


def _journal_day_seconds(store, day: date) -> float:
    """Seconds of one fresh day's journal writes on this machine's disk:
    acquire, the intent and complete marks of the default pipeline's four
    steps (the service's step records no complete) and the closing write."""
    from bodywork_tpu_torch.pipeline.journal import RunJournal, artefact_digest

    t0 = time.perf_counter()
    j = RunJournal(store, day, owner="timing", lease_ttl_s=60)
    j.acquire()
    for stage, done in (("train", True), ("serve", False), ("generate", True), ("test", True)):
        j.record_intents([stage])
        if done:
            j.record_completes({stage: {"k": artefact_digest(b"x")}})
    j.record_day_complete()
    return time.perf_counter() - t0


def phase_resume(torch, dev, workdir: str) -> dict:
    """A killed MLP day (width 1024, full mode) resumed through the
    command line: ``run-day`` killed by the kill switch at the step
    boundary after train (so the gate ran and serve did not) exits
    ``EXIT_KILLED``; the restart exits 0, skips train on the journal's
    digests and serves ``production`` through ``kernel``; a third run is a
    no-op (6); a live foreign lease exits 5. Every artefact is
    byte-identical to an uncrashed twin day run in this process, the
    checkpoint being the killed run's own, re-verified and not rewritten."""
    from bodywork_tpu_torch.chaos.kill import ENV_SCHEDULE, EXIT_KILLED
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.journal import (
        LEASE_LOST_EXIT,
        RESUMED_NOOP_EXIT,
        RunJournal,
        artefact_digest,
    )
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import model_key, run_journal_key

    spec = default_pipeline("mlp", "batch")
    spec.stages[TRAIN_STAGE].args.update(LOOP_MLP)
    day = LOOP_START
    twin = LocalRunner(spec, FilesystemStore(os.path.join(workdir, "twin")), device=dev)
    twin.bootstrap(day)
    reset_launches()
    full = twin.run_day(day)
    twin_launches = dict(LAUNCHES)
    root = os.path.join(workdir, "resumed")
    store = FilesystemStore(root)
    LocalRunner(spec, store, device=dev).bootstrap(day)
    args = _mlp_day_args(root, day)
    ttl = {"BODYWORK_TPU_RUN_LEASE_TTL_S": "1"}
    killed = _cli(args, {**ttl, ENV_SCHEDULE: '[{"kind": "stage_boundary", "n": 1}]'},
                  count_resumes=True)
    doc = json.loads(store.get_bytes(run_journal_key(day)))
    ckpt = model_key(day)
    killed_digest = artefact_digest(store.get_bytes(ckpt))
    time.sleep(1.5)  # the killed runner's lease expires
    resumed = _cli(args, ttl, count_resumes=True)
    noop = _cli(args, ttl, count_resumes=True)
    RunJournal(store, day + timedelta(days=1), owner="foreign:1:live",
               lease_ttl_s=900).acquire()
    leased = _cli(_mlp_day_args(root, day + timedelta(days=1)), ttl)
    served = _served(resumed["out"])
    twin_results, resumed_results = _results_of(twin.store.root), _results_of(root)
    gap = _compare_results(twin_results, resumed_results)
    rehash_s, rehash_bytes = _rehash_seconds(store, day)
    counted = [killed["resumes"], resumed["resumes"], noop["resumes"]]
    out = {
        "day": str(day), "twin_day_s": full.wall_clock_s, "twin_launches": twin_launches,
        "runner_resumes_total": counted,
        "killed": {"rc": killed["rc"], "want": EXIT_KILLED, "process_s": killed["seconds"],
                   "journal_train_state": doc["stages"].get(TRAIN_STAGE, {}).get("state"),
                   "journal_status": doc["status"]},
        "resumed": {"rc": resumed["rc"], "process_s": resumed["seconds"],
                    "day_s": _day_seconds(resumed["out"], day),
                    "skipped_train": f"skipped {TRAIN_STAGE} (journal-verified)" in resumed["out"],
                    "served": served},
        "noop": {"rc": noop["rc"], "want": RESUMED_NOOP_EXIT, "process_s": noop["seconds"]},
        "lease_lost": {"rc": leased["rc"], "want": LEASE_LOST_EXIT,
                       "process_s": leased["seconds"]},
        "checkpoint": {"key": ckpt, "killed_run_digest": killed_digest,
                       "after_resume_digest": artefact_digest(store.get_bytes(ckpt)),
                       "twin_digest": artefact_digest(twin.store.get_bytes(ckpt))},
        "byte_identity_vs_twin": gap,
        "digests_resumed_vs_twin": {
            key: [artefact_digest(data)[7:23], artefact_digest(twin_results[key])[7:23]]
            for key, data in resumed_results.items() if key in twin_results},
        "resume_rehash_s": rehash_s, "resume_rehash_bytes": rehash_bytes,
        "journal_writes_day_s": _journal_day_seconds(
            FilesystemStore(os.path.join(workdir, "journal-timing")), day),
    }
    emit("resume", **out)
    if (killed["rc"], resumed["rc"], noop["rc"], leased["rc"]) != (
            EXIT_KILLED, 0, RESUMED_NOOP_EXIT, LEASE_LOST_EXIT):
        raise RuntimeError(f"resume exit codes are off: {out}\n{resumed['err'][-3000:]}")
    if counted != [{"fresh": 1.0}, {"resumed": 1.0}, {"noop": 1.0}]:
        raise RuntimeError(f"runner_resumes_total over the killed, restarted and no-op "
                           f"days is not fresh, resumed, noop: {counted}")
    if out["killed"]["journal_train_state"] != "complete" or not out["resumed"]["skipped_train"]:
        raise RuntimeError(f"the restart did not skip the journalled train stage: {out}")
    if (served is None or served["engine"] != "kernel" or served["launches"] < 1
            or served["model_source"] != "production" or served["model_key"] != ckpt):
        raise RuntimeError(f"the resumed day did not serve production through kernel: {out}")
    if out["checkpoint"]["after_resume_digest"] != killed_digest:
        raise RuntimeError(f"the resume rewrote the killed run's checkpoint: {out}")
    differ = [k for k in gap["differ"] if k != ckpt]
    if differ or gap["only_in_first"] or gap["only_in_second"]:
        raise RuntimeError(f"the resumed day's artefacts differ from the twin's: {gap}")
    return {"launches": served["launches_by_kernel"], "twin_launches": twin_launches}


def phase_sigterm(torch, dev, workdir: str) -> dict:
    """SIGTERM to a 1024-wide MLP ``run-day`` while it trains: it exits
    143 with the journal ``interrupted`` and the lease released, and the
    next ``run-day`` resumes the day (exit 0)."""
    import signal

    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import run_journal_key
    from bodywork_tpu_torch.utils.shutdown import SIGTERM_EXIT

    spec = default_pipeline("mlp", "batch")
    day = LOOP_START
    root = os.path.join(workdir, "sigterm")
    store = FilesystemStore(root)
    LocalRunner(spec, store, device=dev).bootstrap(day)
    key = run_journal_key(day)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "bodywork_tpu_torch.cli",
                             *_mlp_day_args(root, day)], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": ROOT},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while time.perf_counter() - t0 < 240 and proc.poll() is None:
            if store.exists(key) and json.loads(store.get_bytes(key))["stages"].get(
                    TRAIN_STAGE, {}).get("state") == "intent":
                break
            time.sleep(0.05)
        time.sleep(1.0)  # into the Adam loop
        signalled_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    doc = json.loads(store.get_bytes(key))
    restart = _cli(_mlp_day_args(root, day))
    after = json.loads(store.get_bytes(key))
    line = {"rc": proc.returncode, "want": SIGTERM_EXIT, "signalled_after_s": signalled_s,
            "process_s": time.perf_counter() - t0 - restart["seconds"],
            "journal_status": doc["status"], "lease_owner": doc["lease"]["owner"],
            "train_state": doc["stages"].get(TRAIN_STAGE, {}).get("state"),
            "restart_rc": restart["rc"], "restart_process_s": restart["seconds"],
            "restart_day_s": _day_seconds(restart["out"], day),
            "restart_served": _served(restart["out"]), "final_status": after["status"]}
    emit("sigterm", **line)
    if (proc.returncode, doc["status"], doc["lease"]["owner"], line["train_state"]) != (
            SIGTERM_EXIT, "interrupted", None, "intent"):
        raise RuntimeError(f"SIGTERM mid-train was not a clean interruption: {line}\n"
                           f"{err[-3000:]}")
    served = line["restart_served"]
    if restart["rc"] != 0 or after["status"] != "complete" or served is None \
            or served["engine"] != "kernel" or served["launches"] < 1:
        raise RuntimeError(f"the day did not resume after SIGTERM and serve through "
                           f"kernel: {line}\n{restart['err'][-3000:]}")
    return {"launches": served["launches_by_kernel"]}


def phase_day_report(torch, dev, workdir: str) -> dict:
    """``day-report``: one ``cli run-day`` of the 1024-wide MLP on a fresh
    store with ``--trace-out`` and ``--report-out`` (``{date}`` in both),
    served by ``kernel``: the report's schema, every stage span's Chrome
    trace duration equal to the report's ``stage_seconds`` (to the
    report's 1e-6 s rounding), the ``registry-gate`` and ``run-day-<date>``
    spans present; the gate's seconds and the day's seconds outside every
    stage and gate span (the journal's writes and the artefact digests
    recorded for them, the kill points, the services' stop) printed."""
    day = LOOP_START
    root = os.path.join(workdir, "day-report")
    out_dir = os.path.join(workdir, "day-report-out")
    res = _cli(_mlp_day_args(root, day) + [
        "--trace-out", os.path.join(out_dir, "{date}.trace.json"),
        "--report-out", os.path.join(out_dir, "{date}.report.json")])
    if res["rc"] != 0:
        raise RuntimeError(f"run-day with --trace-out failed: {res['err'][-3000:]}")
    with open(os.path.join(out_dir, f"{day}.report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, f"{day}.trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    dur = {e["name"]: e["dur"] for e in events}
    day_span = f"run-day-{day}"
    stage_us = {name: dur.get(name) for name in report["stage_seconds"]}
    gap_us = {name: None if us is None else abs(us - 1e6 * report["stage_seconds"][name])
              for name, us in stage_us.items()}
    served = _served(res["out"])
    outside_s = (dur.get(day_span, 0.0) - sum(v or 0.0 for v in stage_us.values())
                 - dur.get("registry-gate", 0.0)) / 1e6
    out = {"day": str(day), "rc": res["rc"], "process_s": res["seconds"],
           "schema": report["schema"], "stage_seconds": report["stage_seconds"],
           "trace_stage_us": stage_us, "max_gap_us": max(
               (g for g in gap_us.values() if g is not None), default=None),
           "spans": [(e["name"], e["cat"]) for e in events],
           "gate_s": dur.get("registry-gate", 0.0) / 1e6,
           "day_s": dur.get(day_span, 0.0) / 1e6,
           "bootstrap_s": dur.get(f"bootstrap-{day}", 0.0) / 1e6,
           "outside_stage_and_gate_spans_s": outside_s,
           "served": served}
    emit("day-report", **out)
    if report["schema"] != "bodywork_tpu.day_report/1" or None in gap_us.values() \
            or max(gap_us.values()) > 0.5 + 1e-3:
        raise RuntimeError(f"the day report and its trace disagree: {out}")
    if "registry-gate" not in dur or day_span not in dur:
        raise RuntimeError(f"the gate or the day span is missing: {out}")
    if served is None or served["engine"] != "kernel" or served["launches"] < 1:
        raise RuntimeError(f"the reported day did not serve through kernel: {out}")
    return {"launches": served["launches_by_kernel"]}


def _kernel_events(path: str) -> dict:
    """What a torch.profiler Chrome trace holds: device events by
    category, the f32 kernel's events by name, and the graph launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    device = [e for e in events if e.get("cat") in device_cats]
    return {
        "events": len(events),
        "device_events": {c: sum(e.get("cat") == c for e in device) for c in device_cats},
        "f32_kernel_named": sum("mlp_f32_kernel" in e.get("name", "") for e in device),
        "graph_launches": sum(e.get("name") == "cudaGraphLaunch" for e in events),
    }


def phase_profile(torch, dev, workdir: str) -> dict:
    """``profile``: ``cli run-sim --profile-dir`` of the 1024-wide MLP for
    2 days, its fits cut to PROFILE_SIM's steps, between two unprofiled
    runs of the same command (the first captures the serving graphs, so
    the three serve alike): the trace holds CUDA device events, and the
    f32 kernel appears either by its symbol (then one event per launch
    the wrapper counted over the same window) or only inside graph
    launches (then at least one graph launch per counted launch); the
    trace's bytes and the run's seconds with the profiler on and off."""
    import contextlib
    import io
    import re

    from bodywork_tpu_torch import cli
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.utils.profiling import trace_path

    prof_dir = os.path.join(workdir, "profile")
    runs = {}
    for name, extra in (("off-first", []), ("on", ["--profile-dir", prof_dir]), ("off", [])):
        argv = ["--log-level", "WARNING", "run-sim", "--store", os.path.join(workdir, name),
                "--days", str(PROFILE_SIM["days"]), "--date", str(LOOP_START),
                "--model", "mlp", "--mlp-hidden", ",".join(map(str, HIDDEN)),
                "--mlp-steps", str(PROFILE_SIM["n_steps"]),
                "--mlp-lr", str(LOOP_MLP["learning_rate"]), "--device", "cuda", *extra]
        reset_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        runs[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                      "day_s": [float(m) for m in re.findall(r"^day \S+: ([0-9.]+)s$",
                                                             printed.getvalue(), re.M)],
                      "launches": dict(LAUNCHES)}
        if rc != 0:
            raise RuntimeError(f"run-sim {name} exited {rc}: {printed.getvalue()[-2000:]}")
    path = str(trace_path(prof_dir, f"{PROFILE_SIM['days']}-day simulation"))
    seen = _kernel_events(path)
    launched = runs["on"]["launches"]["kernel"]
    mode = "named kernel" if seen["f32_kernel_named"] else "graph launch only"
    out = {"days": PROFILE_SIM["days"], "n_steps": PROFILE_SIM["n_steps"],
           "n_steps_cut_from": LOOP_MLP["n_steps"], "trace_bytes": os.path.getsize(path),
           "f32_kernel_appears_as": mode, "launch_counter_kernel": launched, **seen,
           "seconds_profiled": runs["on"]["seconds"], "seconds_unprofiled": runs["off"]["seconds"],
           "runs": runs}
    emit("profile", **out)
    if not sum(seen["device_events"].values()) or launched < 1:
        raise RuntimeError(f"the profile holds no device events or no f32 launch: {out}")
    if seen["f32_kernel_named"] and seen["f32_kernel_named"] != launched:
        raise RuntimeError(f"the profile's f32 kernels differ from the launch counter: {out}")
    if not seen["f32_kernel_named"] and seen["graph_launches"] < launched:
        raise RuntimeError(f"the f32 kernel shows neither by name nor in graph launches: {out}")
    return {"launches": {e: sum(r["launches"][e] for r in runs.values()) for e in VARIANTS}}


def _cold_snapshot_train(torch, dev, store, workdir: str) -> dict:
    """After the 30-day incremental linear loop: a fresh ``cli train``
    process must read the history from the snapshot (every covered day
    "from snapshot", at most the tail fetched and parsed); the snapshot
    load is byte-identical to a plain load with ``snapshots/`` deleted;
    both cold loads timed in this process."""
    import hashlib
    import re

    from bodywork_tpu_torch.data.io import load_all_datasets
    from bodywork_tpu_torch.data.snapshot import load_latest_snapshot
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, SNAPSHOTS_PREFIX

    snap = load_latest_snapshot(FilesystemStore(store.root))
    covered = len(snap.entries)
    days = len(store.history(DATASETS_PREFIX))
    train = _cli(["train", "--store", str(store.root), "--model", "linear"])
    m = re.search(r"history parts: (\d+) day\(s\) — (\d+) cached, (\d+) from snapshot, "
                  r"(\d+) fetched\+parsed", train["err"])
    parts = None if m is None else dict(zip(("days", "cached", "from_snapshot", "fetched"),
                                            map(int, m.groups())))
    plain_root = shutil.copytree(store.root, os.path.join(workdir, "no-snapshot"),
                                 ignore=shutil.ignore_patterns("snapshots"))
    t0 = time.perf_counter()
    via_snapshot = load_all_datasets(FilesystemStore(store.root))
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = load_all_datasets(FilesystemStore(plain_root))
    plain_s = time.perf_counter() - t0

    def digest(ds):
        return hashlib.sha256(ds.X.tobytes() + ds.y.tobytes()).hexdigest()[:16]

    out = {"days": days, "covered_by_snapshot": covered, "train_rc": train["rc"],
           "train_process_s": train["seconds"], "train_history_parts": parts,
           "rows": len(plain), "cold_load_snapshot_s": snapshot_s, "cold_load_plain_s": plain_s,
           "snapshot_bytes": len(store.get_bytes(snap.key)), "snapshot_key": snap.key,
           "snapshots_kept": len(store.list_keys(SNAPSHOTS_PREFIX)),
           "history_sha256": digest(via_snapshot), "plain_sha256": digest(plain),
           "identical": (via_snapshot.X.tobytes() == plain.X.tobytes()
                         and via_snapshot.y.tobytes() == plain.y.tobytes()
                         and via_snapshot.date == plain.date)}
    emit("snapshot", **out)
    if train["rc"] != 0 or parts is None or parts["from_snapshot"] != covered \
            or parts["fetched"] > days - covered or not out["identical"]:
        raise RuntimeError(f"the cold train did not read the history from the snapshot: "
                           f"{out}\n{train['err'][-3000:]}")
    return out


def _gate_spy():
    """Record what the shadow quantization gate saw and decided (its
    report, verdict and detail) while leaving its decision untouched."""
    from bodywork_tpu_torch.registry import gates

    seen, real = [], gates.evaluate_quantization

    def spy(report, policy=None):
        ok, detail = real(report, policy)
        seen.append({"report": report, "admitted": ok, "detail": detail})
        return ok, detail

    gates.evaluate_quantization = spy
    return seen, lambda: setattr(gates, "evaluate_quantization", real)


def _serve_at_dtype(torch, dev, store, dtype: str, engine: str):
    """The serve stage with ``BODYWORK_TPU_SERVE_DTYPE=dtype`` on the
    store's production: a started handle and the gate's record."""
    from bodywork_tpu_torch.pipeline.stages import StageContext, serve_stage

    seen, restore = _gate_spy()
    before = os.environ.get("BODYWORK_TPU_SERVE_DTYPE")
    os.environ["BODYWORK_TPU_SERVE_DTYPE"] = dtype
    try:
        handle = serve_stage(StageContext(store=store, today=LOOP_START, device=dev),
                             engine=engine)
    finally:
        restore()
        if before is None:
            os.environ.pop("BODYWORK_TPU_SERVE_DTYPE")
        else:
            os.environ["BODYWORK_TPU_SERVE_DTYPE"] = before
    return handle, seen


def phase_quantized(torch, dev, store) -> dict:
    """The serve stage at each quantized dtype on (b)'s production: on
    ``auto`` (the 1024-wide MLP resolves to ``kernel``) the gate must
    admit ``kernel-bf16`` / ``kernel-int8``, whose answers over HTTP are
    held against their plain versions (launches counted from 0 before the
    stage to after its requests); then ``--engine torch`` at each dtype
    (``torch-bf16`` / ``torch-int8``) on the card, held against the same
    predictor on the CPU."""
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES, reset_launches
    from bodywork_tpu_torch.serve import build_predictor

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    batches = [torch.rand(n, generator=gen, device=dev) * 100.0 for n in (300, 4096)]
    singles = [50.0, 10.0, 90.0]
    launches, out = {}, {}
    for dtype, engine in (("bfloat16", "kernel-bf16"), ("int8", "kernel-int8")):
        reset_launches()
        handle, gate = _serve_at_dtype(torch, dev, store, dtype, "auto")
        try:
            health, checks = _check_served(torch, dev, handle, singles, batches)
        finally:
            handle.stop()
        launches[engine] = LAUNCHES[engine]
        out[engine] = {"dtype": dtype, "engine": health["engine"],
                       "served_dtype": health["serving_dtype"],
                       "model_key": health["model_key"], "gate": gate,
                       "launches": dict(LAUNCHES), "bar": BARS[engine], **checks}
        emit("quantized", **out[engine])
        if health["engine"] != engine or health["serving_dtype"] != dtype:
            raise RuntimeError(f"dtype={dtype} did not serve through {engine}: {out[engine]}")
        if checks["worst_err_over_scale"] >= BARS[engine] or launches[engine] < 3:
            raise RuntimeError(f"{engine} path failed: {out[engine]}")
    cpu_model, _ = load_model(store, device="cpu")
    X = batches[1]
    for dtype, engine in (("bfloat16", "torch-bf16"), ("int8", "torch-int8")):
        reset_launches()
        handle, gate = _serve_at_dtype(torch, dev, store, dtype, "torch")
        try:
            health = get(handle.base_url + "/healthz")
            got = torch.tensor(post(handle.url + "/batch", {"X": X.tolist()})["predictions"])
        finally:
            handle.stop()
        want = torch.from_numpy(build_predictor(cpu_model, engine).predict(X.cpu().numpy()))
        err, rel = rel_err(got, want)
        out[engine] = {"dtype": dtype, "engine": health["engine"],
                       "served_dtype": health["serving_dtype"], "device": health["device"],
                       "gate": gate, "launches": dict(LAUNCHES), "rows": int(X.shape[0]),
                       "max_abs_err_vs_cpu": err, "err_over_scale_vs_cpu": rel,
                       "bar": CARD_CPU_BARS[engine]}
        emit("quantized-torch", **out[engine])
        if (health["engine"], health["serving_dtype"], health["device"]) != (engine, dtype, "cuda"):
            raise RuntimeError(f"--engine torch at {dtype} did not serve {engine}: {out[engine]}")
        if rel >= CARD_CPU_BARS[engine] or any(LAUNCHES.values()):
            raise RuntimeError(f"{engine} on the card disagrees with the CPU: {out[engine]}")
    torch.cuda.synchronize()
    return {"launches": launches, "paths": out}


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
        "--phases",
        default="device,generator,mlp-draws,build,kernels,slice,serving,trace,day-loop,"
                "incremental,quantized,resume,sigterm,day-report,profile,timing",
        help="comma-separated subset of the phases to run (default: all; quantized "
             "serves incremental's production, so it runs incremental too)",
    )
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))
    t_start = time.perf_counter()

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
    if "mlp-draws" in phases:
        phase_mlp_draws(torch, dev)
    if "build" in phases:
        phase_build()
    errors = phase_kernels(torch, dev) if "kernels" in phases else {}
    launches, loop, incremental, quantized, timing, resume, sigterm = {}, {}, {}, {}, {}, {}, {}
    serving, traced, reported, profiled = {}, {}, {}, {}
    for phase in ("slice", "serving", "trace", "day-loop", "incremental", "resume", "sigterm",
                  "day-report", "profile"):
        if phase not in phases and not (phase == "incremental" and "quantized" in phases):
            continue
        workdir = tempfile.mkdtemp(prefix="chip-smoke-", dir=_scratch_dir())
        try:
            if phase == "slice":
                launches = phase_slice(torch, dev, workdir)
            elif phase == "serving":
                serving = phase_serving(torch, dev, workdir)
            elif phase == "trace":
                traced = phase_trace(torch, dev, workdir)
            elif phase == "day-report":
                reported = phase_day_report(torch, dev, workdir)
            elif phase == "profile":
                profiled = phase_profile(torch, dev, workdir)
            elif phase == "day-loop":
                loop = phase_day_loop(torch, dev, workdir)
            elif phase == "resume":
                resume = phase_resume(torch, dev, workdir)
            elif phase == "sigterm":
                sigterm = phase_sigterm(torch, dev, workdir)
            else:
                incremental = phase_incremental(torch, dev, workdir)
                if "quantized" in phases:
                    quantized = phase_quantized(torch, dev, incremental["store"])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    if "timing" in phases:
        timing = phase_timing(torch, dev, card)
    emit("total", seconds=time.perf_counter() - t_start, phases=sorted(phases))
    if phases >= {"kernels", "slice", "day-loop", "incremental", "quantized", "timing"}:
        kernels = []
        for engine in VARIANTS:
            t = timing[engine][4096]
            by_path = {"slice": launches[engine], "day-loop": loop["mlp"]["launches"][engine],
                       "gate-rejection": loop["rejection"]["launches"][engine],
                       "incremental": incremental["mlp"]["launches"][engine],
                       "incremental-gate-rejection":
                           incremental["rejection"]["launches_all"][engine],
                       "quantized": sum(p["launches"][engine]
                                        for p in quantized["paths"].values()),
                       # the serial loop the pipelined one is held to
                       "pipelined-serial": loop["pipelined"]["serial_launches"][engine],
                       "pipelined-overlap": loop["pipelined"]["overlap_launches"][engine]}
            # the uncrashed twin day, and the restarted days' own processes
            # (each counted from its start, read from its output)
            if resume:
                by_path["resume"] = resume["twin_launches"][engine] + resume["launches"][engine]
            if sigterm:
                by_path["sigterm-restart"] = sigterm["launches"][engine]
            # the serving machinery's paths: every launch a graph replay or
            # a bucket's capture warm-up, read per path in this run
            for path, counts in serving.get("launches_by_path", {}).items():
                by_path[path] = counts.get(engine, 0)
            # the traced services and their overhead runs; the reported
            # day's own process; the profiled simulation and its two twins
            for path, result, key in (("trace", traced, "launches_all"),
                                      ("day-report", reported, "launches"),
                                      ("profile", profiled, "launches")):
                if result:
                    by_path[path] = result[key][engine]
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
