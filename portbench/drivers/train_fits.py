"""Training fits back to back through ``MLPRegressor.fit``, the train
stage's fit, in this process on the card.

The traffic mix gives the rows of each fit's data set and how many data
sets set-up draws. Data set ``k`` holds ``rows`` rows of ``features``
uniform features on ``x_range`` and the target ``X @ w + noise *
N(0, 1)`` (``bench.py``'s ``_wide_data``), all drawn from the run's
seed; fit ``k`` runs on data set ``k mod datasets`` with the ``k``-th
fit seed drawn from the run's seed.

Set-up: the data sets; the fit of data set 0 under fit seed 0 run for 1,
2 and 3 steps through the window's own call (each step's loss and the
weights after it, which ``correct`` compares, and the warm-up of every
kernel the window runs); one whole fit more. The window then starts fits
until ``seconds`` have passed and waits for the last;
``train_rows_per_s`` is the rows of the fits' steps (steps x batch) over
the time from the window's start to the last completion. The window's
first fit is data set 0 under fit seed 0 again, and the object it
returns is kept. With ``--trace 1`` one fit more runs under a device
trace once the window has closed.

After the window, with the other fits freed: the plain reference runs
the same fit for all its steps, and ``judge`` compares the first three
steps' losses and the weights' change after step 3 with the set-up's
fits, and the last step's loss and the weights' change over the whole
fit with the window's first fit (``reference.compare``).
"""
from __future__ import annotations

import dataclasses
import os
import resource
import time

import numpy as np

from portbench.harness import Outcome, card_power_limit
from portbench.harness import tracesum
from portbench.harness.yardstick import (
    f32_accurate_peak,
    peaks,
    train_gemm_bound_s,
    wide_train_flops_per_step,
)
from portbench.reference import compare
from portbench.reference import mlp as reference

#: the steps the reference follows
CHECK_STEPS = 3


def datasets(rng: np.random.Generator, traffic: dict, features: int) -> list:
    lo, hi = traffic["x_range"]
    out = []
    for _ in range(traffic["datasets"]):
        X = rng.uniform(lo, hi, (traffic["rows"], features)).astype(np.float32)
        w = rng.normal(size=features).astype(np.float32)
        noise = rng.normal(size=traffic["rows"]).astype(np.float32)
        out.append((X, (X @ w + np.float32(traffic["noise"]) * noise).astype(np.float32)))
    return out


def fit_leaves(model) -> list:
    """A fitted model's leaves on the host, ordered ``w0, b0, w1, b1, ...``."""
    return [t.detach().cpu().clone() for layer in model.params["net"]["layers"]
            for t in (layer["w"], layer["b"])]


def checked_steps(mlp_cfg, X, y, seed: int, device) -> list:
    """``(final loss, leaves)`` of the fit run for 1, 2 and 3 steps."""
    from bodywork_tpu_torch.models.mlp import MLPRegressor

    out = []
    for n in range(1, CHECK_STEPS + 1):
        fitted = MLPRegressor(dataclasses.replace(mlp_cfg, n_steps=n)).fit(
            X, y, seed=seed, device=device)
        out.append((fitted.final_loss, fit_leaves(fitted)))
    return out


def reference_fit(cfg: dict, X, y, seed: int, device, tf32: bool = False,
                  keep: int | None = None) -> dict:
    """The plain reference's run of the checked fit, all its steps, the
    weights kept after step 3 and the last."""
    with reference.precision(tf32=tf32):
        return reference.fit_steps(X, y, seed, tuple(cfg["hidden"]), cfg["learning_rate"],
                                   cfg["batch_size"], cfg["n_steps"], device, keep=keep,
                                   record=(CHECK_STEPS,))


def judge(checked: list, fit: tuple, ref: dict) -> tuple[dict, list]:
    """The gaps from the reference, and the leaves compared: ``loss_gap``
    (steps 1-3), ``change_gap`` (after step 3), ``final_loss_gap`` (the
    last step's loss) and ``final_change_gap`` (over the whole fit).
    ``correct`` holds those the configuration gives a limit; the last
    step's loss is printed alone, since over a whole fit the rounding of
    sound runs moves one minibatch's loss as far as the control does.
    ``checked`` is :func:`checked_steps`'s, ``fit`` the ``(final loss,
    leaves)`` of the whole fit."""
    leaves = compare.counted_leaves(ref["grad_norms"])
    last = max(ref["params"])
    return {
        "loss_gap": compare.loss_gap([c[0] for c in checked], ref["losses"][:CHECK_STEPS]),
        "change_gap": compare.change_gap(checked[-1][1], ref["params"][CHECK_STEPS],
                                         ref["init"], leaves),
        "final_loss_gap": compare.loss_gap([fit[0]], [ref["losses"][last - 1]]),
        "final_change_gap": compare.change_gap(fit[1], ref["params"][last], ref["init"],
                                               leaves),
    }, leaves


def run(ctx) -> Outcome:
    import torch

    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor

    cfg, trf, dev = ctx.config, ctx.traffic, ctx.device
    mlp_cfg = MLPConfig(hidden=tuple(cfg["hidden"]), learning_rate=cfg["learning_rate"],
                        batch_size=cfg["batch_size"], n_steps=cfg["n_steps"])
    rng = np.random.default_rng(ctx.seed)
    data = datasets(rng, trf, cfg["features"])
    fit_seeds = [int(s) for s in rng.integers(0, 2**31, size=4096)]

    # the checked fit's first steps, through the window's own call
    checked = checked_steps(mlp_cfg, *data[0], fit_seeds[0], dev)
    MLPRegressor(mlp_cfg).fit(*data[1 % len(data)], seed=fit_seeds[-1], device=dev)
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - ctx.start

    finals, ends = [], []
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    while time.monotonic() < t0 + ctx.seconds:
        k = len(finals)
        fitted = MLPRegressor(mlp_cfg).fit(*data[k % len(data)], seed=fit_seeds[k], device=dev)
        finals.append(fitted.final_loss)  # a host number: the fit has ended
        ends.append(time.monotonic())
        if k == 0:
            first = fitted  # the checked fit, compared whole after the window
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    trace = None
    if ctx.trace:
        # one fit more, after the window, under the device trace
        from portbench.harness.devtrace import DeviceTrace

        k = len(finals)
        trace = DeviceTrace().start()
        MLPRegressor(mlp_cfg).fit(*data[k % len(data)], seed=fit_seeds[k], device=dev)
        trace.stop()
    window_s = ends[-1] - t0
    memory_peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    fit = (first.final_loss, fit_leaves(first))
    del fitted, first

    # the reference, once the window has closed and its fits are freed
    if dev != "cpu":
        torch.cuda.empty_cache()
    ref = reference_fit(cfg, *data[0], fit_seeds[0], dev)
    gaps, leaves = judge(checked, fit, ref)
    limits = cfg["limits"]["train_fits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items() if k in limits}
    checks["nonfinite_fits"] = {"value": sum(not np.isfinite(f) for f in finals), "limit": 0}

    name = torch.cuda.get_device_name(0) if dev != "cpu" else "cpu"
    card = peaks(name)
    steps = len(finals) * mlp_cfg.n_steps
    layer = {
        "kind": "train",
        "window_s": window_s,
        "steps": steps,
        "flops_per_step": wide_train_flops_per_step(
            mlp_cfg.batch_size, cfg["features"], mlp_cfg.hidden),
        "peak_flops": f32_accurate_peak(card),
        "gemm_bound_s_per_step": train_gemm_bound_s(
            mlp_cfg.batch_size, cfg["features"], mlp_cfg.hidden, card),
    }
    device = {"platform": "gpu" if dev != "cpu" else "cpu", "kind": name, "count": 1,
              "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace is not None:
        layer["trace"] = {**trace.dump(), "steps": mlp_cfg.n_steps}
        device["busy_s"], device["window_s"] = tracesum.busy_window(layer["trace"])
        breakdown = tracesum.breakdown(layer["trace"])
    cpu_s = (cpu1.ru_utime + cpu1.ru_stime) - (cpu0.ru_utime + cpu0.ru_stime)
    notes = [
        f"machine: cpu_count {os.cpu_count()}; card {name}; power limit "
        f"{card_power_limit() if dev != 'cpu' else 'n/a'}",
        f"window: {len(finals)} fits of {mlp_cfg.n_steps} steps in {window_s:.3f} s; "
        f"setup {setup_s:.3f} s; leaves compared {len(leaves)} of {len(ref['grad_norms'])}",
        f"cpu seconds over the window: run {cpu_s:.3f} ({cpu_s / window_s:.3f} of a core)",
        "not compared: " + ", ".join(f"{k} {v!r}" for k, v in gaps.items() if k not in limits),
        "seconds of each fit: " + " ".join(
            f"{b - a:.4f}" for a, b in zip([t0] + ends[:-1], ends)),
    ]
    return Outcome(
        e2e={"train_rows_per_s": steps * mlp_cfg.batch_size / window_s, "setup_s": setup_s},
        layer=layer, attempted=len(finals),
        failed=sum(not np.isfinite(f) for f in finals), checks=checks, device=device,
        breakdown=breakdown, notes=notes)
