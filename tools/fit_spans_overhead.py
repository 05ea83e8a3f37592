#!/usr/bin/env python3
"""What a fit's spans cost when a recorder is installed.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/fit_spans_overhead.py [--pairs 10] [--batches 32768,64] [--small --device cpu]

For each batch size, runs the benchmark cell ``train-mlp32x1024-b32768``'s
fit (``portbench/configs/mlp32x1024x3-f32-b32768.json``, its batch size
replaced) on one data set of traffic ``fits-r16384`` under one fit seed:
one warm-up fit each way, then ``--pairs`` pairs of fits in alternating
order, one of each pair inside ``obs.spans.recording`` and one with no
recorder. A fit is timed on the host from the call to its return, which
waits for the loss. At batch 32768 the card paces the fit; at batch 64
the host does, so there the fit's time is all host cost.

Prints one JSON line per batch size: the fit seconds of each kind in run
order, their medians and ``ratio`` (recorded over plain). Where the
fits' own spread hides the spans' cost, the last line gives it directly:
the microseconds of one empty ``FitPhases.span`` block with a recorder
and with none (``--span-reps`` blocks each), and what the spans of one
fit cost at the first (``fit_ms``: ``spans_per_fit`` blocks).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

CONFIG = "portbench/configs/mlp32x1024x3-f32-b32768.json"
TRAFFIC = "fits-r16384"
#: the CPU rehearsal's shapes (``portbench/tests/dryrun.py``'s)
SMALL = ({"hidden": [32, 32, 32], "n_steps": 40}, {"rows": 2048})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--batches", default="32768,64")
    p.add_argument("--span-reps", type=int, default=20000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="the CPU rehearsal's shapes")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from bodywork_tpu_torch.models.mlp import HEAD_STEPS, FitPhases, MLPConfig, MLPRegressor
    from bodywork_tpu_torch.obs.spans import SpanRecorder, recording
    from portbench.drivers.train_fits import datasets
    from portbench.harness import card_power_limit, spec

    with open(os.path.join(ROOT, CONFIG)) as f:
        cfg = json.load(f)
    trf = spec.traffic(TRAFFIC)
    if args.small:
        cfg, trf = {**cfg, **SMALL[0]}, {**trf, **SMALL[1]}
    rng = np.random.default_rng(args.seed)
    X, y = datasets(rng, {**trf, "datasets": 1}, cfg["features"])[0]
    seed = int(rng.integers(0, 2**31))
    on_card = args.device != "cpu"
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    limit = card_power_limit() if on_card else "n/a"

    for batch in (int(b) for b in args.batches.split(",")):
        mlp_cfg = MLPConfig(hidden=tuple(cfg["hidden"]), learning_rate=cfg["learning_rate"],
                            batch_size=batch, n_steps=cfg["n_steps"])
        recorder = SpanRecorder(label="overhead")

        def timed(recorded: bool) -> float:
            t0 = time.perf_counter()
            if recorded:
                with recording(recorder):
                    MLPRegressor(mlp_cfg).fit(X, y, seed=seed, device=args.device)
            else:
                MLPRegressor(mlp_cfg).fit(X, y, seed=seed, device=args.device)
            return time.perf_counter() - t0

        timed(False), timed(True)
        seconds = {"plain": [], "recorded": []}
        for i in range(args.pairs):
            for recorded in ((False, True) if i % 2 == 0 else (True, False)):
                seconds["recorded" if recorded else "plain"].append(timed(recorded))
        medians = {k: statistics.median(v) for k, v in seconds.items()}
        print(json.dumps({
            "card": card, "power_limit": limit, "batch": batch, "steps": mlp_cfg.n_steps,
            "pairs": args.pairs, "median_s": medians,
            "ratio": medians["recorded"] / medians["plain"],
            "spans_recorded": len(recorder.spans()), "seconds": seconds,
        }), flush=True)

    def span_us(phases: FitPhases) -> float:
        t0 = time.perf_counter()
        for _ in range(args.span_reps):
            with phases.span("fit.step", "fit.dispatch", step=1):
                pass
        return 1e6 * (time.perf_counter() - t0) / args.span_reps

    recorded, plain = span_us(FitPhases(SpanRecorder())), span_us(FitPhases())
    per_fit = 6 + HEAD_STEPS  # fit, prepare, init, indices, dispatch, drain and the steps
    print(json.dumps({"card": card, "power_limit": limit, "span_us": {
        "recorded": recorded, "plain": plain}, "spans_per_fit": per_fit,
        "fit_ms": 1e-3 * per_fit * recorded}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
