#!/usr/bin/env python3
"""Whether a fit at a row bucket new to the process costs the port anything.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/bucket_crossing.py

The JAX package prewarms tomorrow's row bucket because XLA compiles one
program per bucket. The port compiles nothing per bucket; what a new
bucket can cost is the caching allocator's new blocks and cuBLAS's first
product at a shape. Each model's fit and held-out evaluation
(``fit_and_evaluate``, as the train stage calls it) runs on seeded rows
at history sizes whose fit buckets (16384, 32768, 65536) ``chip_smoke.py``'s
day loops never reach, each bucket met first by one size and then by a
second, after one warm-up fit at a bucket the day loop meets; the MLP at
the day loop's widths with 500 Adam steps. Each fit is timed to a device
fence. Prints the card's ``nvidia-smi`` name and power limit, then one
JSON line per model: every fit (rows, fit and eval bucket, whether the
bucket was new to the process, seconds, MAPE) and, per bucket, the first
fit's seconds minus the second's.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

#: history rows: a warm-up at the day loop's 2048-row fit bucket, then
#: each new bucket met twice
WARM_UP_ROWS = 1500
CROSSING_ROWS = (15000, 15500, 30000, 30500, 60000, 60500)
CROSSING_MLP_STEPS = 500


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bucket_crossing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bodywork_tpu_torch.device import fence
    from bodywork_tpu_torch.models.base import train_test_split
    from bodywork_tpu_torch.train.trainer import make_model

    dev = torch.device("cuda")
    cs.phase_device(torch)
    rng = np.random.default_rng(20)
    for model_type, kwargs in (("mlp", {**cs.LOOP_MLP, "n_steps": CROSSING_MLP_STEPS}),
                               ("linear", {})):
        fits = []
        for n in (WARM_UP_ROWS, *CROSSING_ROWS):
            X = rng.uniform(0, 100, (n, 1)).astype(np.float32)
            y = (0.5 * X[:, 0] + 3.0 + rng.normal(0, 5, n)).astype(np.float32)
            split = train_test_split(X, y)
            buckets = cs._row_buckets(f"{model_type}-crossing", n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitted, metrics = make_model(model_type, **kwargs).fit_and_evaluate(
                split.X_train, split.y_train, split.X_test, split.y_test, seed=0, device=dev)
            fence(fitted.params)
            fits.append({"rows": n, **buckets, "seconds": time.perf_counter() - t0,
                         "MAPE": metrics["MAPE"]})
        crossing = fits[1:]
        pairs = [{"fit": a["fit"], "new_s": a["seconds"], "seen_s": b["seconds"],
                  "new_minus_seen_s": a["seconds"] - b["seconds"]}
                 for a, b in zip(crossing[::2], crossing[1::2])]
        print(json.dumps({"model": model_type, "fits": fits, "pairs": pairs}), flush=True)
        if not all(math.isfinite(f["MAPE"]) for f in fits) or not all(
                a["new_to_process"] and not b["new_to_process"]
                for a, b in zip(crossing[::2], crossing[1::2])):
            print(f"bucket_crossing: unexpected fits for {model_type}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
