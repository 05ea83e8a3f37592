#!/usr/bin/env python3
"""Config 14's fixed-rate window (250 requests/s for 3 s, seed 23) repeated
through split fleets of 1 and 2 front ends on the card, in turns (1, 2,
2, 1 ...), on the 1024-wide MLP checkpoint ``chip_smoke.py`` serves: the
mean flush occupancy and the multi-source flushes of every window, to
read the spread of ``chip_smoke.py`` ``split``'s occupancy comparison.

Run from the repository root on a machine with a card::

    python3 tools/split_occupancy.py --turns 4 --windows 3

Prints one JSON line per window and a summary line, each with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=4,
                        help="fleets booted, alternating 1 and 2 front ends")
    parser.add_argument("--windows", type=int, default=3,
                        help="fixed-rate windows driven through each fleet")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("split_occupancy: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.utils.logging import configure_logger

    configure_logger("WARNING", stream=sys.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device("cuda")
    workdir = tempfile.mkdtemp(prefix="split-occupancy-", dir=cs._scratch_dir())
    readings: dict = {1: [], 2: []}
    try:
        store, _second, _hist = cs._serving_models(torch, dev, workdir)
        tmp = os.path.join(workdir, "tmp")
        os.makedirs(tmp)
        for turn in range(args.turns):
            n = (1, 2, 2, 1)[turn % 4]
            svc, base, _fes, _ds = cs._split_fleet(str(store.root), ["--frontends", str(n)],
                                                   tmp)
            try:
                for window in range(args.windows):
                    reading = cs._occupancy_window(base)
                    readings[n].append(reading["mean_flush_occupancy"])
                    print(json.dumps({"turn": turn, "frontends": n, "window": window,
                                      "card": smi, **reading}), flush=True)
            finally:
                svc.stop()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    summary = {n: {"windows": len(v), "mean": statistics.mean(v), "min": min(v),
                   "max": max(v)} for n, v in readings.items() if v}
    ratio = (summary[2]["mean"] / summary[1]["mean"]
             if 1 in summary and 2 in summary else None)
    print(json.dumps({"summary": summary, "ratio_2_over_1": ratio, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
