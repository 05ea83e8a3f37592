#!/usr/bin/env python3
"""How often the canary acceptance's ``healthy`` scenario aborts on the card.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/canary_repeat.py [--reps 10] [--requests 240] [--after-trace]
                                   [--pin-alternate]

Repeats ``run_canary_chaos(scenario="healthy")`` on two 1024-wide MLP
checkpoints (``chip_smoke.py``'s ``canary`` phase, its training settings)
in one process and prints one JSON line per repetition: the verdict, the
request it landed at, the verdict's window (its ``p99_ratio`` is the
canary's windowed p99 over production's, read from the latency
histogram's buckets), each checkpoint's median request time in ms, its
six slowest requests as ``[ms, index]``, and the watcher's poll times in
ms. The request times are the canary'd app's ``handle`` calls.

``--after-trace`` runs ``chip_smoke.py``'s ``trace`` phase first, so the
process holds what the whole script's process holds at its ``canary``
phase; ``--pin-alternate`` pins every other repetition to one CPU core.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--requests", type=int, default=240)
    parser.add_argument("--after-trace", action="store_true")
    parser.add_argument("--pin-alternate", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("canary_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bodywork_tpu_torch.chaos import canary as canary_module
    from bodywork_tpu_torch.chaos import run_canary_chaos
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.utils.logging import configure_logger

    configure_logger("WARNING", stream=sys.stderr)
    dev = torch.device("cuda")
    cs.phase_device(torch)
    cs.phase_build()
    work = tempfile.mkdtemp(dir=cs._scratch_dir())
    if args.after_trace:
        cs.phase_trace(torch, dev, work)
    drive = canary_module._drive
    drives = []

    def recorded(app, twin_app, watcher, xs, *rest):
        seconds, polls = [], []
        handle, check = app.handle, watcher.check_once

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return handle(*a, **k)
            finally:
                seconds.append(time.perf_counter() - t0)

        def timed_check():
            t0 = time.perf_counter()
            try:
                return check()
            finally:
                polls.append(1e3 * (time.perf_counter() - t0))

        app.handle, watcher.check_once = timed, timed_check
        trace = drive(app, twin_app, watcher, xs, *rest)
        drives.append((trace, seconds, polls))
        return trace

    canary_module._drive = recorded
    cores = sorted(os.sched_getaffinity(0))
    for rep in range(args.reps):
        pinned = args.pin_alternate and rep % 2 == 1
        os.sched_setaffinity(0, {cores[-1]} if pinned else set(cores))
        root = os.path.join(work, f"healthy-{rep}")
        summary = run_canary_chaos(
            FilesystemStore(root), scenario="healthy", seed=0, n_requests=args.requests,
            fraction=0.35, model_type="mlp", model_kwargs=cs.LOOP_MLP, device=dev)
        trace, seconds, polls = drives[-1]
        by_checkpoint = {}
        for i, (key, s) in enumerate(zip(trace["keys"], seconds)):
            name = "production" if key == summary["production_key"] else "candidate"
            by_checkpoint.setdefault(name, []).append((round(1e3 * s, 3), i))
        dumps = summary["flight_record_keys"]
        window = (json.loads(FilesystemStore(root).get_bytes(dumps[-1]))["window"]
                  if dumps else None)
        print(json.dumps({
            "rep": rep, "pinned": pinned, "ok": summary["ok"],
            "abort_at_request": summary["abort_at_request"],
            "promote_at_request": summary["promote_at_request"], "window": window,
            "median_ms": {k: statistics.median(ms for ms, _i in v)
                          for k, v in by_checkpoint.items()},
            "slowest": {k: sorted(v, reverse=True)[:6] for k, v in by_checkpoint.items()},
            "polls_ms": [round(p, 2) for p in polls]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
