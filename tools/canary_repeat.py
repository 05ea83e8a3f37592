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

Each line also attributes every request over ``--slow-ms`` (default 1.0)
to what it shared its time with: ``rebind`` (its dispatch copied the
other checkpoint's weights into the shared graph slot), ``after_poll``
(the first request after a watcher poll), ``gc`` (a collection ran
inside it), and its time inside the graph replay (``run_ms``, the rebind
included) against the rest of the request. ``causes`` counts the slow
canary requests by those flags; ``threads`` names the live threads.
``--no-twin-between`` skips the canary-free twin's request after each
request the canary answered (an experiment: the twin then no longer
switches the slot back to production before the next canary request).
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
    parser.add_argument("--slow-ms", type=float, default=1.0)
    parser.add_argument("--no-twin-between", action="store_true")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("canary_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bodywork_tpu_torch.chaos import canary as canary_module
    from bodywork_tpu_torch.chaos import run_canary_chaos
    from bodywork_tpu_torch.serve import predictor as predictor_module
    from bodywork_tpu_torch.serve.wire import MODEL_KEY_HEADER
    from bodywork_tpu_torch.store import FilesystemStore
    from bodywork_tpu_torch.utils.logging import configure_logger

    configure_logger("WARNING", stream=sys.stderr)
    dev = torch.device("cuda")
    cs.phase_device(torch)
    cs.phase_build()
    work = tempfile.mkdtemp(dir=cs._scratch_dir())
    if args.after_trace:
        cs.phase_trace(torch, dev, work)
    import gc
    import threading

    drive = canary_module._drive
    drives = []
    # per-request evidence: the graph run's seconds and whether it rebound
    # the slot, collections inside the request
    current = {"run_s": 0.0, "rebind": False, "gc": 0}
    graph_run = predictor_module._BucketGraph.run

    def timed_run(self, Xp, owner, weights, cache):
        rebind = self.slot.owner != owner
        t0 = time.perf_counter()
        try:
            return graph_run(self, Xp, owner, weights, cache)
        finally:
            current["run_s"] += time.perf_counter() - t0
            current["rebind"] |= rebind

    def on_gc(stage, info):
        if stage == "start":
            current["gc"] += 1

    predictor_module._BucketGraph.run = timed_run
    gc.callbacks.append(on_gc)

    def recorded(app, twin_app, watcher, xs, *rest):
        requests, polls = [], []
        handle, check, twin_handle = app.handle, watcher.check_once, twin_app.handle
        after_poll = [False]
        last_key = [None]

        def timed(*a, **k):
            current.update(run_s=0.0, rebind=False, gc=0)
            t0 = time.perf_counter()
            try:
                out = handle(*a, **k)
            finally:
                seconds = time.perf_counter() - t0
                requests.append({"s": seconds, "run_s": current["run_s"],
                                 "rebind": current["rebind"], "gc": current["gc"],
                                 "after_poll": after_poll[0]})
                after_poll[0] = False
            last_key[0] = out[1].get(MODEL_KEY_HEADER)
            return out

        def twin(*a, **k):
            if args.no_twin_between and last_key[0] != production_key[0]:
                return 200, {}, b""
            return twin_handle(*a, **k)

        def timed_check():
            t0 = time.perf_counter()
            try:
                return check()
            finally:
                polls.append(1e3 * (time.perf_counter() - t0))
                after_poll[0] = True

        app.handle, watcher.check_once, twin_app.handle = timed, timed_check, twin
        trace = drive(app, twin_app, watcher, xs, *rest)
        drives.append((trace, requests, polls))
        return trace

    production_key = [None]
    seed_registry = canary_module._seed_two_model_registry

    def seeded(*a, **k):
        keys = seed_registry(*a, **k)
        production_key[0] = keys[0]
        return keys

    canary_module._seed_two_model_registry = seeded
    canary_module._drive = recorded
    cores = sorted(os.sched_getaffinity(0))
    for rep in range(args.reps):
        pinned = args.pin_alternate and rep % 2 == 1
        os.sched_setaffinity(0, {cores[-1]} if pinned else set(cores))
        root = os.path.join(work, f"healthy-{rep}")
        summary = run_canary_chaos(
            FilesystemStore(root), scenario="healthy", seed=0, n_requests=args.requests,
            fraction=0.35, model_type="mlp", model_kwargs=cs.LOOP_MLP, device=dev)
        trace, requests, polls = drives[-1]
        by_checkpoint, slow, causes = {}, [], {}
        for i, (key, r) in enumerate(zip(trace["keys"], requests)):
            name = "production" if key == summary["production_key"] else "candidate"
            ms = 1e3 * r["s"]
            by_checkpoint.setdefault(name, []).append((round(ms, 3), i))
            if ms > args.slow_ms:
                flags = [f for f in ("rebind", "after_poll") if r[f]] + (["gc"] if r["gc"] else [])
                slow.append({"i": i, "stream": name, "ms": round(ms, 3),
                             "run_ms": round(1e3 * r["run_s"], 3), "flags": flags})
                if name == "candidate":
                    label = "+".join(flags) or "none"
                    causes[label] = causes.get(label, 0) + 1
        rebound = [1e3 * r["s"] for key, r in zip(trace["keys"], requests)
                   if key != summary["production_key"] and r["rebind"]]
        kept = [1e3 * r["s"] for key, r in zip(trace["keys"], requests)
                if key != summary["production_key"] and not r["rebind"]]
        dumps = summary["flight_record_keys"]
        window = (json.loads(FilesystemStore(root).get_bytes(dumps[-1]))["window"]
                  if dumps else None)
        print(json.dumps({
            "rep": rep, "pinned": pinned, "ok": summary["ok"],
            "abort_at_request": summary["abort_at_request"],
            "promote_at_request": summary["promote_at_request"], "window": window,
            "median_ms": {k: statistics.median(ms for ms, _i in v)
                          for k, v in by_checkpoint.items()},
            "candidate_median_ms_rebind": statistics.median(rebound) if rebound else None,
            "candidate_median_ms_no_rebind": statistics.median(kept) if kept else None,
            "candidate_rebinds": len(rebound), "candidate_no_rebind": len(kept),
            "slowest": {k: sorted(v, reverse=True)[:6] for k, v in by_checkpoint.items()},
            "slow": slow, "causes": causes,
            "threads": sorted(t.name for t in threading.enumerate()),
            "polls_ms": [round(p, 2) for p in polls]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
