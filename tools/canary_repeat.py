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
included) against the rest of the request. Where the time went besides:
``lock_ms`` (waiting for the weight slot's lock), ``cpu_ms`` (this
thread's own CPU time), ``other_cpu_ms`` (CPU time the process's other
threads took meanwhile: they held the interpreter lock or ran torch's
pool), ``preempted`` (the kernel's involuntary context switches of this
thread: another process took its core) and ``yields`` (its voluntary
ones: it slept on a lock, the interpreter lock or the card); with
``gil_wait`` flagged when ``other_cpu_ms`` covers most of the gap
between the request's wall time and ``cpu_ms``. Those clocks tick at the
host's scheduler resolution, 10 ms on some hosts, so each request also
reads the kernel's nanosecond accounting of its thread
(``/proc/thread-self/schedstat``, null where the host has none):
``oncpu_ms`` (run time) and ``runq_ms`` (time runnable but waiting for a
core: preemption, flagged ``runq``), and ``sync_ms``, its time waiting for
the card (``torch.cuda.Event.synchronize``, flagged ``device_wait`` when
it is most of the request), beside the card's own clock: ``replay_ms``
(the graph replay between two timing events) and ``device_ms`` (from
the replay's start to the end of the copy back). A ``device_wait`` whose
``device_ms`` is short is the host's: its thread did not run while the
card had finished (flagged ``host_late``); one whose ``device_ms`` is
long is the card's (flagged ``device_slow``). ``causes`` counts the slow
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
    import resource

    current = {"run_s": 0.0, "rebind": False, "gc": 0, "lock_s": 0.0, "events": []}
    graph_run = predictor_module._BucketGraph.run
    slot_acquire = predictor_module._WeightSlot.acquire

    def timed_acquire(self):
        t0 = time.perf_counter()
        try:
            return slot_acquire(self)
        finally:
            current["lock_s"] += time.perf_counter() - t0

    predictor_module._WeightSlot.acquire = timed_acquire
    current["sync_s"] = 0.0
    event_sync = torch.cuda.Event.synchronize

    graph_replay = torch.cuda.CUDAGraph.replay

    def timed_replay(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph_replay(self)
        end.record()
        events = current["events"]
        if len(events) > 64:  # replays outside a timed request (the twin's)
            del events[:-1]
        events.append([start, end, None])

    def timed_sync(self):
        tail = None
        if current["events"] and current["events"][-1][2] is None:
            tail = torch.cuda.Event(enable_timing=True)
            tail.record()  # after the copy back and this event's own record
            current["events"][-1][2] = tail
        t0 = time.perf_counter()
        try:
            return event_sync(self)
        finally:
            current["sync_s"] += time.perf_counter() - t0

    torch.cuda.CUDAGraph.replay = timed_replay
    torch.cuda.Event.synchronize = timed_sync

    def device_ms():
        """(replay ms, replay start to copy-back end ms) on the card's clock."""
        replay = span = 0.0
        for start, end, tail in current["events"]:
            end.synchronize()
            replay += start.elapsed_time(end)
            if tail is not None:
                tail.synchronize()
                span += start.elapsed_time(tail)
        return replay, span

    def schedstat():
        """(on-cpu ns, runqueue-wait ns) of this thread, or None."""
        try:
            with open("/proc/thread-self/schedstat") as f:
                run, wait, _slices = f.read().split()
            return int(run), int(wait)
        except (OSError, ValueError):
            return None

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
            current.update(run_s=0.0, rebind=False, gc=0, lock_s=0.0, sync_s=0.0, events=[])
            sched0 = schedstat()
            ru0 = resource.getrusage(resource.RUSAGE_THREAD)
            cpu0, proc0 = time.thread_time(), time.process_time()
            t0 = time.perf_counter()
            try:
                out = handle(*a, **k)
            finally:
                seconds = time.perf_counter() - t0
                cpu = time.thread_time() - cpu0
                other = max(0.0, time.process_time() - proc0 - cpu)
                ru1 = resource.getrusage(resource.RUSAGE_THREAD)
                sched1 = schedstat()
                sched = ((sched1[0] - sched0[0]) / 1e9, (sched1[1] - sched0[1]) / 1e9) if (
                    sched0 and sched1) else (None, None)
                sync_s = current["sync_s"]
                replay_ms, span_ms = device_ms()
                requests.append({"s": seconds, "run_s": current["run_s"], "sync_s": sync_s,
                                 "replay_ms": replay_ms, "device_ms": span_ms,
                                 "oncpu_s": sched[0], "runq_s": sched[1],
                                 "rebind": current["rebind"], "gc": current["gc"],
                                 "after_poll": after_poll[0], "lock_s": current["lock_s"],
                                 "cpu_s": cpu, "other_cpu_s": other,
                                 "preempted": ru1.ru_nivcsw - ru0.ru_nivcsw,
                                 "yields": ru1.ru_nvcsw - ru0.ru_nvcsw})
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
                gap = r["s"] - r["cpu_s"]
                if r["other_cpu_s"] > 0.5 * gap > 0:
                    flags.append("gil_wait")
                if r["preempted"]:
                    flags.append("preempted")
                if r["lock_s"] > 0.5 * gap > 0:
                    flags.append("lock_wait")
                if r["runq_s"]:
                    flags.append("runq")
                if r["sync_s"] > 0.5 * r["s"]:
                    flags.append("device_wait")
                    flags.append("device_slow" if r["device_ms"] > 0.5 * 1e3 * r["sync_s"]
                                 else "host_late")
                slow.append({"i": i, "stream": name, "ms": round(ms, 3),
                             "run_ms": round(1e3 * r["run_s"], 3),
                             "lock_ms": round(1e3 * r["lock_s"], 3),
                             "cpu_ms": round(1e3 * r["cpu_s"], 3),
                             "other_cpu_ms": round(1e3 * r["other_cpu_s"], 3),
                             "preempted": r["preempted"], "yields": r["yields"],
                             "oncpu_ms": None if r["oncpu_s"] is None
                             else round(1e3 * r["oncpu_s"], 3),
                             "runq_ms": None if r["runq_s"] is None
                             else round(1e3 * r["runq_s"], 3),
                             "sync_ms": round(1e3 * r["sync_s"], 3),
                             "replay_ms": round(r["replay_ms"], 3),
                             "device_ms": round(r["device_ms"], 3), "flags": flags})
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
            "median_cpu_ms": statistics.median(1e3 * r["cpu_s"] for r in requests),
            "median_other_cpu_ms": statistics.median(1e3 * r["other_cpu_s"] for r in requests),
            "requests_preempted": sum(1 for r in requests if r["preempted"]),
            "median_sync_ms": statistics.median(1e3 * r["sync_s"] for r in requests),
            "median_device_ms": statistics.median(r["device_ms"] for r in requests),
            "max_device_ms": max(r["device_ms"] for r in requests),
            "schedstat": requests[0]["oncpu_s"] is not None,
            "requests_runq": sum(1 for r in requests if r["runq_s"]),
            "slowest": {k: sorted(v, reverse=True)[:6] for k, v in by_checkpoint.items()},
            "slow": slow, "causes": causes,
            "threads": sorted(t.name for t in threading.enumerate()),
            "polls_ms": [round(p, 2) for p in polls]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
