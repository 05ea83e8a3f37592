#!/usr/bin/env python3
"""How often the canary acceptance's ``healthy`` scenario aborts on the card.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/canary_repeat.py [--reps 10] [--requests 240] [--after-trace]
                                   [--pin-alternate] [--no-sampler]

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

Each slow request also carries ``gap_ms``, the host's time from the end
of the card's previous work (the last wait on an event, the twin's
included) to this request's replay, and the card's SM clock and active
clock-event reasons sampled beside the run (``nvidia-smi
--query-gpu=timestamp,clocks.sm,clocks_event_reasons.active -lms 20``,
every sample within 25 ms of the request: ``sm_mhz``, ``reasons``).
Each line adds the drive's clock summary (``clock``: the samples' SM
clock median and minimum, and the share of samples that reason idle) and
``median_gap_ms``. ``--wait spin`` replaces the wait on the event with a
loop over ``Event.query()`` (an experiment: a blocking wait against a
spinning one). Each slow request's ``calls_ms`` splits its dispatch's
host time by call: ``lock`` (the weight slot), ``rebind``, ``stage``
(the batch into pinned memory), ``h2d`` (the copy's enqueue),
``replay`` (the graph launch), ``count``, ``d2h`` (the copy back's
enqueue), ``record``, ``wait`` (the event) and ``out`` (the result's
copy), summed over the request's dispatches.

Whether the host itself ran slow when a request did: each request is
bracketed by a fixed piece of interpreter work on the drive's thread
(``probe_us``, before and after), and a second process times the same
kind of work every millisecond in a process of its own (``other_probe_max_us``,
the slowest such probe within the request). ``psi_ms`` is the host's CPU
pressure stall over the request (``/proc/pressure/cpu``, null where the
host has none). Each line's ``probes`` gives how often either probe ran
over twice its median beside the slow requests against beside every
request, and ``host`` what the host did across the drive: the CPU time's
shares by kind (``steal`` included), the load average, the pressure
stall, the processes that took the most CPU and the threads alive at
each watcher poll (``threads_in_drive``). ``--no-sampler`` leaves the
``nvidia-smi`` sampler off.
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
    parser.add_argument("--wait", choices=("block", "spin"), default="block")
    parser.add_argument("--no-sampler", action="store_true")
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

    current = {"run_s": 0.0, "rebind": False, "gc": 0, "lock_s": 0.0, "events": [],
               "gap_s": None, "calls": {}}
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
        if current["gap_s"] is None and last_sync_end[0] is not None:
            current["gap_s"] = time.perf_counter() - last_sync_end[0]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph_replay(self)
        end.record()
        events = current["events"]
        if len(events) > 64:  # replays outside a timed request (the twin's)
            del events[:-1]
        events.append([start, end, None])

    last_sync_end = [None]

    def timed_sync(self):
        tail = None
        if current["events"] and current["events"][-1][2] is None:
            tail = torch.cuda.Event(enable_timing=True)
            tail.record()  # after the copy back and this event's own record
            current["events"][-1][2] = tail
        t0 = time.perf_counter()
        try:
            if args.wait == "spin":
                while not self.query():
                    pass
                return None
            return event_sync(self)
        finally:
            last_sync_end[0] = time.perf_counter()
            current["sync_s"] += last_sync_end[0] - t0

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

    def split_run(self, Xp, owner, weights, cache):
        """``_BucketGraph.run``'s body and its ``_CapturedProgram.run``,
        each host call timed apart."""
        calls = current["calls"]
        clock = [time.perf_counter()]

        def tick(name):
            now = time.perf_counter()
            calls[name] = calls.get(name, 0.0) + now - clock[0]
            clock[0] = now

        slot = self.slot
        slot.acquire()
        tick("lock")
        try:
            with torch.no_grad():
                if slot.owner != owner:
                    torch._foreach_copy_(list(predictor_module._leaves(slot.weights)),
                                         list(predictor_module._leaves(weights)))
                    slot.owner = owner
                    cache.count_rebind()
                    tick("rebind")
                if self.graph is None:
                    return predictor_module._CapturedProgram.run(self, Xp)
                stream = torch.cuda.current_stream(self.device)
                self.staging.numpy()[...] = Xp
                tick("stage")
                self.x.copy_(self.staging, non_blocking=True)
                tick("h2d")
                self.graph.replay()
                tick("replay")
                cache.count_replay(self.engine)
                tick("count")
                self.out_host.copy_(self.out, non_blocking=True)
                tick("d2h")
                self.done.record(stream)
                tick("record")
                self.done.synchronize()
                tick("wait")
                out = self.out_host.numpy().copy()
                tick("out")
                return out
        finally:
            slot.release()

    def timed_run(self, Xp, owner, weights, cache):
        rebind = self.slot.owner != owner
        t0 = time.perf_counter()
        try:
            return split_run(self, Xp, owner, weights, cache)
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

        host0 = _host_snapshot()
        threads_seen = set()

        def timed(*a, **k):
            current.update(run_s=0.0, rebind=False, gc=0, lock_s=0.0, sync_s=0.0, events=[],
                           gap_s=None, calls={})
            probe_before = _busy_probe()
            psi0 = _cpu_pressure_us()
            wall0 = time.time()
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
                psi1 = _cpu_pressure_us()
                sync_s = current["sync_s"]
                replay_ms, span_ms = device_ms()
                requests.append({"s": seconds, "wall": wall0, "gap_s": current["gap_s"],
                                 "calls": dict(current["calls"]),
                                 "run_s": current["run_s"], "sync_s": sync_s,
                                 "replay_ms": replay_ms, "device_ms": span_ms,
                                 "oncpu_s": sched[0], "runq_s": sched[1],
                                 "rebind": current["rebind"], "gc": current["gc"],
                                 "after_poll": after_poll[0], "lock_s": current["lock_s"],
                                 "cpu_s": cpu, "other_cpu_s": other,
                                 "preempted": ru1.ru_nivcsw - ru0.ru_nivcsw,
                                 "yields": ru1.ru_nvcsw - ru0.ru_nvcsw,
                                 "psi_s": None if psi0 is None or psi1 is None
                                 else (psi1 - psi0) / 1e6,
                                 "probe_before_s": probe_before,
                                 "probe_after_s": _busy_probe()})
                after_poll[0] = False
            last_key[0] = out[1].get(MODEL_KEY_HEADER)
            return out

        def twin(*a, **k):
            if args.no_twin_between and last_key[0] != production_key[0]:
                return 200, {}, b""
            return twin_handle(*a, **k)

        def timed_check():
            threads_seen.update(t.name for t in threading.enumerate())
            t0 = time.perf_counter()
            try:
                return check()
            finally:
                polls.append(1e3 * (time.perf_counter() - t0))
                after_poll[0] = True

        app.handle, watcher.check_once, twin_app.handle = timed, timed_check, twin
        trace = drive(app, twin_app, watcher, xs, *rest)
        host = _host_delta(host0, _host_snapshot())
        host["threads_in_drive"] = sorted(threads_seen)
        drives.append((trace, requests, polls, host))
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
        clock_log = os.path.join(work, f"clocks-{rep}.csv")
        sampler = None if args.no_sampler else _start_clock_sampler(clock_log)
        probe_log = os.path.join(work, f"probe-{rep}.bin")
        probe = _start_probe(probe_log)
        try:
            summary = run_canary_chaos(
                FilesystemStore(root), scenario="healthy", seed=0, n_requests=args.requests,
                fraction=0.35, model_type="mlp", model_kwargs=cs.LOOP_MLP, device=dev)
        finally:
            _stop(sampler)
            _stop(probe)
        samples = _read_clock_samples(clock_log)
        probes = _read_probe(probe_log)
        trace, requests, polls, host = drives[-1]
        t_first, t_last = requests[0]["wall"], requests[-1]["wall"] + requests[-1]["s"]
        in_drive = [c for c in samples if t_first - 0.025 <= c[0] <= t_last + 0.025]
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
                             "device_ms": round(r["device_ms"], 3),
                             "calls_ms": {k: round(1e3 * v, 3) for k, v in r["calls"].items()},
                             "gap_ms": None if r["gap_s"] is None
                             else round(1e3 * r["gap_s"], 3),
                             "sm_mhz": [c[1] for c in samples
                                        if r["wall"] - 0.025 <= c[0] <= r["wall"] + r["s"] + 0.025],
                             "reasons": sorted({c[2] for c in samples
                                                if r["wall"] - 0.025 <= c[0]
                                                <= r["wall"] + r["s"] + 0.025}),
                             "psi_ms": None if r["psi_s"] is None
                             else round(1e3 * r["psi_s"], 3),
                             "probe_us": [round(1e6 * r["probe_before_s"], 1),
                                          round(1e6 * r["probe_after_s"], 1)],
                             "other_probe_max_us": _window_max(
                                 probes, r["wall"] - 0.002, r["wall"] + r["s"] + 0.002),
                             "flags": flags})
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
            "median_calls_ms": {
                name: round(1e3 * statistics.median(r["calls"].get(name, 0.0) for r in requests), 4)
                for name in ("lock", "stage", "h2d", "replay", "count", "d2h", "record", "wait",
                             "out")},
            "median_gap_ms": statistics.median(
                1e3 * r["gap_s"] for r in requests if r["gap_s"] is not None),
            "clock": {"samples": len(in_drive),
                      "sm_mhz_median": statistics.median(c[1] for c in in_drive)
                      if in_drive else None,
                      "sm_mhz_min": min((c[1] for c in in_drive), default=None),
                      "idle_share": (sum(1 for c in in_drive if _idle(c[2])) / len(in_drive))
                      if in_drive else None,
                      "reasons": sorted({c[2] for c in in_drive})},
            "wait": args.wait, "sampler": not args.no_sampler,
            "host": host, "probes": _probe_summary(requests, slow, probes),
            "polls_ms": [round(p, 2) for p in polls]}), flush=True)
    return 0


def _busy_probe() -> float:
    """Seconds of a fixed piece of pure-interpreter work on this thread:
    the host thread's own speed just before and after a request."""
    t0 = time.perf_counter()
    x = 0
    for i in range(100):
        x += i
    return time.perf_counter() - t0


_PROBE = """
import array, signal, sys, time
out, stop = array.array("d"), []
signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
while not stop:
    w, t0 = time.time(), time.perf_counter()
    x = 0
    for i in range(500):
        x += i
    out.append(w)
    out.append(time.perf_counter() - t0)
    time.sleep(0.001)
with open(sys.argv[1], "wb") as f:
    out.tofile(f)
"""


def _start_probe(path):
    """A second process timing a fixed piece of interpreter work every
    millisecond beside the drive: whether the whole host
    ran slow when a request did."""
    import subprocess

    return subprocess.Popen([sys.executable, "-c", _PROBE, path])


def _read_probe(path):
    """``[(epoch seconds, probe seconds)]`` from the probe's log."""
    import array

    samples = array.array("d")
    try:
        with open(path, "rb") as f:
            samples.frombytes(f.read())
    except OSError:
        return []
    return list(zip(samples[0::2], samples[1::2]))


def _window_max(probes, t0, t1):
    """The slowest probe (us) that started within ``[t0, t1]``."""
    inside = [d for w, d in probes if t0 <= w <= t1]
    return round(1e6 * max(inside), 1) if inside else None


def _probe_summary(requests, slow, probes) -> dict:
    """How often the probes ran slow (over twice their median) beside the
    slow requests and beside every request: the host's speed against the
    request's."""
    own = [max(r["probe_before_s"], r["probe_after_s"]) for r in requests]
    own_median = statistics.median(r["probe_before_s"] for r in requests)
    t0, t1 = requests[0]["wall"], requests[-1]["wall"] + requests[-1]["s"]
    other = [d for w, d in probes if t0 <= w <= t1]
    other_median = statistics.median(other) if other else None
    slow_idx = {s["i"] for s in slow}

    def share(flags):
        return round(sum(flags) / len(flags), 4) if flags else None

    other_slow = []
    for r in requests:
        m = [d for w, d in probes if r["wall"] - 0.002 <= w <= r["wall"] + r["s"] + 0.002]
        other_slow.append(bool(m) and other_median is not None and max(m) > 2 * other_median)
    return {
        "own_median_us": round(1e6 * own_median, 2),
        "own_slow_share_all": share([o > 2 * own_median for o in own]),
        "own_slow_share_slow_requests": share(
            [own[i] > 2 * own_median for i in sorted(slow_idx)]),
        "other_median_us": None if other_median is None else round(1e6 * other_median, 2),
        "other_samples": len(other),
        "other_max_us": round(1e6 * max(other), 1) if other else None,
        "other_slow_share_all": share(other_slow),
        "other_slow_share_slow_requests": share([other_slow[i] for i in sorted(slow_idx)]),
    }


def _cpu_pressure_us():
    """The host's cumulative CPU pressure stall (``/proc/pressure/cpu``
    ``some total``, microseconds), or None where the host has none."""
    try:
        with open("/proc/pressure/cpu") as f:
            for line in f:
                if line.startswith("some"):
                    return int(line.rsplit("total=", 1)[1])
    except (OSError, ValueError, IndexError):
        return None
    return None


def _host_snapshot() -> dict:
    """The host's CPU counters (``/proc/stat``), load average, CPU
    pressure and every process's CPU ticks, for a delta across the drive."""
    snap = {"t": time.time(), "psi": _cpu_pressure_us(), "procs": {}}
    try:
        with open("/proc/stat") as f:
            snap["cpu"] = [int(v) for v in f.readline().split()[1:]]
        with open("/proc/loadavg") as f:
            snap["loadavg"] = f.read().split()[:3]
    except OSError:
        snap["cpu"], snap["loadavg"] = None, None
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                text = f.read()
        except OSError:
            continue
        comm = text[text.index("(") + 1:text.rindex(")")]
        fields = text[text.rindex(")") + 2:].split()
        snap["procs"][int(pid)] = (comm, int(fields[11]) + int(fields[12]))
    return snap


def _host_delta(a: dict, b: dict) -> dict:
    """What the host did across the drive: the CPU time's shares by kind
    (``steal`` is time a hypervisor gave this machine's CPUs to others),
    the load average, the CPU pressure stall, and the processes that took
    the most CPU meanwhile (ticks of ``SC_CLK_TCK``)."""
    out = {"seconds": round(b["t"] - a["t"], 3), "loadavg": b["loadavg"],
           "psi_stall_ms": None if a["psi"] is None or b["psi"] is None
           else round((b["psi"] - a["psi"]) / 1e3, 3)}
    if a["cpu"] and b["cpu"]:
        names = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])][:len(names)]
        total = sum(d) or 1
        out["cpu_share"] = {n: round(v / total, 4) for n, v in zip(names, d)}
    me = os.getpid()
    busy = sorted(((ticks - a["procs"].get(pid, (None, 0))[1], comm, pid)
                   for pid, (comm, ticks) in b["procs"].items()), reverse=True)
    out["top_processes"] = [{"pid": pid, "comm": comm, "ticks": t, "self": pid == me}
                            for t, comm, pid in busy[:5] if t > 0]
    out["clk_tck"] = os.sysconf("SC_CLK_TCK")
    return out


def _start_clock_sampler(path):
    """``nvidia-smi`` sampling the SM clock and the clock-event reasons
    every 20 ms into ``path`` (None where the tool is missing)."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    for field in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        out = open(path, "w")
        proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu=timestamp,clocks.sm,{field}",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=out, stderr=subprocess.DEVNULL)
        out.close()
        time.sleep(0.3)
        if proc.poll() is None:
            return proc
    return None


def _stop(proc):
    if proc is not None:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except Exception:  # noqa: BLE001 -- never leave the sampler running
            proc.kill()
            proc.wait()


def _read_clock_samples(path):
    """``[(epoch seconds, SM MHz, reasons bitmask text)]`` from the log."""
    from datetime import datetime

    samples = []
    try:
        lines = open(path).read().splitlines()
    except OSError:
        return samples
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 3:
            continue
        try:
            t = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
            samples.append((t, int(float(parts[1])), parts[2]))
        except ValueError:
            continue
    return samples


def _idle(reasons: str) -> bool:
    """The clock-event bitmask's GPU-idle bit (0x1)."""
    try:
        return bool(int(reasons, 16) & 0x1)
    except ValueError:
        return False


if __name__ == "__main__":
    sys.exit(main())
