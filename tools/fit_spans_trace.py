#!/usr/bin/env python3
"""The host's side of one traced fit, on the device trace's clock.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/fit_spans_trace.py [--seed 1] [--small --device cpu]

Runs the benchmark cell ``train-mlp32x1024-b32768``'s fit
(``portbench/configs/mlp32x1024x3-f32-b32768.json`` on the data sets of
traffic ``fits-r16384``, drawn from ``--seed`` as
``portbench/drivers/train_fits.py`` draws them): two fits to warm up, then
one fit with a ``SpanRecorder`` installed (``obs.spans.recording``) under
the benchmark's ``DeviceTrace``, the process's first profile, as in the
benchmark's traced run. ``--small`` shrinks the fit for a rehearsal on the
CPU, where the trace holds no device event.

Prints one JSON line:

- ``fit_setup_ms``: from ``fit``'s start to ``fit.dispatch``'s, the host's
  set-up, through which the card idles between fits;
- ``host_step_ms``: the median of the ``fit.step`` spans (the first
  ``HEAD_STEPS`` steps' enqueues, which never wait on the card);
- ``queue_ahead_ms``: ``fit.drain``'s duration, the card's work still
  queued when the host has enqueued the last step;
- ``skew_ms``: the span-device skew. ``dispatch``: how long after
  ``fit.dispatch``'s start the first device operation after it starts (at
  least 0 by its definition); ``drain``: how long before ``fit.drain``'s
  end the last device operation ends (below 0 where the device clock runs
  late); ``first``: how long after ``fit``'s start the trace's first
  device operation starts (below 0 where it runs early). Below -1 ms the
  two clocks are ``aligned: false``;
- ``idle_gaps``: the benchmark's breakdown of the longest idle gaps
  (``portbench/harness/tracesum.py``), each label prefixed with the
  innermost span open at the gap's start, ``[-]`` where none is, or
  ``[unaligned]``; ``idle_ms_by_span``: every idle stretch of the trace
  window split at the span boundaries, summed by innermost span;
- ``spans_ms``: each span's milliseconds (the steps listed in order);
  ``annotation_events``: device events named like a span (a
  ``record_function`` range that reached the device trace; 0 expected).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

CONFIG = "portbench/configs/mlp32x1024x3-f32-b32768.json"
TRAFFIC = "fits-r16384"
#: the CPU rehearsal's shapes (``portbench/tests/dryrun.py``'s)
SMALL = ({"hidden": [32, 32, 32], "batch_size": 256, "n_steps": 40}, {"rows": 2048})
#: a skew below this many ms means the host and device clocks disagree
UNALIGNED_MS = -1.0


def wall_spans(recorder) -> list:
    """The recorder's spans as dicts on the wall clock (``time.time()``,
    the clock the device trace keeps its events on): ``name``,
    ``parent``, ``start``, ``end`` (seconds) and ``meta``."""
    return [{"name": s.name, "parent": s.parent, "start": recorder.epoch_unix_s + s.start_s,
             "end": recorder.epoch_unix_s + s.end_s, "meta": dict(s.meta)}
            for s in recorder.spans()]


def _one(spans: list, name: str) -> dict:
    return next(s for s in spans if s["name"] == name)


def readings(spans: list) -> dict:
    """The three readings of one fit's spans, in ms."""
    fit, dispatch = _one(spans, "fit"), _one(spans, "fit.dispatch")
    drain = _one(spans, "fit.drain")
    steps = [s["end"] - s["start"] for s in spans if s["name"] == "fit.step"]
    return {"fit_setup_ms": 1e3 * (dispatch["start"] - fit["start"]),
            "host_step_ms": 1e3 * statistics.median(steps),
            "queue_ahead_ms": 1e3 * (drain["end"] - drain["start"])}


def skew(spans: list, events: list) -> dict:
    """The span-device skew in ms (the module docstring); None where the
    trace holds no device event."""
    if not events:
        return {"dispatch": None, "drain": None, "first": None}
    fit, dispatch = _one(spans, "fit"), _one(spans, "fit.dispatch")
    drain = _one(spans, "fit.drain")
    after = [s for _n, s, _e in events if s >= dispatch["start"]]
    return {"dispatch": 1e3 * (min(after) - dispatch["start"]) if after else None,
            "drain": 1e3 * (drain["end"] - max(e for _n, _s, e in events)),
            "first": 1e3 * (min(s for _n, s, _e in events) - fit["start"])}


def aligned(skews: dict) -> bool:
    return all(v is None or v >= UNALIGNED_MS for v in skews.values())


def innermost(spans: list, t: float) -> str | None:
    """The name of the innermost span open at ``t``: of those that hold
    it, the latest to start, and of those the first to end."""
    open_ = [s for s in spans if s["start"] <= t < s["end"]]
    return max(open_, key=lambda s: (s["start"], -s["end"]))["name"] if open_ else None


def labelled_gaps(trace: dict, spans: list, top: int = 10, is_aligned: bool = True) -> list:
    """``tracesum.breakdown``'s idle gaps, in its order and with its
    seconds, each label prefixed with ``[<innermost span>]``, ``[-]`` or
    ``[unaligned]``."""
    from portbench.harness import tracesum
    from portbench.harness.yardstick import idle_gaps

    gaps = tracesum.breakdown(trace, top)["idle_gaps"]
    events = sorted(tracesum.clipped(trace), key=lambda e: e[1])
    starts = idle_gaps([(s, e) for _n, s, e in events], trace["t0"], trace["t1"], top)
    out = []
    for (label, seconds), (start, _seconds) in zip(gaps, starts):
        name = innermost(spans, start) if is_aligned else "unaligned"
        out.append([f"[{name or '-'}] {label}", seconds])
    return out


def idle_by_span(trace: dict, spans: list) -> dict:
    """Milliseconds of the trace window in which no device operation ran,
    split at every span boundary and summed by the innermost span open
    (``-`` where none is)."""
    from portbench.harness import tracesum
    from portbench.harness.yardstick import idle_gaps

    events = tracesum.clipped(trace)
    gaps = idle_gaps([(s, e) for _n, s, e in events], trace["t0"], trace["t1"],
                     len(events) + 1)
    edges = sorted({t for s in spans for t in (s["start"], s["end"])})
    out: dict = {}
    for start, seconds in gaps:
        cuts = [start] + [t for t in edges if start < t < start + seconds] + [start + seconds]
        for a, b in zip(cuts[:-1], cuts[1:]):
            name = innermost(spans, a) or "-"
            out[name] = out.get(name, 0.0) + 1e3 * (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def spans_ms(spans: list) -> dict:
    out: dict = {}
    for s in spans:
        ms = 1e3 * (s["end"] - s["start"])
        if s["name"] == "fit.step":
            out.setdefault("fit.step", []).append(ms)
        else:
            out[s["name"]] = ms
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="the CPU rehearsal's shapes")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.obs.spans import SpanRecorder, recording
    from portbench.drivers.train_fits import datasets
    from portbench.harness import card_power_limit, spec, tracesum
    from portbench.harness.devtrace import DeviceTrace

    with open(os.path.join(ROOT, CONFIG)) as f:
        cfg = json.load(f)
    trf = spec.traffic(TRAFFIC)
    if args.small:
        cfg, trf = {**cfg, **SMALL[0]}, {**trf, **SMALL[1]}
    mlp_cfg = MLPConfig(hidden=tuple(cfg["hidden"]), learning_rate=cfg["learning_rate"],
                        batch_size=cfg["batch_size"], n_steps=cfg["n_steps"])
    rng = np.random.default_rng(args.seed)
    data = datasets(rng, trf, cfg["features"])
    seeds = [int(s) for s in rng.integers(0, 2**31, size=3)]
    for k in range(2):
        MLPRegressor(mlp_cfg).fit(*data[k % len(data)], seed=seeds[k], device=args.device)

    recorder = SpanRecorder(label="fit")
    trace = DeviceTrace().start()
    with recording(recorder):
        MLPRegressor(mlp_cfg).fit(*data[2 % len(data)], seed=seeds[2], device=args.device)
    trace.stop()

    dump = trace.dump()
    spans = wall_spans(recorder)
    events = tracesum.clipped(dump)
    skews = skew(spans, events)
    ok = aligned(skews)
    busy, window = tracesum.busy_window(dump)
    names = {s["name"] for s in spans}
    on_card = args.device != "cpu"
    print(json.dumps({
        "card": torch.cuda.get_device_name(0) if on_card else "cpu",
        "power_limit": card_power_limit() if on_card else "n/a",
        "seed": args.seed, "batch": mlp_cfg.batch_size, "steps": mlp_cfg.n_steps,
        **readings(spans),
        "skew_ms": skews, "aligned": ok,
        "busy_s": busy, "window_s": window, "device_events": len(dump["events"]),
        "annotation_events": sum(e[0] in names for e in dump["events"]),
        "idle_gaps": labelled_gaps(dump, spans, is_aligned=ok),
        "idle_ms_by_span": idle_by_span(dump, spans),
        "spans_ms": spans_ms(spans),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
