"""A device trace (``devtrace``'s ``{"t0", "t1", "events"}``) reduced to
what the result line carries: busy and window seconds, the device
operations that took most time, and the longest idle gaps."""
from __future__ import annotations

from collections import defaultdict

from portbench.harness.yardstick import idle_gaps, union_seconds


def clipped(trace: dict) -> list:
    """The trace's device events that overlap its window."""
    t0, t1 = trace["t0"], trace["t1"]
    return [e for e in trace["events"] if e[2] > t0 and e[1] < t1]


def busy_window(trace: dict) -> tuple[float, float]:
    """Seconds of the window in which a device operation ran, and the
    window's seconds."""
    t0, t1 = trace["t0"], trace["t1"]
    return union_seconds([(s, e) for _n, s, e in clipped(trace)], t0, t1), t1 - t0


def seconds_by_name(trace: dict) -> dict:
    """Device seconds and counts of each operation name in the window."""
    total, count = defaultdict(float), defaultdict(int)
    t0, t1 = trace["t0"], trace["t1"]
    for name, s, e in clipped(trace):
        total[name] += min(e, t1) - max(s, t0)
        count[name] += 1
    return {n: (total[n], count[n]) for n in total}


def breakdown(trace: dict, top: int = 10) -> dict:
    """``device_ops``: the ``top`` operations by device seconds;
    ``idle_gaps``: the ``top`` longest gaps, each named by the operations
    on either side of it (what the host was between)."""
    events = sorted(clipped(trace), key=lambda e: e[1])
    ops = sorted(seconds_by_name(trace).items(), key=lambda kv: -kv[1][0])[:top]
    gaps = []
    starts = [e[1] for e in events]
    for start, seconds in idle_gaps([(s, e) for _n, s, e in events], trace["t0"], trace["t1"],
                                    top):
        before = [e[0] for e in events if e[2] <= start + 1e-9]
        after_i = next((i for i, s in enumerate(starts) if s >= start + seconds - 1e-9), None)
        label = (f"{before[-1][:60] if before else 'window start'} -> "
                 f"{events[after_i][0][:60] if after_i is not None else 'window end'}")
        gaps.append([label, seconds])
    return {"device_ops": [[n[:120], v[0]] for n, v in ops], "idle_gaps": gaps}
