"""Profiling hooks (the port of ``bodywork_tpu.utils.profiling``).

The reference traces every stage through Sentry at full sample rate; the
JAX package's switch is ``jax.profiler``. Here it is ``torch.profiler``:
:func:`maybe_trace` profiles one region (the CLI's ``run-sim
--profile-dir`` wraps the whole simulation) and writes a Chrome trace
that Perfetto and ``chrome://tracing`` load; :func:`annotate` names a
sub-region inside it.

On the card the profile records the CUDA activity through CUPTI, which
sees every kernel the process runs, whether PyTorch's dispatcher, a
``ctypes`` library or a CUDA-graph replay launched it. A profile of a
run on the card without that activity would look complete and show no
device time, so it is refused rather than written.

The trace keeps a device record only if its timestamp, converted to the
host's clock, falls inside the profile's window. In a process's first
profile the conversion holds (a graph-replayed kernel within 0.1 ms of
its launch on an H100); in a later one it can drift by tens of
milliseconds within seconds, either way (``tools/profile_repeat.py``
measures it), and a kernel launched in the region's last tens of
milliseconds went missing from the trace although the region ended in a
synchronize. So on the card the profile opens :data:`EDGE_S` before
the region, and stays open after the region's synchronize for
:data:`EDGE_S` or :data:`TAIL_SHARE` of the region's duration, whichever
is longer: the region's records, drifted or late, stay inside the
window.
"""
from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("profiling")

#: seconds a profile on the card stays open before and after its region
EDGE_S = 0.25
#: the share of the region's duration the profile stays open after it,
#: where that is longer than EDGE_S: above the largest drift measured
TAIL_SHARE = 0.1


def trace_path(trace_dir: str | Path, label: str = "") -> Path:
    """The Chrome-trace file :func:`maybe_trace` writes for ``label``."""
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", label).strip("-") or "trace"
    return Path(trace_dir) / f"{slug}.pt.trace.json"


@contextlib.contextmanager
def maybe_trace(trace_dir: str | Path | None, label: str = "", device=None):
    """``torch.profiler.profile`` over the region when ``trace_dir`` is
    set, exporting :func:`trace_path` at its end; a no-op otherwise.

    ``device`` is the device the region runs on, resolved as every entry
    point resolves it (the card unless ``"cpu"`` is asked for). On the
    card the CUDA activity is recorded too, and a profiler that cannot
    record it raises ``RuntimeError`` before the region starts. Profiles
    do not nest: wrap one outer region and :func:`annotate` inside it."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    from bodywork_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity in this process "
                f"(supported: {sorted(a.name for a in supported_activities())}); "
                "a profile of a run on the card would hold no device time"
            )
        activities.append(ProfilerActivity.CUDA)
    path = trace_path(trace_dir, label)
    path.parent.mkdir(parents=True, exist_ok=True)
    log.info(f"profiling {label or 'region'} ({', '.join(a.name for a in activities)}) "
             f"-> {path}")
    with profile(activities=activities) as prof:
        if dev.type == "cuda":
            time.sleep(EDGE_S)  # the region's first records stay inside the window
        t0 = time.perf_counter()
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                # the region's kernels end inside the profile, not after it,
                # and their drifted timestamps too (the module docstring)
                torch.cuda.synchronize(dev)
                time.sleep(max(EDGE_S, TAIL_SHARE * (time.perf_counter() - t0)))
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region of an active profile (a ``record_function``
    range); costs one profiler check when none is active."""
    import torch

    with torch.profiler.record_function(name):
        yield
