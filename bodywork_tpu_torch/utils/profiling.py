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
"""
from __future__ import annotations

import contextlib
import re
from pathlib import Path

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("profiling")


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
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                # the region's kernels end inside the profile, not after it
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region of an active profile (a ``record_function``
    range); costs one profiler check when none is active."""
    import torch

    with torch.profiler.record_function(name):
        yield
