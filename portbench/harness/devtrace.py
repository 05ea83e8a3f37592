"""A device trace of a stretch of one process: ``torch.profiler`` with the
CUDA activity alone (no per-op host records, which would slow the host
side of the work it measures), kept as ``(name, start_s, end_s)`` device
events on the host's wall clock, which ``time.time()`` reads too."""
from __future__ import annotations

import time

#: seconds the profile stays open past the stretch's end, so that the
#: device records of its last launches reach the trace before it closes
TAIL_S = 0.3


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self.events: list = []

    def start(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile

        # the CPU's activity only where there is no card (the CPU tests):
        # its records hold no device event
        activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                    else ProfilerActivity.CPU)
        self._prof = profile(activities=[activity])
        self._prof.start()
        self.t0 = time.time()
        return self

    def stop(self) -> "DeviceTrace":
        """Close the stretch at the device's end of its work, then the
        profile ``TAIL_S`` later; keep the device events."""
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t1 = time.time()
        time.sleep(TAIL_S)
        self._prof.stop()
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                start = e.start_ns() / 1e9
                self.events.append((e.name(), start, start + e.duration_ns() / 1e9))
        self._prof = None
        return self

    def dump(self) -> dict:
        return {"t0": self.t0, "t1": self.t1, "events": self.events}
