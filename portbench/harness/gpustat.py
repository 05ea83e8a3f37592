"""The card's own utilization counter, sampled through a window:
``nvidia-smi --query-gpu=utilization.gpu`` every 500 ms, each sample
stamped with the monotonic clock as it arrives. The counter is the share
of the driver's last sample period (1/6 s to 1 s) in which a kernel ran:
coarse, and read from outside the process that drives the card."""
from __future__ import annotations

import subprocess
import threading
import time


class UtilizationSampler:
    def __init__(self, index: int = 0, period_ms: int = 500):
        self._cmd = ["nvidia-smi", "-i", str(index), "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits", "-lms", str(period_ms)]
        self._proc = None
        self._thread = None
        self.samples: list = []

    def start(self) -> "UtilizationSampler":
        """Start sampling; where there is no ``nvidia-smi`` (the CPU
        tests) nothing is sampled."""
        try:
            self._proc = subprocess.Popen(self._cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self._thread = threading.Thread(target=self._read, name="utilization", daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                self.samples.append((time.monotonic(), float(line.strip())))
            except ValueError:
                continue

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)
        self._thread.join(timeout=10)

    def between(self, t0: float, t1: float) -> list:
        """The utilization samples (%) that arrived in ``[t0, t1]``."""
        return [u for t, u in self.samples if t0 <= t <= t1]
