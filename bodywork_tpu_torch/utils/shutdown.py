"""Graceful SIGTERM handling for the long-running command-line entry
points (a copy of ``bodywork_tpu.utils.shutdown``).

Kubernetes stops a pod with SIGTERM, waits
``terminationGracePeriodSeconds``, then sends SIGKILL. Python's default
disposition dies mid-stack: no journal ``interrupted`` mark.
:func:`graceful_sigterm` turns the signal into :class:`ShutdownRequested`
raised in the main thread (CPython runs signal handlers there, so the
raise unwinds whatever the entry point is blocked in: a thread join, a
serve loop) and arms a watchdog that force-exits if the unwind itself
hangs past its deadline, which must end before the kubelet's SIGKILL.

``ShutdownRequested`` subclasses ``BaseException``: no retry or recovery
layer may swallow a shutdown and keep working.
"""
from __future__ import annotations

import os
import signal
import threading
from contextlib import contextmanager

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("utils.shutdown")

__all__ = ["SIGTERM_EXIT", "ShutdownRequested", "grace_deadline_from_env", "graceful_sigterm"]

#: exit code after a graceful SIGTERM unwind: 128 + SIGTERM, which k8s
#: tooling reads as "terminated, not failed"
SIGTERM_EXIT = 143

#: default graceful deadline, inside the 30 s
#: ``terminationGracePeriodSeconds`` of the JAX package's manifests
DEFAULT_GRACE_S = 20.0


class ShutdownRequested(BaseException):
    """SIGTERM arrived: unwind, journal, exit ``SIGTERM_EXIT``."""


def grace_deadline_from_env(default: float = DEFAULT_GRACE_S) -> float:
    """``BODYWORK_TPU_GRACE_S``: a deployment with another grace period
    sizes the in-process deadline to match (it must stay below the
    kubelet's, or SIGKILL wins)."""
    from bodywork_tpu_torch.utils.env import positive_float_env

    return positive_float_env("BODYWORK_TPU_GRACE_S", default)


@contextmanager
def graceful_sigterm(deadline_s: float | None = None):
    """Turn SIGTERM into :class:`ShutdownRequested` for the duration of
    the block, restoring the previous handler on exit; yields the
    ``fired`` event. A second SIGTERM while unwinding is ignored (the
    watchdog owns escalation). The watchdog is cancelled once control
    leaves the block. A no-op outside the main thread (``signal.signal``
    would raise)."""
    if deadline_s is None:
        deadline_s = grace_deadline_from_env()
    fired = threading.Event()
    timer_box: list[threading.Timer] = []

    def _handler(signum, frame):
        if fired.is_set():
            return  # already unwinding; the watchdog bounds the rest
        fired.set()
        log.warning(f"SIGTERM: beginning graceful shutdown (deadline {deadline_s:.0f}s)")

        def _watchdog():
            os._exit(SIGTERM_EXIT)

        timer = threading.Timer(deadline_s, _watchdog)
        timer.daemon = True
        timer.start()
        timer_box.append(timer)
        raise ShutdownRequested("SIGTERM")

    try:
        previous = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread (in-process tests): no-op
        yield fired
        return
    try:
        yield fired
    finally:
        signal.signal(signal.SIGTERM, previous)
        for timer in timer_box:
            timer.cancel()
