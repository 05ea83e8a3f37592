"""Backend bring-up watchdog (the port of ``bodywork_tpu.utils.watchdog``).

A CUDA call that hangs inside the driver (the first
``torch.cuda.is_available()`` or context creation on a wedged card)
blocks in C, where neither ``KeyboardInterrupt`` nor a ``SIGALRM``
handler runs. Only a watchdog thread calling ``os._exit`` can end such a
process, with one line that says why, instead of leaving it to an outer
time limit. ``chip_smoke.py`` arms it around its first CUDA calls.

The JAX module's ``force_cpu_platform`` has no counterpart: it switches a
live process to the CPU, and the port's entry points never fall back to
the CPU behind the caller's back.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading

__all__ = ["BACKEND_UNREACHABLE_EXIT", "abort_if_backend_hangs", "backend_timeout_from_env"]

#: exit code for "device backend unreachable" aborts (both CLIs reserve it)
BACKEND_UNREACHABLE_EXIT = 3


def backend_timeout_from_env(
    var: str = "BODYWORK_TPU_BACKEND_TIMEOUT_S", default: float = 120.0
) -> float:
    """Read a watchdog timeout from the environment; a malformed value
    falls back to the default with a warning rather than crashing the
    caller."""
    raw = os.environ.get(var)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        print(f"watchdog: ignoring malformed {var}={raw!r}; using {default}s",
              file=sys.stderr)
        return default


@contextlib.contextmanager
def abort_if_backend_hangs(timeout_s: float, what: str = "CUDA device"):
    """Abort the process (exit code 3) with one line on stderr if the body
    of the ``with`` block does not complete within ``timeout_s`` seconds.

    ``timeout_s <= 0`` disables the watchdog. It is disarmed on every
    exit path, exceptions included, so a failure inside the block that
    is not a hang cannot leave an armed timer to kill the process later.
    """
    if timeout_s <= 0:
        yield
        return
    done = threading.Event()

    def _watchdog():
        if not done.wait(timeout_s):
            print(f"{what} unreachable after {timeout_s}s (CUDA driver hung?) — aborting",
                  file=sys.stderr)
            sys.stderr.flush()
            os._exit(BACKEND_UNREACHABLE_EXIT)

    threading.Thread(target=_watchdog, name="backend-watchdog", daemon=True).start()
    try:
        yield
    finally:
        done.set()
