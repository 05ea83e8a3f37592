"""The processes a run starts: their CPU seconds, and the check that none
is left behind (a copy of ``chip_smoke.py``'s ``_descendants`` and
``_check_processes``, which read ``/proc`` and change nothing)."""
from __future__ import annotations

import os
import signal
import time

#: how long processes below the run may take to end once stopped
GRACE_S = 20.0
#: set to the run's pid in the environment of every process it starts,
#: so that an orphan is still found as the run's
RUN_ENV = "PORTBENCH_RUN"


def _read(path: str) -> bytes:
    try:
        with open(f"/proc/{path}", "rb") as f:
            return f.read()
    except OSError:
        return b""


def cpu_seconds(pid: int) -> float | None:
    """User plus system CPU seconds of a live process, from its
    ``/proc/<pid>/stat``; None once it has gone."""
    stat = _read(f"{pid}/stat").decode(errors="replace")
    if not stat:
        return None
    fields = stat[stat.rindex(")") + 2:].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def descendants(root: int | None = None) -> list:
    """The live processes below ``root`` (this process by default), by
    each ``/proc/<pid>/stat``'s parent pid, with those whose environment
    holds ``RUN_ENV`` set to ``root``: ``[{"pid", "ppid", "cmdline"}]``.
    Zombies are left out, and so is this process's multiprocessing
    resource tracker, which lives as long as this process."""
    from multiprocessing import resource_tracker

    root = os.getpid() if root is None else root
    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    parent = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        stat = _read(f"{pid}/stat").decode(errors="replace")
        if stat:
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if state != "Z":
                parent[int(pid)] = int(ppid)
    below, grew = {root}, True
    while grew:
        grew = False
        for pid, ppid in parent.items():
            if ppid in below and pid not in below:
                below.add(pid)
                grew = True
    marker = f"\0{RUN_ENV}={root}\0".encode()
    below |= {pid for pid in parent if pid not in below
              and marker in b"\0" + _read(f"{pid}/environ")}
    return [{"pid": pid, "ppid": parent[pid],
             "cmdline": _read(f"{pid}/cmdline").replace(b"\0", b" ").decode(
                 errors="replace").strip()[:300]}
            for pid in sorted(below - {root, tracker}) if pid in parent]


def check_processes(grace_s: float = GRACE_S) -> list:
    """Wait up to ``grace_s`` for every process below this one to end;
    kill those still alive and return them (empty when none was left)."""
    t0 = time.monotonic()
    left = descendants()
    while left and time.monotonic() - t0 < grace_s:
        time.sleep(0.1)
        left = descendants()
    for p in left:
        try:
            os.kill(p["pid"], signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left
