"""Multiprocess metrics aggregation for ``serve --workers N`` (the port's
copy of ``bodywork_tpu.obs.multiproc``: the same snapshot files, age-out
rule and rendered text).

The multi-process service (:mod:`bodywork_tpu_torch.serve.multiproc`) runs N
OS-process replicas behind one ``SO_REUSEPORT`` port; a ``GET /metrics``
scrape lands on ONE of them, chosen by the kernel. For the scrape to be
a coherent service-wide view, every worker periodically flushes its
registry snapshot to a shared directory (atomic tmp+rename, one file per
pid), and whichever worker answers the scrape merges its own LIVE
registry with its siblings' latest flushed snapshots.

Properties of this scheme (the same trade prometheus_client's
multiprocess mode makes, minus the mmap machinery):

- the answering worker's own numbers are exact (live registry, not its
  file — its own file is excluded from the merge to avoid double
  counting);
- sibling numbers lag by at most one flush interval, and a scrape loop
  converges as flushes land (counters only grow);
- a worker that died keeps contributing its last flushed snapshot's
  MONOTONIC totals (counters, histograms) — its already-served requests
  must not vanish from service totals, exactly as a restarted pod's
  Prometheus counters persist in recording rules — but its GAUGES are
  aged out: a point-in-time reading of a process that no longer exists
  is a lie (a crashed replica's last queue-depth would otherwise read
  high forever after the supervisor respawns it). Liveness is a
  zero-signal ``kill(pid, 0)`` probe against the snapshot's recorded
  pid — same-host by construction, since the snapshot dir is the
  serving process's own — cross-checked against the recorded
  ``/proc/<pid>/stat`` start time so a RECYCLED pid can never
  resurrect a dead worker's gauges.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path

from bodywork_tpu_torch.obs.registry import (
    Registry,
    merge_snapshots,
    render_snapshot,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("obs.multiproc")

__all__ = [
    "SNAPSHOT_PREFIX",
    "DEFAULT_FLUSH_INTERVAL_S",
    "MetricsFlusher",
    "read_sibling_snapshots",
    "aggregated_snapshot",
    "aggregated_render",
]

SNAPSHOT_PREFIX = "obs-metrics-"
DEFAULT_FLUSH_INTERVAL_S = 0.25


def _snapshot_path(directory: str | Path, pid: int) -> Path:
    return Path(directory) / f"{SNAPSHOT_PREFIX}{pid}.json"


def _pid_start(pid: int) -> int | None:
    """The kernel's process start time (jiffies since boot, field 22 of
    ``/proc/<pid>/stat``) — what makes the liveness probe PID-REUSE
    proof: a recycled pid carries a different start time, so a dead
    worker's gauges can never be resurrected by an unrelated process
    inheriting its pid. None off-procfs (the probe then degrades to the
    existence check alone)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_bytes()
        # split after the comm field (parenthesised, may embed spaces):
        # the remaining fields start at field 3, so starttime (22) is
        # the 20th of them
        return int(stat.rsplit(b")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def write_snapshot(registry: Registry, directory: str | Path,
                   pid: int | None = None) -> Path:
    """Atomically persist one process's snapshot (tmp file + rename, so a
    concurrent reader never sees a torn write)."""
    pid = os.getpid() if pid is None else pid
    directory = Path(directory)
    # deliberately NO mkdir: the service owner creates the directory and
    # may delete it at teardown — a worker's final flush racing that
    # deletion must fail (caught by the flusher) rather than resurrect
    # the directory and leak it
    payload = json.dumps({
        "pid": pid,
        "pid_start": _pid_start(pid),
        "snapshot": registry.snapshot(),
    })
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".obs-tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        final = _snapshot_path(directory, pid)
        os.replace(tmp, final)
        return final
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _pid_alive(pid: int) -> bool:
    """Zero-signal liveness probe. PermissionError means the pid exists
    under another uid — alive; only ProcessLookupError means gone."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def _age_out_dead(payload: dict) -> dict:
    """A DEAD worker's snapshot contributes its monotonic totals only:
    counters and histograms persist (served requests must not vanish
    from service totals), gauges are dropped (a dead process's
    point-in-time readings — queue depth, watchdog state — would
    otherwise poison the merged view forever; the module docstring's
    stale-worker rule). Dead = the pid is gone OR its recorded start
    time no longer matches (pid recycled to an unrelated process)."""
    pid = payload.get("pid")
    snap = payload["snapshot"]
    if isinstance(pid, int):
        alive = _pid_alive(pid)
        if alive:
            recorded = payload.get("pid_start")
            current = _pid_start(pid)
            if (
                recorded is not None
                and current is not None
                and recorded != current
            ):
                alive = False  # pid reused by a different process
        if not alive:
            return {
                name: entry for name, entry in snap.items()
                if entry.get("type") != "gauge"
            }
    return snap


def read_sibling_snapshots(
    directory: str | Path, exclude_pid: int | None = None
) -> list[dict]:
    """Every flushed snapshot in ``directory`` except ``exclude_pid``'s
    own file, with dead workers' gauges aged out (:func:`_age_out_dead`).
    Unreadable/torn files are skipped (a worker mid-first-flush must not
    fail the whole scrape)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    snaps = []
    for path in sorted(directory.glob(f"{SNAPSHOT_PREFIX}*.json")):
        if exclude_pid is not None and path.name == (
            f"{SNAPSHOT_PREFIX}{exclude_pid}.json"
        ):
            continue
        try:
            payload = json.loads(path.read_text())
            snaps.append(_age_out_dead(payload))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return snaps


def aggregated_snapshot(
    registry: Registry, directory: str | Path | None
) -> dict:
    """This process's LIVE snapshot merged with its siblings' flushed
    ones — the service-wide view a ``/metrics`` scrape should return.
    With no directory (single-process serving) it is just the registry."""
    own = registry.snapshot()
    if directory is None:
        return own
    siblings = read_sibling_snapshots(directory, exclude_pid=os.getpid())
    if not siblings:
        return own
    return merge_snapshots([own, *siblings])


def aggregated_render(registry: Registry, directory: str | Path | None) -> str:
    return render_snapshot(aggregated_snapshot(registry, directory))


class MetricsFlusher:
    """Background thread flushing this process's registry snapshot to the
    shared directory every ``interval_s`` (plus once on ``stop``, so a
    cleanly-exiting worker's final counts always land)."""

    def __init__(
        self,
        registry: Registry,
        directory: str | Path,
        interval_s: float = DEFAULT_FLUSH_INTERVAL_S,
    ):
        self.registry = registry
        self.directory = Path(directory)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="obs-metrics-flusher", daemon=True
        )

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.flush()
        self.flush()  # final flush on stop

    def flush(self) -> None:
        try:
            write_snapshot(self.registry, self.directory)
        except OSError as exc:  # never take the serving path down
            log.warning(f"metrics snapshot flush failed: {exc!r}")

    def start(self) -> "MetricsFlusher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)
