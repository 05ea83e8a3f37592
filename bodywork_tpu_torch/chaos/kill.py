"""Seeded process-kill points (the port of ``bodywork_tpu.chaos.kill``).

A :class:`KillSwitch` holds a schedule of kill points and ends the run
when an execution stream reaches one, so that crash resume
(``pipeline/journal.py``) is provable by a test. A kill point addresses a
decision stream, not a global event count, so background threads (the
runner's prefetch, lookahead and compactor) cannot shift it:

- ``{"kind": "stage_boundary", "n": N}``: the Nth step boundary of the
  runner's day loop, counted across the whole run: ``run_day`` hits one
  before each DAG step and one after the last, so an S-step pipeline over
  D days has ``D * (S + 1)`` boundary points;
- ``{"kind": "store_op", "op": OP, "key": KEY, "n": N}``: the Nth call
  of store primitive ``OP`` on ``KEY``, fired before the call reaches the
  backend (a kill mid-stage with the artefact not yet written).

Two actions: ``exit`` (the default) is ``os._exit(EXIT_KILLED)``, no
atexit, no flush, no ``finally``: a SIGKILL or OOM kill in process;
``raise`` raises :class:`SimulatedCrash` (a ``BaseException``) so an
in-process test can stand in for process death, then build a fresh
runner over the same store to restart.

The schedule comes from :func:`install` or from the environment
(:func:`arm_from_env`, ``BODYWORK_TPU_CRASH_SCHEDULE`` = the JSON point
list), the same variable and the same exit code as the JAX package's, so
one schedule kills either package's runner at the same point.
"""
from __future__ import annotations

import json
import os
import threading

from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.kill")

__all__ = [
    "EXIT_KILLED",
    "KillSwitch",
    "KillSwitchStore",
    "SimulatedCrash",
    "arm_from_env",
    "get_kill_switch",
    "hit_kill_point",
    "install",
    "parse_schedule",
    "uninstall",
    "wrap_store",
]

#: exit code of a kill-switch termination — distinct from every
#: documented CLI code (0/1/2/4/5/6/143) so the crash harness can tell
#: "killed as scheduled" from any real failure.
EXIT_KILLED = 86

ENV_SCHEDULE = "BODYWORK_TPU_CRASH_SCHEDULE"

_KINDS = ("stage_boundary", "store_op")

#: store primitives the ``store_op`` kind counts (payload ops only;
#: metadata probes — version_token/exists — are polled too often to be
#: useful kill anchors and would bloat every stream's n-space)
COUNTED_STORE_OPS = (
    "put_bytes",
    "put_bytes_if_match",
    "get_bytes",
    "list_keys",
    "delete",
    "get_many",
)


class SimulatedCrash(BaseException):
    """In-process stand-in for process death (``action="raise"``).
    Deliberately a ``BaseException``: no retry/recovery layer may treat
    it as a failure to absorb — the runner propagates it raw."""


def parse_schedule(raw) -> list[dict]:
    """Validate a schedule (JSON string or already-parsed list) into the
    canonical point list. Unknown kinds/fields are rejected by name —
    a typo'd kill point silently never firing would make a crash soak
    vacuously pass."""
    if isinstance(raw, str):
        raw = json.loads(raw)
    if not isinstance(raw, list):
        raise ValueError("crash schedule must be a JSON list of points")
    points = []
    for point in raw:
        if not isinstance(point, dict):
            raise ValueError(f"crash point must be an object, got {point!r}")
        kind = point.get("kind")
        if kind not in _KINDS:
            raise ValueError(
                f"unknown crash-point kind {kind!r}; known: {_KINDS}"
            )
        n = point.get("n")
        if not isinstance(n, int) or n < 0:
            raise ValueError(f"crash point needs an int n >= 0, got {point!r}")
        allowed = {"kind", "n"} | (
            {"op", "key"} if kind == "store_op" else set()
        )
        unknown = set(point) - allowed
        if unknown:
            raise ValueError(
                f"unknown crash-point field(s) {sorted(unknown)} in {point!r}"
            )
        if kind == "store_op":
            if point.get("op") not in COUNTED_STORE_OPS:
                raise ValueError(
                    f"store_op crash point needs op in {COUNTED_STORE_OPS}, "
                    f"got {point.get('op')!r}"
                )
            if not isinstance(point.get("key"), str) or not point["key"]:
                raise ValueError(
                    f"store_op crash point needs a non-empty key: {point!r}"
                )
        points.append(dict(point))
    return points


class KillSwitch:
    """Deterministic process-termination schedule (module docstring)."""

    def __init__(self, schedule, action: str = "exit",
                 exit_code: int = EXIT_KILLED):
        if action not in ("exit", "raise"):
            raise ValueError(f"kill switch action must be 'exit' or 'raise', got {action!r}")
        self.action = action
        self.exit_code = exit_code
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        #: stream -> armed n values
        self._points: dict[str, set[int]] = {}
        for point in parse_schedule(schedule):
            stream = self._stream(point["kind"], point.get("op"),
                                  point.get("key"))
            self._points.setdefault(stream, set()).add(point["n"])
        #: points that fired (stream, n) — lets a harness assert the
        #: schedule was actually reached (raise mode only; exit mode
        #: reports through the process exit code)
        self.fired: list[tuple[str, int]] = []

    @staticmethod
    def _stream(kind: str, op: str | None = None, key: str | None = None) -> str:
        if kind == "store_op":
            return f"store|{op}|{key}"
        return kind

    def hit(self, kind: str, op: str | None = None,
            key: str | None = None) -> None:
        stream = self._stream(kind, op, key)
        with self._lock:
            n = self._counts.get(stream, 0)
            self._counts[stream] = n + 1
            armed = n in self._points.get(stream, ())
            if armed:
                self.fired.append((stream, n))
        if not armed:
            return
        if self.action == "exit":
            # SIGKILL semantics: no flush, no atexit, no finally — the
            # journal must already hold everything a restart needs
            os._exit(self.exit_code)
        raise SimulatedCrash(f"kill point {stream}:{n}")


_ACTIVE: KillSwitch | None = None
_ACTIVE_LOCK = threading.Lock()


def install(switch: KillSwitch | None) -> KillSwitch | None:
    """Install (or, with None, clear) the process-wide kill switch;
    returns the previous one so tests can restore it."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        previous, _ACTIVE = _ACTIVE, switch
    return previous


def uninstall() -> None:
    install(None)


def get_kill_switch() -> KillSwitch | None:
    return _ACTIVE


def hit_kill_point(kind: str, op: str | None = None,
                   key: str | None = None) -> None:
    """The zero-cost-when-unarmed hook instrumented code calls."""
    switch = _ACTIVE
    if switch is not None:
        switch.hit(kind, op=op, key=key)


def arm_from_env() -> KillSwitch | None:
    """Install a kill switch from ``BODYWORK_TPU_CRASH_SCHEDULE`` (how a
    crash harness arms a child runner). A malformed schedule RAISES — a
    crash test must never pass vacuously against a typo."""
    raw = os.environ.get(ENV_SCHEDULE, "").strip()
    if not raw:
        return None
    switch = KillSwitch(raw, action="exit")
    install(switch)
    log.warning(f"crash kill switch armed from env: {raw}")
    return switch


class KillSwitchStore(DelegatingStore):
    """Transparent wrapper feeding every counted store primitive through
    the active kill switch BEFORE delegating (a fired point leaves the
    op un-executed — death mid-stage with the artefact unwritten)."""

    def _hit(self, op: str, key: str) -> None:
        hit_kill_point("store_op", op=op, key=key)

    def put_bytes(self, key: str, data: bytes) -> None:
        self._hit("put_bytes", key)
        self._inner.put_bytes(key, data)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        self._hit("put_bytes_if_match", key)
        return self._inner.put_bytes_if_match(key, data, expected_token)

    def get_bytes(self, key: str) -> bytes:
        self._hit("get_bytes", key)
        return self._inner.get_bytes(key)

    def list_keys(self, prefix: str = "") -> list[str]:
        self._hit("list_keys", prefix)
        return self._inner.list_keys(prefix)

    def delete(self, key: str) -> None:
        self._hit("delete", key)
        self._inner.delete(key)

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        if keys:
            self._hit("get_many", keys[0])
        return self._inner.get_many(keys)


def wrap_store(store: ArtefactStore) -> ArtefactStore:
    """Wrap ``store`` with the kill-switch counter when a switch is
    armed; otherwise return it untouched (the common path)."""
    if _ACTIVE is None:
        return store
    return KillSwitchStore(store)
