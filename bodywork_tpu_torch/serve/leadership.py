"""CAS-leased dispatcher leadership: warm-standby failover (the port of
``bodywork_tpu.serve.leadership``; the same lease document, fences and
metrics, byte for byte).

The disaggregated split puts every request behind exactly ONE
device-owning dispatcher: when it dies, every request is a 503 until the
supervisor respawns it. This module turns that blackout into a bounded
blip: one or more WARM standby dispatchers — predictor loaded, every
bucket's CUDA graph captured, zero captures left to pay at takeover —
watch a lease document on the artefact store and take over the moment
the active leader's lease expires.

The lease is the run journal's construction applied to the serving
plane: an ``(owner, expires_at, fence)`` document at
``serve/dispatcher-leader.json`` (:func:`~bodywork_tpu_torch.store.schema.
dispatcher_leader_key`), mutated EXCLUSIVELY through the store's
compare-and-swap primitive (``put_bytes_if_match``). The active leader
renews it every :attr:`LeaderElection.renew_interval_s`; a standby
finding the lease expired takes over by bumping the fence. Split-brain
is impossible by the same argument the journal makes:

- at most one writer ever holds a given fence (CAS arbitration picks
  exactly one winner per takeover);
- a fenced-out ex-leader's next renew CAS fails against the bumped
  document and raises :class:`LeadershipLost` — it stops serving and
  exits (the supervisor respawns it as a fresh standby candidate);
- the fence rides the netqueue HELLO (``serve.netqueue``), so a client
  that has seen fence N refuses any dispatcher offering fence < N at
  the handshake — a zombie ex-leader that has not yet noticed its lost
  lease can be CONNECTED to but never TRUSTED.

Blackout bound: a dead leader's lease blocks takeover for at most
``ttl_s``; the local supervisor shortens even that by CAS-expiring the
lease of a dispatcher it has OBSERVED dead (:meth:`DispatcherLease.
expire_dead_owner` — safe precisely because the observation is of a
dead process, not a partition). Client-observed blackout is therefore
bounded by lease TTL + one reconnect backoff.

Steady-state cost: leadership is exactly one CAS renew per renew
interval and ZERO raw puts (a CountingStore test pins this) — the
store never sees an unconditional write from this module.

Metrics: ``bodywork_tpu_serve_leader_state`` (1 leading / 0 standby)
and ``bodywork_tpu_serve_leader_takeovers_total{reason}``
(``fresh`` / ``expired`` / ``released``).

Deliberately torch-free: elections run before (and independently of) any
accelerator work, and tests drive them with injected clocks.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid

from bodywork_tpu_torch.store.base import ArtefactNotFound, CasConflict
from bodywork_tpu_torch.store.schema import dispatcher_leader_key
from bodywork_tpu_torch.utils.logging import get_logger
from bodywork_tpu_torch.utils.retry import full_jitter_delay

log = get_logger("serve.leadership")

__all__ = [
    "DEFAULT_LEADER_TTL_S",
    "LEADER_SCHEMA",
    "DispatcherLease",
    "LeaderElection",
    "LeadershipLost",
    "leader_owner",
    "leader_ttl_from_env",
]

LEADER_SCHEMA = "bodywork_tpu.dispatcher_leader/1"

#: default leader-lease time-to-live. Much shorter than the run
#: journal's 900 s: a run lease guards a DAG step (minutes), this one
#: bounds the serving BLACKOUT a dead leader can cause — it must be
#: renewable cheaply (one CAS) and expirable fast. Env
#: ``BODYWORK_TPU_LEADER_TTL_S`` overrides; size it well above the
#: renew interval (ttl/3) plus your store's worst-case CAS latency.
DEFAULT_LEADER_TTL_S = 5.0

#: renew cadence as a fraction of the TTL: two missed renews still
#: leave slack before expiry, so one slow CAS never costs leadership
RENEW_FRACTION = 1.0 / 3.0

#: standby election poll backoff bounds — drawn through the shared
#: full-jitter helper (utils.retry), so N standbys watching one lease
#: decorrelate exactly like N reconnecting front-ends do
ELECTION_POLL_BASE_S = 0.05
ELECTION_POLL_MAX_S = 1.0

#: CAS attempts per lease write before conceding the race is real
_CAS_ATTEMPTS = 4


class LeadershipLost(RuntimeError):
    """This process's leadership is gone — another dispatcher holds (or
    took over) the lease. The loser must stop serving immediately and
    exit; its supervisor respawns it as a fresh standby candidate."""


def leader_owner() -> str:
    """Identity unique per dispatcher process: ``host:pid:nonce`` (the
    journal's owner shape — the supervisor parses host+pid back out to
    expire the lease of a dispatcher it observed die)."""
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"


def leader_ttl_from_env(default: float = DEFAULT_LEADER_TTL_S) -> float:
    from bodywork_tpu_torch.utils.env import positive_float_env

    return positive_float_env("BODYWORK_TPU_LEADER_TTL_S", default)


def _count_takeover(reason: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_serve_leader_takeovers_total",
        "Dispatcher leadership acquisitions by reason (fresh: no prior "
        "lease; expired: took over a dead leader's expired lease; "
        "released: prior leader released cleanly)",
    ).inc(reason=reason)


def _leader_state_gauge():
    from bodywork_tpu_torch.obs import get_registry

    return get_registry().gauge(
        "bodywork_tpu_serve_leader_state",
        "Dispatcher leadership role of this process: 1 = active "
        "leader, 0 = warm standby (docs/RESILIENCE.md failover runbook)",
    )


class DispatcherLease:
    """The lease document protocol: CAS reads/writes of
    ``serve/dispatcher-leader.json``, no threads, injectable clock —
    the unit-testable core :class:`LeaderElection` drives.

    Every mutation follows the journal-reader discipline: version token
    read BEFORE payload, conditional write against it, conflict →
    re-read and re-decide. A corrupt document is repaired by the next
    acquire's CAS overwrite (its token is kept), never blindly."""

    def __init__(self, store, owner: str | None = None,
                 ttl_s: float | None = None,
                 address: str | None = None,
                 clock=time.time):
        self.store = store
        self.key = dispatcher_leader_key()
        self.owner = owner or leader_owner()
        self.ttl_s = ttl_s if ttl_s is not None else leader_ttl_from_env()
        #: the listener address the leader publishes (operator-facing:
        #: `cat serve/dispatcher-leader.json` names who is serving where)
        self.address = address
        self.clock = clock
        self.fence = 0
        self._token = None

    # -- reads -------------------------------------------------------------
    def _load(self):
        """``(doc_or_None, version_token)`` — token first, so a CAS
        against it can only win if nothing changed since the read. A
        present-but-corrupt document reads as ``(None, token)``: the
        next acquire CAS-repairs it in place."""
        token = self.store.version_token(self.key)
        try:
            raw = self.store.get_bytes(self.key)
        except ArtefactNotFound:
            return None, None
        try:
            doc = json.loads(raw.decode("utf-8"))
            if isinstance(doc, dict) and doc.get("schema") == LEADER_SCHEMA:
                return doc, token
        except (UnicodeDecodeError, ValueError):
            pass
        log.warning(f"corrupt dispatcher-leader doc at {self.key!r}; "
                    "the next acquire CAS-repairs it")
        return None, token

    def peek(self) -> dict | None:
        """The current lease document (or None) — read-only, for
        introspection (supervisor leader resolution, healthz)."""
        doc, _token = self._load()
        return doc

    def _live_foreign(self, doc: dict | None) -> dict | None:
        if not doc:
            return None
        if (
            doc.get("owner")
            and doc["owner"] != self.owner
            and doc.get("expires_at", 0) > self.clock()
        ):
            return doc
        return None

    def _block(self, fence: int) -> bytes:
        return json.dumps({
            "schema": LEADER_SCHEMA,
            "owner": self.owner,
            "expires_at": self.clock() + self.ttl_s,
            "fence": fence,
            "address": self.address,
        }, sort_keys=True).encode("utf-8")

    # -- the lease protocol ------------------------------------------------
    def try_acquire(self) -> int | None:
        """One acquisition attempt: returns the new fence on success,
        None while a live foreign lease blocks us. CAS races re-read
        and re-decide, bounded by ``_CAS_ATTEMPTS``."""
        for _attempt in range(_CAS_ATTEMPTS):
            doc, token = self._load()
            holder = self._live_foreign(doc)
            if holder is not None:
                return None
            prior_fence = int((doc or {}).get("fence", 0))
            prior_owner = (doc or {}).get("owner")
            fence = prior_fence + 1
            try:
                self._token = self.store.put_bytes_if_match(
                    self.key, self._block(fence), token
                )
            except CasConflict:
                continue  # someone raced this takeover: re-decide
            self.fence = fence
            if doc is None:
                reason = "fresh"
            elif prior_owner and prior_owner != self.owner:
                reason = "expired"
            else:
                reason = "released"
            _count_takeover(reason)
            log.info(
                f"dispatcher leadership acquired (fence {fence}, "
                f"reason {reason}, owner {self.owner})"
            )
            return fence
        return None

    def renew(self) -> None:
        """Extend the held lease by ``ttl_s`` — ONE conditional write
        in the steady state. A conflict whose re-read shows any other
        writer raises :class:`LeadershipLost`: our exclusivity is gone
        the moment someone else touched the document."""
        assert self.fence > 0, "acquire before renewing"
        try:
            self._token = self.store.put_bytes_if_match(
                self.key, self._block(self.fence), self._token
            )
            return
        except CasConflict:
            pass
        doc, token = self._load()
        if doc is not None and doc.get("owner") == self.owner and (
            int(doc.get("fence", 0)) == self.fence
        ):
            # our own write raced a token refresh (e.g. a repair read):
            # re-anchor and renew against the fresh token
            try:
                self._token = self.store.put_bytes_if_match(
                    self.key, self._block(self.fence), token
                )
                return
            except CasConflict:
                pass
        raise LeadershipLost(
            f"dispatcher lease (fence {self.fence}) was taken over; "
            "stopping"
        )

    def release(self) -> None:
        """Clear ownership, KEEPING the fence (the next leader still
        bumps past us). Best-effort: a conflict means someone already
        took over, which is the same outcome."""
        if self.fence <= 0:
            return
        try:
            self._token = self.store.put_bytes_if_match(
                self.key,
                json.dumps({
                    "schema": LEADER_SCHEMA,
                    "owner": None,
                    "expires_at": 0.0,
                    "fence": self.fence,
                    "address": None,
                }, sort_keys=True).encode("utf-8"),
                self._token,
            )
        except Exception:
            pass

    def expire_dead_owner(self, host: str, pid: int) -> bool:
        """Supervisor hook: CAS-expire the lease of an owner OBSERVED
        dead (host+pid parsed back out of the journal-shaped owner
        string), so the standby takes over on its next poll instead of
        waiting out the TTL. Safe by construction — the caller holds
        evidence of a dead process, not a partition guess. Fence is
        KEPT: the takeover still bumps it."""
        doc, token = self._load()
        owner = (doc or {}).get("owner") or ""
        parts = owner.rsplit(":", 2)
        if len(parts) != 3 or parts[0] != host:
            return False
        try:
            if int(parts[1]) != pid:
                return False
        except ValueError:
            return False
        expired = dict(doc)
        expired["expires_at"] = 0.0
        try:
            self.store.put_bytes_if_match(
                self.key,
                json.dumps(expired, sort_keys=True).encode("utf-8"),
                token,
            )
            log.warning(
                f"expired the dispatcher lease of dead owner {owner!r} "
                "(first death observation)"
            )
            return True
        except CasConflict:
            return False  # someone else already moved the document


class LeaderElection:
    """The dispatcher-side driver over :class:`DispatcherLease`: a
    blocking campaign, a renew heartbeat, and the ``on_lost`` unwind.

    Lifecycle (``serve.dispatch.dispatcher_main``)::

        election = LeaderElection(store, address=..., on_lost=stop_fn)
        fence = election.campaign()        # WARM standby blocks here
        ... bind the listener with `fence` in its HELLO, serve ...
        election.start_renewer()           # heartbeat thread
        ...
        election.stop()                    # teardown: release + join

    ``on_lost`` fires (once, from the renewer thread) when a renew
    discovers the lease was taken over — the dispatcher must stop
    serving and let its process exit; a fenced-out zombie that keeps
    its listener bound is refused by every client at the HELLO anyway.
    """

    def __init__(self, store, owner: str | None = None,
                 ttl_s: float | None = None,
                 renew_interval_s: float | None = None,
                 address: str | None = None,
                 on_lost=None,
                 clock=time.time,
                 sleep=time.sleep):
        self.lease = DispatcherLease(
            store, owner=owner, ttl_s=ttl_s, address=address, clock=clock
        )
        self.renew_interval_s = (
            renew_interval_s if renew_interval_s is not None
            else self.lease.ttl_s * RENEW_FRACTION
        )
        self.on_lost = on_lost
        self.clock = clock
        self._sleep = sleep
        self._last_renew: float | None = None
        self._won_at: float | None = None
        self.takeovers = 0
        self._stopping = threading.Event()
        self._renewer: threading.Thread | None = None
        self._gauge = _leader_state_gauge()
        self._gauge.set(0.0)

    @property
    def fence(self) -> int:
        return self.lease.fence

    @property
    def leading(self) -> bool:
        return self._won_at is not None and not self._stopping.is_set()

    # -- election ----------------------------------------------------------
    def campaign(self, stop: threading.Event | None = None) -> int | None:
        """Block until leadership is acquired (returns the fence) or
        ``stop`` fires (returns None). The poll sleeps through the
        shared full-jitter backoff — N standbys watching one lease
        must not stampede the store (or the CAS) in lockstep."""
        stop = stop or self._stopping
        attempt = 0
        while not stop.is_set():
            fence = self.lease.try_acquire()
            if fence is not None:
                self._won_at = self.clock()
                self._last_renew = self._won_at
                self.takeovers += 1
                self._gauge.set(1.0)
                return fence
            self._sleep(full_jitter_delay(
                attempt, ELECTION_POLL_BASE_S, ELECTION_POLL_MAX_S
            ))
            attempt += 1
        return None

    # -- heartbeat ---------------------------------------------------------
    def maybe_renew(self, now: float | None = None) -> bool:
        """Renew iff a renew interval has elapsed — the unit-testable
        heartbeat step (the CountingStore pin drives THIS with a fake
        clock: one CAS per elapsed interval, zero raw puts). Returns
        True when a renew happened. Raises :class:`LeadershipLost`
        through from the lease."""
        now = self.clock() if now is None else now
        if self._last_renew is not None and (
            now - self._last_renew < self.renew_interval_s
        ):
            return False
        self.lease.renew()
        self._last_renew = now
        return True

    def start_renewer(self) -> "LeaderElection":
        assert self.leading, "campaign() before start_renewer()"
        self._renewer = threading.Thread(
            target=self._renew_loop, name="leader-renewer", daemon=True
        )
        self._renewer.start()
        return self

    def _renew_loop(self) -> None:
        # wake a few times per interval so a stop() is honoured fast,
        # but WRITE only once per interval (maybe_renew gates the CAS)
        tick = max(0.01, self.renew_interval_s / 4.0)
        while not self._stopping.wait(tick):
            try:
                self.maybe_renew()
            except LeadershipLost as exc:
                log.error(f"dispatcher leadership lost: {exc}")
                self._gauge.set(0.0)
                self._won_at = None
                if self.on_lost is not None:
                    try:
                        self.on_lost()
                    except Exception as cb_exc:  # must not kill the thread
                        log.error(f"on_lost callback failed: {cb_exc!r}")
                return
            except Exception as exc:
                # a transient store error must not abdicate leadership:
                # the lease has ttl - renew_interval of slack, and the
                # next tick retries (classify/backoff is the store
                # stack's job, not the heartbeat's)
                log.warning(f"leader renew attempt failed: {exc!r}")

    # -- introspection / teardown ------------------------------------------
    def state(self) -> dict:
        """The dispatcher-side leadership block (mirrors the client-side
        one the front-ends serve on /healthz)."""
        now = self.clock()
        return {
            "role": "active" if self.leading else "standby",
            "fence": self.lease.fence,
            "lease_age_s": (
                round(now - self._won_at, 3)
                if self._won_at is not None else None
            ),
            "takeovers_observed": self.takeovers,
        }

    def stop(self) -> None:
        self._stopping.set()
        if self._renewer is not None and self._renewer.ident is not None:
            self._renewer.join(timeout=5)
        if self._won_at is not None:
            self.lease.release()
            self._won_at = None
        self._gauge.set(0.0)
