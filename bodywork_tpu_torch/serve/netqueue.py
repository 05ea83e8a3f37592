"""Socket transport for the front-end -> dispatcher row queue (the port
of ``bodywork_tpu.serve.netqueue``: the same frames, HELLO, credit window,
fence and reconnect policy, byte for byte).

The shared-memory row queue (``serve.rowqueue``) chains every front-end
to the dispatcher's host: slots, rings, and liveness words all live in
one ``multiprocessing`` arena. This module is the same producer/consumer
contract over a byte stream — TCP or a Unix domain socket — so the
torch-free front-ends can run on OTHER hosts/pods than the device-owning
dispatcher (the k8s split in ``pipeline/k8s.py`` runs each role as its
own Deployment).

Wire protocol (all little-endian, one persistent connection per
front-end process):

- every frame is ``u32 length | u8 type | payload`` (length covers type
  + payload);
- ``HELLO`` (server -> client, once per connection) carries the
  ``serve.wire`` schema version, the per-connection credit window, and
  the binary content type string — a client from a different build
  refuses the connection instead of misparsing rows;
- ``SUBMIT`` (client -> server) is ``u64 request id | u8 kind |
  u16 trace-id length | trace id | rows`` where ``rows`` is EXACTLY the
  ``application/x-bodywork-rows`` framing (``wire.encode_binary_rows``:
  ``u32 n_rows, u32 n_features`` + f32 row data) — the request framing
  that already crosses HTTP is the one that crosses the queue;
- ``REPLY`` (server -> client) is ``u64 request id | u16 status |
  u32 n | n f32 predictions | u32 length | bundle-identity JSON`` (the
  same ``[model_key, model_info, model_date]`` triple the shm reply
  region carries, so the front-end splices byte-identical responses).

Frames pipeline: the client keeps submitting while replies are in
flight, and the reader thread demuxes replies by request id — one
connection, no per-request round-trip serialization.

**Credits are the slot budget.** The HELLO window mirrors the shm
transport's slot pool: a submit past the window raises
:class:`~bodywork_tpu_torch.serve.rowqueue.SlotsExhausted` synchronously,
exactly as an empty slot free-list does, so admission/shed semantics
(shed-before-parse upstream, 429 + Retry-After here) are byte-identical
across transports. Credits also make "slow dispatcher" and "dead
network" distinguishable: a slow dispatcher consumes the window (credits
pinned at 0, connection healthy — scale the dispatcher); a partition or
death breaks the connection (credits irrelevant, ``connected`` false —
reconnect/respawn).

**Failure semantics extend the shm transport's** with safe
in-flight RESUBMISSION: a broken dispatcher connection no
longer fails in-flight waits immediately — the client HOLDS each
pending request's encoded SUBMIT frame, reconnects with the shared
full-jitter backoff (``utils.retry.full_jitter_delay``), and resends
the held frames verbatim over the new connection. Scoring is a pure
function of the rows, so duplicate dispatch is safe: if the old
dispatcher also replied, the late reply demuxes to an already-popped
request id and is inert; the response the waiter sees is byte-identical
either way. Only past ``failover_deadline_s`` of continuous disconnect
do the waits fail into
:class:`~bodywork_tpu_torch.serve.rowqueue.DispatcherUnavailable` (503 +
Retry-After at the HTTP layer) — a dispatcher FAILOVER (warm standby
takes over within the lease TTL, ``serve.leadership``) heals under the
deadline and the client never sheds at all. NEW submissions while
disconnected still shed synchronously, as before.

**The leadership fence rides the HELLO** (``u64`` after the credit
window): clients track the highest fence ever seen and refuse — at the
handshake, before any row could be misparsed — a dispatcher offering a
LOWER fence: that is a zombie ex-leader that has not yet noticed its
lost lease. A fence of 0 means no election is running (the singleton
dispatcher topologies), and the check never fires.

A dropped front-end connection still reclaims its in-flight budget
server-side (the socket analogue of the dead-front-end slot reclaim):
queued submissions from the dead connection are skipped at poll, and
replies to it are dropped instead of erroring the dispatcher. Resubmits
stay within the credit window by construction (the client never held
more than the window), provided the standby serves the same window —
both sides default to ``DEFAULT_SLOTS``.

Dependency note: this module is deliberately torch-free (numpy + stdlib
sockets) — it rides the front-end processes, which must never pay the
accelerator import.
"""
from __future__ import annotations

import json
import os
import queue as queue_mod
import socket
import struct
import threading
import time

import numpy as np

from bodywork_tpu_torch.serve.rowqueue import (
    DEFAULT_SLOTS,
    KIND_SINGLE,
    DispatcherUnavailable,
    SlotsExhausted,
    _Reply,
)
from bodywork_tpu_torch.serve.wire import (
    BINARY_CONTENT_TYPE,
    WIRE_SCHEMA_VERSION,
    encode_binary_rows,
    parse_binary_rows,
)
from bodywork_tpu_torch.utils.logging import get_logger
from bodywork_tpu_torch.utils.retry import full_jitter_delay

log = get_logger("serve.netqueue")

__all__ = [
    "DEFAULT_DISPATCHER_PORT",
    "DEFAULT_FAILOVER_DEADLINE_S",
    "SERVE_ROLES",
    "SERVE_TRANSPORTS",
    "NetQueueClient",
    "NetQueueServer",
    "parse_dispatcher_addr",
]

#: the row-queue transports `cli serve --transport` selects. "shm" is
#: the shared-memory queue (one host); "tcp"/"unix" are this module.
#: Pinned == the cli choices == the stages env-knob parser by a guard
#: test (tests/test_torch_netqueue.py).
SERVE_TRANSPORTS = ("shm", "tcp", "unix")

#: the serve roles of the cross-host split: "auto" runs both halves
#: locally (the one-host topology, any transport), "frontend"/"dispatcher"
#: run ONE half against a remote peer — what the split k8s Deployments
#: set (pipeline/k8s.py). Pinned like SERVE_TRANSPORTS.
SERVE_ROLES = ("auto", "frontend", "dispatcher")

#: the dispatcher Service port the k8s split wires front-ends at
DEFAULT_DISPATCHER_PORT = 9091

#: reconnect backoff (client side): exponential with full jitter —
#: drawn through utils.retry.full_jitter_delay, the ONE backoff policy
#: every transport/store loop shares — so N front-ends orphaned by one
#: dispatcher death do not reconnect in lockstep
RECONNECT_BASE_S = 0.2
RECONNECT_MAX_S = 5.0

#: how long a disconnected client HOLDS in-flight requests for
#: resubmission before failing them into 503s: sized above the default
#: leadership TTL + one maximal reconnect backoff, so a warm-standby
#: failover completes under it, and WELL below the front-end's 60 s
#: rendezvous timeout, so nothing ever wedges
DEFAULT_FAILOVER_DEADLINE_S = 15.0

_FRAME_HEADER = struct.Struct("<IB")   # length, msg type
#: wire schema version, credits, leadership fence (0 = no election)
_HELLO_BODY = struct.Struct("<HIQ")
_SUBMIT_HEADER = struct.Struct("<QBH")  # req id, kind, trace length
_REPLY_HEADER = struct.Struct("<QHI")  # req id, status, n predictions

_MSG_HELLO = 1
_MSG_SUBMIT = 2
_MSG_REPLY = 3

#: a frame larger than this is a protocol violation, not a big request
#: (the slot-stride bound already caps legitimate rows far below it)
_MAX_FRAME = 64 * 1024 * 1024


def parse_dispatcher_addr(transport: str, addr: str | None):
    """Normalise a ``--dispatcher-addr`` value for ``transport``:
    ``("tcp", host, port)`` or ``("unix", path)``. tcp wants
    ``host:port`` (bare ``:port`` binds/targets localhost); unix wants a
    filesystem path. Raises ``ValueError`` on a malformed value — the
    CLI surfaces it; the stage env parser degrades instead."""
    if transport not in ("tcp", "unix"):
        raise ValueError(
            f"no dispatcher address for transport {transport!r}"
        )
    if not addr:
        raise ValueError(
            f"transport {transport!r} needs a dispatcher address"
        )
    if transport == "unix":
        return ("unix", addr)
    host, sep, port = addr.rpartition(":")
    if not sep:
        raise ValueError(
            f"tcp dispatcher address must be host:port, got {addr!r}"
        )
    return ("tcp", host or "127.0.0.1", int(port))


def _connect(address, timeout_s: float):
    if address[0] == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout_s)
        sock.connect(address[1])
    else:
        sock = socket.create_connection(
            (address[1], address[2]), timeout=timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF."""
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed the row-queue connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_frame(sock) -> tuple[int, bytes]:
    length, msg_type = _FRAME_HEADER.unpack(
        _recv_exact(sock, _FRAME_HEADER.size)
    )
    if not 1 <= length <= _MAX_FRAME:
        raise ConnectionError(f"bad frame length {length}")
    return msg_type, _recv_exact(sock, length - 1)


def _frame(msg_type: int, payload: bytes) -> bytes:
    return _FRAME_HEADER.pack(len(payload) + 1, msg_type) + payload


def _shutdown_close(sock) -> None:
    """``shutdown()`` then ``close()``. Plain ``close()`` on a socket
    another thread is blocked ``recv()``-ing (or ``accept()``-ing) does
    NOT wake that thread on Linux — the kernel holds the socket open
    under the in-flight syscall, no FIN reaches the peer, and both ends
    hang forever. ``shutdown(SHUT_RDWR)`` tears the connection down
    immediately: the blocked reader returns EOF and the peer sees the
    close."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # already disconnected / never connected
    try:
        sock.close()
    except OSError:
        pass


class _PendingEntry:
    """One in-flight request: its completion callback, submit clock,
    and — for failover resubmission — the encoded SUBMIT frame (resent
    VERBATIM over a re-established connection, so the standby scores
    the exact bytes the dead leader held) and its row count."""

    __slots__ = ("on_done", "submitted_at", "frame", "n_rows")

    def __init__(self, on_done, submitted_at, frame, n_rows):
        self.on_done = on_done
        self.submitted_at = submitted_at
        self.frame = frame
        self.n_rows = n_rows


class NetQueueClient:
    """The front-end side of the socket row queue — the same surface as
    :class:`~bodywork_tpu_torch.serve.rowqueue.RowQueueClient` (``submit`` /
    ``start`` / ``stop`` / ``stats`` / ``dispatcher_up``), so
    ``frontend.py`` and ``serve.aio`` run unchanged over either
    transport. One persistent connection, a reader thread demuxing
    replies by request id, a jittered-backoff reconnect loop, and
    failover resubmission of held in-flight frames (module docstring)."""

    def __init__(self, address, frontend_id: int = 0,
                 connect_timeout_s: float = 5.0,
                 reconnect_base_s: float = RECONNECT_BASE_S,
                 reconnect_max_s: float = RECONNECT_MAX_S,
                 failover_deadline_s: float = DEFAULT_FAILOVER_DEADLINE_S):
        self.address = address
        self.frontend_id = frontend_id
        self.connect_timeout_s = connect_timeout_s
        self.reconnect_base_s = reconnect_base_s
        self.reconnect_max_s = reconnect_max_s
        self.failover_deadline_s = failover_deadline_s
        self._lock = threading.Lock()
        self._wlock = threading.Lock()
        self._sock: socket.socket | None = None
        self._connected = False
        self._stopped = False
        self._next_id = 0
        #: req_id -> _PendingEntry (held across disconnects until the
        #: failover deadline — the resubmission set)
        self._pending: dict[int, _PendingEntry] = {}
        #: monotonic instant the connection carrying in-flight requests
        #: broke; None while connected (or nothing is held)
        self._disconnected_at: float | None = None
        #: per-connection credit window granted by the server's HELLO;
        #: 0 until connected (every submit then sheds as unavailable)
        self.credit_window = 0
        self.reconnects = 0
        #: highest leadership fence any HELLO carried; a dispatcher
        #: offering less is a zombie ex-leader, refused at handshake
        self.fence_seen = 0
        #: fence INCREASES observed (each one is a completed failover)
        self.takeovers_observed = 0
        self._leader_since: float | None = None
        # same accounting surface as RowQueueClient (healthz reads it)
        self.rows_submitted = 0
        self.requests_submitted = 0
        self.replies_received = 0
        self.failures = 0
        from bodywork_tpu_torch.obs import get_registry

        reg = get_registry()
        self._m_rows = reg.counter(
            "bodywork_tpu_rowqueue_rows_total",
            "Feature rows handed to the dispatcher over the shared "
            "row-queue, by front-end role",
        )
        self._m_wait = reg.histogram(
            "bodywork_tpu_rowqueue_wait_seconds",
            "Front-end submit -> dispatcher reply, whole round trip",
        )
        self._m_reconnects = reg.counter(
            "bodywork_tpu_netqueue_reconnects_total",
            "Socket row-queue connections re-established after a "
            "dispatcher death or network failure",
        )
        self._m_rtt = reg.histogram(
            "bodywork_tpu_netqueue_rtt_seconds",
            "Submit -> reply round trip over the SOCKET row-queue "
            "transport (the cross-host analogue of the shm handoff "
            "histogram; includes dispatcher service time)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1, 0.5, 2.0),
        )
        self._m_resubmitted = reg.counter(
            "bodywork_tpu_netqueue_resubmitted_rows_total",
            "In-flight feature rows resent verbatim over a "
            "re-established row-queue connection after a dispatcher "
            "failover (scoring is pure, so duplicate dispatch is safe "
            "and replies stay byte-identical)",
        )
        self._m_credits = reg.gauge(
            "bodywork_tpu_netqueue_credits_in_flight",
            "Transport credits consumed (submitted, not yet replied) on "
            "the socket row-queue connection; pinned at the window with "
            "a healthy connection = slow dispatcher, not a partition",
        )
        # the occupancy signal the HPA runbook keys on, exported from
        # the FRONT-END side here: in the cross-host split the
        # dispatcher's own gauge is scraped from another pod, and
        # credits-consumed / window IS this transport's slot occupancy
        self._m_occupancy = reg.gauge(
            "bodywork_tpu_rowqueue_occupancy_ratio",
            "Allocated row slots / slot pool size (1.0 = the queue, not "
            "admission, is the backpressure boundary)",
        )
        self._manager = threading.Thread(
            target=self._connection_loop,
            name=f"netqueue-client-{frontend_id}", daemon=True,
        )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "NetQueueClient":
        self._manager.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        self._teardown_socket()
        self._fail_pending(DispatcherUnavailable("front-end shutting down"))
        if self._manager.ident is not None:
            self._manager.join(timeout=5)

    def dispatcher_up(self) -> bool:
        return self._connected

    # -- submit path ---------------------------------------------------------
    def submit(self, X, kind: int, on_done,
               trace_id: str | None = None) -> None:
        """Same contract as ``RowQueueClient.submit``: raises
        :class:`DispatcherUnavailable` / :class:`SlotsExhausted`
        synchronously when nothing was sent; otherwise ``on_done`` fires
        on the reader thread with a reply object or an exception."""
        if self._stopped or not self._connected:
            raise DispatcherUnavailable("scoring dispatcher is not available")
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 0:
            X = X[None]
        rows = encode_binary_rows(X)
        n_rows = int(X.shape[0])
        trace = (trace_id or "").encode("ascii", "replace")[:255]
        with self._lock:
            if len(self._pending) >= self.credit_window:
                # the socket analogue of an empty slot free-list: the
                # window mirrors the shm slot budget, so shedding kicks
                # in at the same boundary on either transport
                raise SlotsExhausted("no free row-queue transport credit")
            req_id = self._next_id
            self._next_id += 1
            payload = (
                _SUBMIT_HEADER.pack(req_id, kind, len(trace)) + trace + rows
            )
            frame = _frame(_MSG_SUBMIT, payload)
            self._pending[req_id] = _PendingEntry(
                on_done, time.monotonic(), frame, n_rows
            )
            self.requests_submitted += 1
            self.rows_submitted += n_rows
            self._m_credits.set(float(len(self._pending)))
            if self.credit_window:
                self._m_occupancy.set(
                    len(self._pending) / self.credit_window
                )
        try:
            with self._wlock:
                sock = self._sock
                if sock is None:
                    raise ConnectionError("not connected")
                sock.sendall(frame)
        except (OSError, ConnectionError) as exc:
            # nothing (whole) reached the dispatcher: unwind the credit
            # and raise synchronously, exactly as a failed enqueue would
            with self._lock:
                if self._pending.pop(req_id, None) is not None:
                    self.requests_submitted -= 1
                    self.rows_submitted -= n_rows
                self._m_credits.set(float(len(self._pending)))
            self._teardown_socket()
            raise DispatcherUnavailable(
                f"scoring dispatcher connection lost: {exc}"
            ) from exc
        self._m_rows.inc(n_rows)

    # -- connection manager / reader -----------------------------------------
    def _connection_loop(self) -> None:
        streak = 0
        first = True
        while not self._stopped:
            self._expire_held()
            try:
                sock = _connect(self.address, self.connect_timeout_s)
            except OSError:
                streak += 1
                self._backoff(streak)
                continue
            try:
                self._handshake(sock)
            except (OSError, ConnectionError, ValueError) as exc:
                log.warning(f"netqueue handshake failed: {exc}")
                sock.close()
                streak += 1
                self._backoff(streak)
                continue
            if not first:
                self.reconnects += 1
                self._m_reconnects.inc()
                log.info(
                    f"netqueue reconnected to the dispatcher "
                    f"(reconnect {self.reconnects})"
                )
            first = False
            streak = 0
            try:
                # resend the held in-flight frames BEFORE the submit
                # path can see the connection: the new dispatcher scores
                # the exact bytes the dead one held (pure function -> a
                # duplicate reply racing in is popped-empty and inert)
                self._resubmit_held(sock)
            except (OSError, ConnectionError) as exc:
                if not self._stopped:
                    log.warning(f"netqueue resubmission failed: {exc}")
                _shutdown_close(sock)
                streak += 1
                self._backoff(streak)
                continue
            self._sock = sock
            self._connected = True
            try:
                self._read_replies(sock)
            except (OSError, ConnectionError) as exc:
                if not self._stopped:
                    log.warning(f"netqueue connection lost: {exc}")
            finally:
                self._teardown_socket()
                # in-flight waits are NOT failed here (unlike the shm
                # transport): they are HELD for resubmission — a standby
                # takeover heals them under the failover deadline, and
                # only _expire_held turns them into 503s
                with self._lock:
                    if self._pending and self._disconnected_at is None:
                        self._disconnected_at = time.monotonic()
            streak += 1
            self._backoff(streak)

    def _backoff(self, streak: int) -> None:
        if self._stopped:
            return
        # full jitter via the ONE shared policy (utils.retry): N
        # orphaned front-ends spread over [0, cap] rather than
        # stampeding the respawned/elected dispatcher in lockstep
        time.sleep(full_jitter_delay(
            max(0, streak - 1), self.reconnect_base_s, self.reconnect_max_s
        ))

    def _expire_held(self) -> None:
        """Fail the held in-flight requests once a disconnect has
        outlived the failover deadline — the ONLY place (besides stop)
        that turns a disconnect into DispatcherUnavailable waits."""
        with self._lock:
            expired = (
                self._disconnected_at is not None
                and time.monotonic() - self._disconnected_at
                >= self.failover_deadline_s
            )
            if expired:
                self._disconnected_at = None
        if expired:
            self._fail_pending(DispatcherUnavailable(
                f"scoring dispatcher did not fail over within "
                f"{self.failover_deadline_s:.1f}s"
            ))

    def _resubmit_held(self, sock) -> None:
        """Resend every held frame, in submit order, over the fresh
        connection. Raises the connection errors to the caller, which
        treats them exactly like a lost connection."""
        with self._lock:
            entries = [e for _id, e in sorted(self._pending.items())]
            self._disconnected_at = None
        if not entries:
            return
        rows = 0
        for entry in entries:
            sock.sendall(entry.frame)
            rows += entry.n_rows
        self._m_resubmitted.inc(rows)
        log.info(
            f"resubmitted {len(entries)} in-flight request(s) "
            f"({rows} rows) over the re-established connection"
        )

    def _handshake(self, sock) -> None:
        msg_type, body = _recv_frame(sock)
        if msg_type != _MSG_HELLO:
            raise ValueError(f"expected HELLO, got frame type {msg_type}")
        if len(body) < _HELLO_BODY.size:
            raise ValueError(f"short HELLO body ({len(body)} bytes)")
        version, credits, fence = _HELLO_BODY.unpack_from(body)
        content_type = body[_HELLO_BODY.size:].decode("ascii")
        if version != WIRE_SCHEMA_VERSION or (
            content_type != BINARY_CONTENT_TYPE
        ):
            # a peer from another build: refuse rather than misparse
            raise ValueError(
                f"wire schema mismatch: dispatcher speaks v{version} "
                f"({content_type!r}), this build v{WIRE_SCHEMA_VERSION} "
                f"({BINARY_CONTENT_TYPE!r})"
            )
        if fence < self.fence_seen:
            # a zombie ex-leader still listening after losing its
            # lease: refuse at the handshake, never misparse mid-stream
            raise ValueError(
                f"stale dispatcher fence {fence} < {self.fence_seen} "
                "already seen (zombie ex-leader refused)"
            )
        if fence > self.fence_seen:
            if self.fence_seen:
                # a fence INCREASE is a completed failover we lived
                # through (the first fence is just discovery)
                self.takeovers_observed += 1
            self.fence_seen = int(fence)
            self._leader_since = time.monotonic()
        elif self._leader_since is None:
            self._leader_since = time.monotonic()
        self.credit_window = int(credits)

    def _read_replies(self, sock) -> None:
        while not self._stopped:
            msg_type, body = _recv_frame(sock)
            if msg_type != _MSG_REPLY:
                raise ConnectionError(f"unexpected frame type {msg_type}")
            req_id, status, n = _REPLY_HEADER.unpack_from(body)
            offset = _REPLY_HEADER.size
            predictions = np.frombuffer(
                body, dtype="<f4", count=n, offset=offset
            ).astype(np.float32, copy=True)
            offset += n * 4
            (blob_len,) = struct.unpack_from("<I", body, offset)
            blob = body[offset + 4:offset + 4 + blob_len]
            try:
                model_key, model_info, model_date = json.loads(
                    blob or b"[null, null, null]"
                )
            except (ValueError, TypeError):
                model_key = model_info = model_date = None
            with self._lock:
                entry = self._pending.pop(req_id, None)
                self.replies_received += 1 if entry is not None else 0
                self._m_credits.set(float(len(self._pending)))
                if self.credit_window:
                    self._m_occupancy.set(
                        len(self._pending) / self.credit_window
                    )
            if entry is None:
                continue  # duplicate/late reply after a failover: inert
            rtt = time.monotonic() - entry.submitted_at
            self._m_wait.observe(rtt)
            self._m_rtt.observe(rtt)
            self._complete(
                entry.on_done,
                _Reply(status, predictions, model_key, model_info,
                       model_date),
            )

    def _teardown_socket(self) -> None:
        self._connected = False
        with self._wlock:
            sock, self._sock = self._sock, None
        if sock is not None:
            _shutdown_close(sock)

    def _fail_pending(self, exc: Exception) -> None:
        with self._lock:
            failed = list(self._pending.values())
            self._pending.clear()
            self.failures += len(failed)
            self._m_credits.set(0.0)
            self._m_occupancy.set(0.0)
        for entry in failed:
            self._complete(entry.on_done, exc)

    @staticmethod
    def _complete(on_done, outcome) -> None:
        try:
            on_done(outcome)
        except Exception as exc:  # a broken callback must not kill the reader
            log.error(f"netqueue on_done callback failed: {exc!r}")

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "dispatcher_up": self.dispatcher_up(),
                "requests_submitted": self.requests_submitted,
                "rows_submitted": self.rows_submitted,
                "replies_received": self.replies_received,
                "failures": self.failures,
                "in_flight": len(self._pending),
                "slots": self.credit_window,
                "slots_free": max(
                    0, self.credit_window - len(self._pending)
                ),
            }

    def transport_state(self) -> dict:
        """The /healthz transport block (frontend.healthz_payload)."""
        with self._lock:
            in_flight = len(self._pending)
        return {
            "kind": self.address[0],
            "connected": self._connected,
            "reconnects": self.reconnects,
            "credit_window": self.credit_window,
            "credits_in_flight": in_flight,
            "address": (
                self.address[1] if self.address[0] == "unix"
                else f"{self.address[1]}:{self.address[2]}"
            ),
            # the /healthz leadership section, from the
            # CLIENT's vantage point: what fence it is pinned to and
            # how many completed failovers it has lived through
            "leadership": {
                "role": "active" if self._connected else "unknown",
                "fence": self.fence_seen,
                "lease_age_s": (
                    round(time.monotonic() - self._leader_since, 3)
                    if self._leader_since is not None else None
                ),
                "takeovers_observed": self.takeovers_observed,
            },
        }


class _NetSubmission:
    """One dequeued request, dispatcher-side — duck-typed to
    ``rowqueue._Submission`` (``kind`` / ``X`` / ``frontend_id`` /
    ``trace_id``), plus the owning connection the reply routes back
    over."""

    __slots__ = ("conn", "req_id", "kind", "X", "trace_id", "frontend_id",
                 "received_at")

    def __init__(self, conn, req_id, kind, X, trace_id, received_at):
        self.conn = conn
        self.req_id = req_id
        self.kind = kind
        self.X = X
        self.trace_id = trace_id
        self.frontend_id = conn.conn_id
        self.received_at = received_at


class _Conn:
    """One accepted front-end connection: its socket, a write lock (the
    serve loop and the coalescer's dispatcher thread both reply), and
    in-flight accounting for the disconnect reclaim."""

    __slots__ = ("sock", "conn_id", "alive", "wlock", "in_flight")

    def __init__(self, sock, conn_id: int):
        self.sock = sock
        self.conn_id = conn_id
        self.alive = True
        self.wlock = threading.Lock()
        self.in_flight = 0


class NetQueueServer:
    """The dispatcher side of the socket row queue — the same
    ``poll``/``reply`` surface as
    :class:`~bodywork_tpu_torch.serve.rowqueue.RowQueueServer`, so
    ``DispatchServer`` pumps either transport unchanged. Listens on TCP
    or a Unix domain socket, accepts any number of front-end
    connections, and feeds their SUBMIT frames through one internal
    queue — the coalescer downstream still batches from the union of
    every front-end's rows.

    A dropped connection reclaims its in-flight budget (the socket
    analogue of ``RowQueue.reclaim_frontend``): queued submissions from
    the dead connection are skipped at ``poll`` and replies to it are
    dropped, never raised."""

    def __init__(self, address, credit_window: int = DEFAULT_SLOTS,
                 backlog: int = 64, fence: int = 0):
        self.credit_window = int(credit_window)
        #: leadership fence announced in every HELLO; 0 = no election
        #: (clients then never refuse on fence). An elected dispatcher
        #: passes its lease fence so zombie ex-leaders are refused.
        self.fence = int(fence)
        self._unix_path = None
        if address[0] == "unix":
            self._unix_path = address[1]
            if os.path.exists(self._unix_path):
                os.unlink(self._unix_path)  # stale socket from a crash
            self._listener = socket.socket(
                socket.AF_UNIX, socket.SOCK_STREAM
            )
            self._listener.bind(self._unix_path)
        else:
            self._listener = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM
            )
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
            self._listener.bind((address[1], address[2]))
        self._listener.listen(backlog)
        self.address = (
            ("unix", self._unix_path) if self._unix_path is not None
            else ("tcp",) + self._listener.getsockname()[:2]
        )
        self._subs: queue_mod.Queue = queue_mod.Queue()
        self._conns: dict[int, _Conn] = {}
        self._lock = threading.Lock()
        self._next_conn_id = 0
        self._stopped = False
        self._in_flight = 0
        from bodywork_tpu_torch.obs import get_registry

        reg = get_registry()
        # same dispatcher-side families as the shm server, so dashboards
        # and the depth-based runbooks see one queue either way. The
        # handoff histogram here covers socket receive -> dispatch poll
        # (one clock); the full cross-host hop is the CLIENT's
        # netqueue_rtt_seconds — two hosts share no monotonic clock.
        self._m_handoff = reg.histogram(
            "bodywork_tpu_rowqueue_handoff_seconds",
            "Front-end enqueue -> dispatcher dequeue across the shared "
            "row-queue (the cost of the disaggregation hop)",
            buckets=(0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1, 0.5),
        )
        self._m_depth = reg.gauge(
            "bodywork_tpu_rowqueue_depth",
            "Row-queue requests dequeued by the dispatcher and not yet "
            "replied to",
            aggregate="sum",
        )
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="netqueue-accept", daemon=True
        )
        self._accept_thread.start()

    # -- accept / per-connection readers -------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            if sock.family == socket.AF_INET:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                conn = _Conn(sock, self._next_conn_id)
                self._next_conn_id += 1
                self._conns[conn.conn_id] = conn
            try:
                hello = _HELLO_BODY.pack(
                    WIRE_SCHEMA_VERSION, self.credit_window, self.fence
                ) + BINARY_CONTENT_TYPE.encode("ascii")
                sock.sendall(_frame(_MSG_HELLO, hello))
            except OSError:
                self._drop_conn(conn)
                continue
            threading.Thread(
                target=self._conn_reader, args=(conn,),
                name=f"netqueue-conn-{conn.conn_id}", daemon=True,
            ).start()
            log.info(
                f"netqueue front-end connection {conn.conn_id} accepted "
                f"(window {self.credit_window})"
            )

    def _conn_reader(self, conn: _Conn) -> None:
        try:
            while not self._stopped:
                msg_type, body = _recv_frame(conn.sock)
                if msg_type != _MSG_SUBMIT:
                    raise ConnectionError(
                        f"unexpected frame type {msg_type}"
                    )
                req_id, kind, trace_len = _SUBMIT_HEADER.unpack_from(body)
                offset = _SUBMIT_HEADER.size
                trace_id = body[offset:offset + trace_len].decode(
                    "ascii", "replace"
                ) or None
                X, err = parse_binary_rows(body[offset + trace_len:])
                if err is not None:
                    raise ConnectionError(f"bad row framing: {err}")
                with conn.wlock:
                    conn.in_flight += 1
                if conn.in_flight > self.credit_window:
                    # the client enforces the window; exceeding it here
                    # is a protocol violation, not backpressure
                    raise ConnectionError("credit window exceeded")
                self._subs.put(_NetSubmission(
                    conn, req_id, int(kind), X, trace_id, time.monotonic()
                ))
        except (OSError, ConnectionError) as exc:
            if not self._stopped:
                log.warning(
                    f"netqueue front-end connection {conn.conn_id} "
                    f"dropped: {exc}"
                )
        finally:
            self._drop_conn(conn)

    def _drop_conn(self, conn: _Conn) -> None:
        with self._lock:
            if not conn.alive:
                return
            conn.alive = False
            self._conns.pop(conn.conn_id, None)
        reclaimed = conn.in_flight
        if reclaimed:
            # the socket analogue of the dead-front-end slot reclaim:
            # its queued submissions are skipped at poll and its
            # in-flight budget evaporates with the connection
            log.warning(
                f"reclaimed {reclaimed} in-flight submission(s) from "
                f"dead front-end connection {conn.conn_id}"
            )
        _shutdown_close(conn.sock)

    # -- the RowQueueServer surface ------------------------------------------
    def poll(self, timeout_s: float = 0.2):
        """Next live submission, or None on timeout. Submissions whose
        connection died while they queued are skipped (their front-end
        can no longer receive the reply)."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                sub = self._subs.get(timeout=remaining)
            except queue_mod.Empty:
                return None
            if not sub.conn.alive:
                continue  # dead front-end: reply would go nowhere
            self._m_handoff.observe(
                max(0.0, time.monotonic() - sub.received_at),
                exemplar=sub.trace_id,
            )
            with self._lock:
                self._in_flight += 1
                self._m_depth.set(float(self._in_flight))
            return sub

    def reply(self, sub, status: int, predictions=None,
              bundle=None) -> None:
        """Write one REPLY frame back over the owning connection. A dead
        connection drops the reply silently — the front-end's waits
        already failed when its connection broke."""
        n = 0
        pred_bytes = b""
        if predictions is not None:
            arr = np.asarray(predictions, dtype="<f4").ravel()
            n = int(arr.shape[0])
            pred_bytes = np.ascontiguousarray(arr).tobytes()
        blob = b"[null, null, null]"
        if bundle is not None:
            blob = json.dumps([
                bundle.model_key, bundle.model_info, bundle.model_date,
            ]).encode()
        payload = (
            _REPLY_HEADER.pack(sub.req_id, status, n)
            + pred_bytes
            + struct.pack("<I", len(blob))
            + blob
        )
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            self._m_depth.set(float(self._in_flight))
        conn = sub.conn
        try:
            with conn.wlock:
                if not conn.alive:
                    return
                conn.in_flight = max(0, conn.in_flight - 1)
                conn.sock.sendall(_frame(_MSG_REPLY, payload))
        except OSError as exc:
            log.warning(
                f"netqueue reply to dead front-end connection "
                f"{conn.conn_id} dropped: {exc}"
            )
            self._drop_conn(conn)

    def close(self) -> None:
        self._stopped = True
        _shutdown_close(self._listener)  # wakes the blocked accept()
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            self._drop_conn(conn)
        if self._unix_path and os.path.exists(self._unix_path):
            try:
                os.unlink(self._unix_path)
            except OSError:
                pass
        if self._accept_thread.ident is not None:
            self._accept_thread.join(timeout=5)


# re-exported for callers that only deal in transports
KIND_SINGLE = KIND_SINGLE
