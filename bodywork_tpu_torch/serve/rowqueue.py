"""Shared-memory row queue between front-end and dispatcher processes
(the port of ``bodywork_tpu.serve.rowqueue``: the same layout, descriptor
encoding, liveness words and metrics; numpy and ``multiprocessing`` only,
no torch).

The disaggregated serving split (``serve.frontend`` / ``serve.dispatch``)
puts HTTP parsing and admission in N cheap front-end processes and the
device in exactly ONE dispatcher — so the dispatcher's coalescer forms
batches from the union of every front-end's rows instead of each
SO_REUSEPORT worker fragmenting its own. This module is the channel
between them: a fixed pool of fixed-stride shared-memory row slots plus
small control queues.

Data plane (shared ``multiprocessing`` memory, allocated once by the
fleet supervisor and inherited by every process):

- ``data``   — request rows: ``slots x slot_floats`` little-endian f32.
  A front-end writes a request's rows into its slot ONCE; the dispatcher
  reads them **zero-copy** as a numpy view straight into the predictor.
- ``reply``  — predictions, written by the dispatcher, read by the
  owning front-end.
- ``meta``   — per-slot int64 header: generation, kind, row/feature
  counts, reply status.
- ``text``   — per-slot strings: the request's trace id (the trace ctx
  that rides the queue) and the reply's answering-bundle identity
  (model key / info / date) — what the front-end needs to render a
  byte-identical response without ever holding a model.
- ``stamps`` — per-slot ``time.monotonic()`` enqueue timestamps
  (CLOCK_MONOTONIC is machine-wide on Linux, so the dispatcher can
  subtract them) behind the ``bodywork_tpu_rowqueue_handoff_seconds``
  histogram.

Control plane (lock-free by design — see :class:`_SpscRing` for why a
``multiprocessing.Queue`` CANNOT carry it):

- ``sub_rings[i]`` — per-front-end single-producer/single-consumer
  descriptor ring (front-end *i* pushes ``gen<<20 | slot``, the
  dispatcher pops; only 8 bytes of descriptor cross, never rows).
- ``rep_rings[i]`` — the completion ring back (dispatcher pushes, the
  front-end's reader thread pops).
- ``up`` / ``epoch`` — the dispatcher-liveness channel the supervisor
  owns: ``up`` gates new submissions (a front-end answers 503 +
  Retry-After instead of enqueueing into a dead dispatcher), and an
  ``epoch`` bump fails every in-flight wait immediately so a dispatcher
  crash degrades front-ends instead of wedging them. Both are
  ``RawValue`` — a lock-guarded ``Value`` read on every request would
  put a shared lock on the hot path AND hand a SIGKILLed holder a way
  to wedge the fleet.

Crash safety is generation-based: a slot's ``gen`` is bumped at every
allocation, every descriptor carries the gen it was enqueued under, and
both sides drop mismatches. A respawned dispatcher can therefore drain
stale descriptors harmlessly, and a late reply to a slot the front-end
already failed (epoch bump) is ignored — torn responses are impossible
by construction.

Slot allocation is front-end-only (the free list is guarded by one
shared lock); the dispatcher never allocates, so a dispatcher crash can
never leak slots it didn't own.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.rowqueue")

__all__ = [
    "DispatcherUnavailable",
    "RowQueue",
    "RowQueueClient",
    "RowQueueServer",
    "SlotsExhausted",
]

#: default slot pool: bounds the service-wide in-flight row-queue work.
#: Sized above the default admission budget (512) so admission — not the
#: queue — is the normal backpressure boundary.
DEFAULT_SLOTS = 1024
#: f32 capacity per slot: matches the largest predictor bucket (4096
#: rows x 1 feature), so any request a scoring client sends fits one slot
DEFAULT_SLOT_FLOATS = 4096

#: request kinds (meta K_KIND)
KIND_SINGLE = 1
KIND_BATCH = 2

#: reply statuses beyond plain HTTP codes: the dispatcher answers with
#: the HTTP status the in-process path would have used (200/500/503),
#: and the front-end renders the matching byte-identical body
STATUS_PENDING = 0

#: per-slot int64 meta fields
_M_GEN = 0
_M_KIND = 1
_M_ROWS = 2
_M_FEATURES = 3
_M_STATUS = 4
_M_REPLY_ROWS = 5
#: 1 + owning frontend_id while allocated, 0 while free — written only
#: under the free-list lock, so the supervisor can reclaim a SIGKILLed
#: front-end's slots (reclaim_frontend) without racing live allocators
_M_OWNER = 6
META_INTS = 8

#: per-slot text region: trace id (request) + answering-bundle identity
#: (reply), JSON-encoded so None survives the trip
REQ_TEXT_BYTES = 64
REP_TEXT_BYTES = 448
TEXT_BYTES = REQ_TEXT_BYTES + REP_TEXT_BYTES


#: descriptor encoding: ``gen << _SLOT_BITS | slot``. 20 bits of slot
#: index (1M slots — far above any sane pool) leaves 43 bits of
#: generation counter in the int64 ring payload: centuries of churn.
_SLOT_BITS = 20
_SLOT_MASK = (1 << _SLOT_BITS) - 1


class _SpscRing:
    """Single-producer/single-consumer int64 ring in shared memory.

    The control plane deliberately refuses ``multiprocessing.Queue`` (or
    ``Pipe``): a Queue reader holds the queue's shared rlock for the
    WHOLE blocking ``get`` — the dispatcher polls constantly, so a
    SIGKILL lands inside the critical section with near certainty,
    orphans the lock, and every respawned dispatcher inherits a channel
    it can never read. (A Pipe has no lock but a kill mid-``recv`` tears
    the byte stream for every successor.) Here the only shared state is
    a data array and two monotonic cursors: a push stores the payload
    FIRST and publishes by advancing ``tail`` LAST, so a kill at any
    instruction leaves the ring consistent — an entry is either fully
    visible or not there at all. A respawned process just keeps
    consuming from ``head``.

    Two caveats the callers own:

    - **Single producer means ONE THREAD.** The payload-then-tail
      publish protocol is safe against a concurrent consumer, not
      against a second producer: two threads that read the same tail
      overwrite each other's payload and advance it once, silently
      dropping an entry. The client serializes its HTTP handler
      threads through ``RowQueueClient._lock`` and the server
      serializes its serve-loop/coalescer threads through
      ``RowQueueServer._lock`` — any new producer call site must take
      the owning side's lock.
    - **Cross-process ordering assumes x86-TSO.** ctypes RawArray
      writes are plain stores with no fence; total store order is what
      makes the consumer see the payload before the advanced tail. On
      weakly-ordered architectures (aarch64) a consumer in another
      process could observe the new tail first and read a stale
      descriptor. The descriptor's generation guard downgrades that
      from a torn response to a dropped request (both sides discard
      gen mismatches), but a port to ARM should publish ``tail``
      through a fencing primitive instead.
    """

    __slots__ = ("data", "pos", "cap")

    def __init__(self, ctx, capacity: int):
        self.data = ctx.RawArray("q", capacity)
        # pos[0] = head (consumer cursor), pos[1] = tail (producer
        # cursor); both monotonic, entry i lives at data[i % cap]
        self.pos = ctx.RawArray("q", 2)
        self.cap = capacity

    def push(self, value: int) -> bool:
        tail = self.pos[1]
        if tail - self.pos[0] >= self.cap:
            return False  # full (unreachable when cap > slot pool size)
        self.data[tail % self.cap] = value
        self.pos[1] = tail + 1  # publish AFTER the payload store
        return True

    def pop(self) -> int | None:
        head = self.pos[0]
        if self.pos[1] <= head:
            return None
        value = self.data[head % self.cap]
        self.pos[0] = head + 1
        return int(value)


class DispatcherUnavailable(RuntimeError):
    """The dispatcher is down (or died mid-request): the front-end
    answers 503 + Retry-After; the supervisor's respawn heals it."""


class SlotsExhausted(RuntimeError):
    """No free row slot (or the request outgrows one slot): backpressure
    — the front-end sheds exactly as an admission-budget refusal."""


class RowQueue:
    """The shared handles, created ONCE by the fleet supervisor and
    passed to every front-end/dispatcher process at spawn (all members
    are picklable multiprocessing primitives)."""

    def __init__(
        self,
        ctx,
        frontends: int,
        slots: int = DEFAULT_SLOTS,
        slot_floats: int = DEFAULT_SLOT_FLOATS,
    ):
        if frontends < 1:
            raise ValueError(f"need >= 1 front-end, got {frontends}")
        if slots < 1 or slot_floats < 1:
            raise ValueError("slots and slot_floats must be >= 1")
        if slots > _SLOT_MASK:
            raise ValueError(
                f"slots must fit the {_SLOT_BITS}-bit descriptor field "
                f"(<= {_SLOT_MASK}), got {slots}"
            )
        self.frontends = frontends
        self.slots = slots
        self.slot_floats = slot_floats
        self.data = ctx.RawArray("f", slots * slot_floats)
        self.reply = ctx.RawArray("f", slots * slot_floats)
        self.meta = ctx.RawArray("q", slots * META_INTS)
        self.text = ctx.RawArray("c", slots * TEXT_BYTES)
        self.stamps = ctx.RawArray("d", slots)
        # free list: [0] = count, [1..] = LIFO stack of free slot indices
        self.free = ctx.Array("i", slots + 1)
        with self.free.get_lock():
            self.free[0] = slots
            for i in range(slots):
                self.free[1 + i] = i
        # a front-end can never have more than `slots` submissions in
        # flight, so slots + 1 ring entries can never fill
        self.sub_rings = [_SpscRing(ctx, slots + 1) for _ in range(frontends)]
        self.rep_rings = [_SpscRing(ctx, slots + 1) for _ in range(frontends)]
        #: 1 while a dispatcher is live with a loaded model (the
        #: dispatcher sets it; the supervisor clears it at death)
        self.up = ctx.RawValue("i", 0)
        #: bumped by the supervisor at every dispatcher death: clients
        #: fail their in-flight waits the moment they observe a change
        self.epoch = ctx.RawValue("i", 0)

    def close(self) -> None:
        """Supervisor teardown hook. Everything here is plain shared
        memory — reclaimed with the last process holding it — so there
        is nothing to release eagerly; kept for symmetry with resource
        owners the supervisor tears down."""

    def reclaim_frontend(self, frontend_id: int) -> int:
        """Free every slot a dead front-end still owned (supervisor
        hook, called at the FIRST observation of a front-end death).

        A SIGKILLed front-end takes its ``_pending`` map with it, so
        the respawned client has no record of the slots the old process
        held — without this, every front-end crash permanently shrinks
        the shared pool until the service sheds everything. Ownership
        is recorded per-slot under the free-list lock (``_M_OWNER``),
        so the scan here cannot race a live allocator. Each reclaimed
        slot's generation is bumped first: a dispatcher still scoring
        it drops the reply on its gen guard, and stale descriptors in
        either ring become inert. Returns the number of slots freed."""
        views = _Views(self)
        freed = 0
        with self.free.get_lock():
            for slot in range(self.slots):
                if int(views.meta[slot, _M_OWNER]) != frontend_id + 1:
                    continue
                views.meta[slot, _M_GEN] += 1
                views.meta[slot, _M_OWNER] = 0
                self.free[0] += 1
                self.free[self.free[0]] = slot
                freed += 1
        return freed


class _Reply:
    """One completed submission, as the front-end renders it."""

    __slots__ = (
        "status", "predictions", "model_key", "model_info", "model_date",
    )

    def __init__(self, status, predictions, model_key, model_info,
                 model_date):
        self.status = status
        self.predictions = predictions
        self.model_key = model_key
        self.model_info = model_info
        self.model_date = model_date


class _Views:
    """Per-process numpy views over the shared regions (views cannot
    cross a spawn; each process rebuilds them once)."""

    def __init__(self, queue: RowQueue):
        self.data = np.frombuffer(queue.data, dtype=np.float32).reshape(
            queue.slots, queue.slot_floats
        )
        self.reply = np.frombuffer(queue.reply, dtype=np.float32).reshape(
            queue.slots, queue.slot_floats
        )
        self.meta = np.frombuffer(queue.meta, dtype=np.int64).reshape(
            queue.slots, META_INTS
        )
        self.text = np.frombuffer(queue.text, dtype=np.uint8).reshape(
            queue.slots, TEXT_BYTES
        )
        self.stamps = np.frombuffer(queue.stamps, dtype=np.float64)


def _write_text(view_row, offset: int, limit: int, blob: bytes) -> None:
    blob = blob[:limit]
    region = view_row[offset:offset + limit]
    region[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    region[len(blob):] = 0


def _read_text(view_row, offset: int, limit: int) -> bytes:
    return bytes(view_row[offset:offset + limit]).rstrip(b"\x00")


class RowQueueClient:
    """The front-end side: allocate a slot, write rows once, enqueue the
    descriptor, and complete via a push callback when the dispatcher's
    reply lands (one reader thread per front-end process bridges the
    reply queue to callbacks — the same push shape as the coalescer's
    ``on_done``, so both HTTP engines wrap it the way they already wrap
    coalesced submissions)."""

    def __init__(self, queue: RowQueue, frontend_id: int):
        if not 0 <= frontend_id < queue.frontends:
            raise ValueError(
                f"frontend_id {frontend_id} out of range 0..{queue.frontends - 1}"
            )
        self.queue = queue
        self.frontend_id = frontend_id
        self._views = _Views(queue)
        self._lock = threading.Lock()
        #: slot -> (gen, on_done) for submissions awaiting a reply
        self._pending: dict[int, tuple[int, object]] = {}
        self._stopped = False
        self._epoch_seen = queue.epoch.value
        # accounting (the shed-before-parse proof reads rows_submitted)
        self.rows_submitted = 0
        self.requests_submitted = 0
        self.replies_received = 0
        self.failures = 0
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
        self._reader = threading.Thread(
            target=self._reader_loop, name=f"rowqueue-replies-{frontend_id}",
            daemon=True,
        )

    def start(self) -> "RowQueueClient":
        self._reader.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        self._fail_pending(DispatcherUnavailable("front-end shutting down"))
        if self._reader.ident is not None:
            self._reader.join(timeout=5)

    # -- submit path ---------------------------------------------------------
    def dispatcher_up(self) -> bool:
        return self.queue.up.value == 1

    def _alloc_slot(self) -> int:
        free = self.queue.free
        with free.get_lock():
            count = free[0]
            if count <= 0:
                raise SlotsExhausted("no free row-queue slot")
            slot = free[count]  # stack top is free[count], count preceding
            free[0] = count - 1
            # ownership stamp, inside the lock: the supervisor's
            # dead-front-end reclaim scans owners under the same lock
            self._views.meta[slot, _M_OWNER] = self.frontend_id + 1
        return slot

    def _free_slot(self, slot: int) -> None:
        free = self.queue.free
        with free.get_lock():
            self._views.meta[slot, _M_OWNER] = 0
            free[0] += 1
            free[free[0]] = slot

    def submit(self, X, kind: int, on_done, trace_id: str | None = None) -> None:
        """Write one request's rows and enqueue it. ``on_done`` fires on
        the reader thread with a reply object (``status``,
        ``predictions``, answering-bundle identity) or an exception
        (:class:`DispatcherUnavailable` on a dispatcher death). Raises
        :class:`DispatcherUnavailable` / :class:`SlotsExhausted`
        synchronously when nothing was enqueued."""
        if self._stopped or self.queue.up.value != 1:
            raise DispatcherUnavailable("scoring dispatcher is not available")
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 0:
            X = X[None]
        n_rows = int(X.shape[0])
        n_features = int(X.shape[1]) if X.ndim == 2 else 1
        floats = n_rows * n_features
        if floats > self.queue.slot_floats:
            raise SlotsExhausted(
                f"request of {floats} values exceeds the "
                f"{self.queue.slot_floats}-value slot stride"
            )
        slot = self._alloc_slot()
        views = self._views
        meta = views.meta[slot]
        gen = int(meta[_M_GEN]) + 1
        meta[_M_GEN] = gen
        meta[_M_KIND] = kind
        meta[_M_ROWS] = n_rows
        meta[_M_FEATURES] = n_features
        meta[_M_STATUS] = STATUS_PENDING
        meta[_M_REPLY_ROWS] = 0
        views.data[slot, :floats] = X.ravel()
        _write_text(
            views.text[slot], 0, REQ_TEXT_BYTES,
            (trace_id or "").encode("ascii", "replace"),
        )
        views.stamps[slot] = time.monotonic()
        with self._lock:
            # the descriptor push stays inside the lock: the thread
            # engine calls submit from concurrent request
            # threads, and the sub ring is single-PRODUCER — two
            # unserialized pushes can read the same tail and silently
            # drop one descriptor (its handler would hang into the
            # rendezvous timeout and leak the slot)
            pushed = self.queue.sub_rings[self.frontend_id].push(
                (gen << _SLOT_BITS) | slot
            )
            if pushed:
                self._pending[slot] = (gen, on_done)
                self.requests_submitted += 1
                self.rows_submitted += n_rows
        if not pushed:  # pragma: no cover - ring cap exceeds the slot pool
            self._free_slot(slot)
            raise SlotsExhausted("row-queue descriptor ring full")
        self._m_rows.inc(n_rows)

    # -- reply path ----------------------------------------------------------
    def _reader_loop(self) -> None:
        ring = self.queue.rep_rings[self.frontend_id]
        idle_sleep = 0.0002
        while not self._stopped:
            epoch = self.queue.epoch.value
            if epoch != self._epoch_seen:
                # the supervisor observed a dispatcher death: every
                # in-flight wait fails NOW (503 + Retry-After at the
                # HTTP layer) instead of hanging into a client timeout
                self._epoch_seen = epoch
                self._fail_pending(
                    DispatcherUnavailable("scoring dispatcher died")
                )
            descriptor = ring.pop()
            if descriptor is None:
                # adaptive poll: sub-ms while traffic flows (replies
                # arrive well inside the coalescer window), backing off
                # toward 20ms when idle so an idle front-end costs ~none
                time.sleep(idle_sleep)
                idle_sleep = min(idle_sleep * 2, 0.02)
                continue
            idle_sleep = 0.0002
            slot = descriptor & _SLOT_MASK
            gen = descriptor >> _SLOT_BITS
            entry = None
            with self._lock:
                pending = self._pending.get(slot)
                if pending is not None and pending[0] == gen:
                    entry = self._pending.pop(slot)
            if entry is None:
                # a stale descriptor (the wait already failed on an
                # epoch bump, and the slot was freed then): drop it —
                # the gen guard makes late replies inert
                continue
            views = self._views
            meta = views.meta[slot]
            status = int(meta[_M_STATUS])
            n = int(meta[_M_REPLY_ROWS])
            predictions = np.array(views.reply[slot, :n])  # copy, then free
            blob = _read_text(views.text[slot], REQ_TEXT_BYTES, REP_TEXT_BYTES)
            try:
                model_key, model_info, model_date = json.loads(blob or b"[null, null, null]")
            except (ValueError, TypeError):
                model_key = model_info = model_date = None
            enqueued_at = float(views.stamps[slot])
            self._free_slot(slot)
            with self._lock:
                self.replies_received += 1
            self._m_wait.observe(time.monotonic() - enqueued_at)
            self._complete(
                entry[1],
                _Reply(status, predictions, model_key, model_info, model_date),
            )

    def _fail_pending(self, exc: Exception) -> None:
        with self._lock:
            failed = list(self._pending.items())
            self._pending.clear()
            self.failures += len(failed)
        for slot, (_gen, on_done) in failed:
            self._free_slot(slot)
            self._complete(on_done, exc)

    @staticmethod
    def _complete(on_done, outcome) -> None:
        try:
            on_done(outcome)
        except Exception as exc:  # a broken callback must not kill the reader
            log.error(f"rowqueue on_done callback failed: {exc!r}")

    def stats(self) -> dict:
        with self._lock:
            return {
                "dispatcher_up": self.dispatcher_up(),
                "requests_submitted": self.requests_submitted,
                "rows_submitted": self.rows_submitted,
                "replies_received": self.replies_received,
                "failures": self.failures,
                "in_flight": len(self._pending),
                "slots": self.queue.slots,
                "slots_free": int(self.queue.free[0]),
            }

    def transport_state(self) -> dict:
        """The /healthz transport block — same shape as
        ``netqueue.NetQueueClient.transport_state`` so operators read one
        schema whichever transport a front-end rides. The shm transport
        has no connection to lose (liveness is the supervisor-maintained
        ``up`` word) and never reconnects; its credit window is the
        shared slot pool."""
        with self._lock:
            in_flight = len(self._pending)
        return {
            "kind": "shm",
            "connected": self.dispatcher_up(),
            "reconnects": 0,
            "credit_window": self.queue.slots,
            "credits_in_flight": in_flight,
            "address": None,
            # the /healthz leadership section, shm analogue: no CAS
            # election runs on one host — the supervisor's respawn IS
            # the takeover, and the queue epoch (bumped once per
            # dispatcher death) plays the fence's monotonic role
            "leadership": {
                "role": "active" if self.dispatcher_up() else "down",
                "fence": int(self.queue.epoch.value),
                "lease_age_s": None,
                "takeovers_observed": int(self.queue.epoch.value),
            },
        }


class _Submission:
    """One dequeued request, dispatcher-side. ``X`` is a ZERO-COPY numpy
    view straight into the shared slot — valid until the reply is
    written (the owning front-end frees the slot only after that)."""

    __slots__ = ("slot", "gen", "frontend_id", "kind", "X", "trace_id")

    def __init__(self, slot, gen, frontend_id, kind, X, trace_id):
        self.slot = slot
        self.gen = gen
        self.frontend_id = frontend_id
        self.kind = kind
        self.X = X
        self.trace_id = trace_id


class RowQueueServer:
    """The dispatcher side: poll descriptors, hand out zero-copy row
    views, write replies. One instance per dispatcher process."""

    def __init__(self, queue: RowQueue):
        self.queue = queue
        self._views = _Views(queue)
        reg = get_registry()
        self._m_handoff = reg.histogram(
            "bodywork_tpu_rowqueue_handoff_seconds",
            "Front-end enqueue -> dispatcher dequeue across the shared "
            "row-queue (the cost of the disaggregation hop)",
            buckets=(0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.025, 0.1, 0.5),
        )
        self._m_occupancy = reg.gauge(
            "bodywork_tpu_rowqueue_occupancy_ratio",
            "Allocated row slots / slot pool size (1.0 = the queue, not "
            "admission, is the backpressure boundary)",
        )
        self._m_depth = reg.gauge(
            "bodywork_tpu_rowqueue_depth",
            "Row-queue requests dequeued by the dispatcher and not yet "
            "replied to",
            aggregate="sum",
        )
        self._in_flight = 0
        self._next_ring = 0
        # reply() runs on TWO threads — the serve_forever loop (batch /
        # 503 / error / coalescer-saturated paths) and the coalescer's
        # dispatcher thread — and the rep rings are single-producer:
        # every reply (and the _in_flight accounting poll shares)
        # serializes through this lock
        self._lock = threading.Lock()

    def _pop_submission(self) -> tuple[int, int] | None:
        """One round-robin sweep over the front-ends' descriptor rings
        (rotating the start index so a chatty front-end cannot starve
        its siblings); ``(descriptor, frontend_id)`` or None."""
        n = self.queue.frontends
        for offset in range(n):
            i = (self._next_ring + offset) % n
            descriptor = self.queue.sub_rings[i].pop()
            if descriptor is not None:
                self._next_ring = (i + 1) % n
                return descriptor, i
        return None

    def poll(self, timeout_s: float = 0.2) -> _Submission | None:
        """Next live submission, or None (timeout / stale descriptor).
        Also refreshes the occupancy gauge — the scale-front-ends signal
        the runbook keys off."""
        used = self.queue.slots - int(self.queue.free[0])
        self._m_occupancy.set(used / self.queue.slots)
        deadline = time.monotonic() + timeout_s
        idle_sleep = 0.0002
        while True:
            popped = self._pop_submission()
            if popped is not None:
                break
            if time.monotonic() >= deadline:
                return None
            # same adaptive poll as the client reader: sub-ms under
            # load, ~2ms when idle (bounded by the poll timeout)
            time.sleep(idle_sleep)
            idle_sleep = min(idle_sleep * 2, 0.002)
        descriptor, frontend_id = popped
        slot = descriptor & _SLOT_MASK
        gen = descriptor >> _SLOT_BITS
        views = self._views
        meta = views.meta[slot]
        if int(meta[_M_GEN]) != gen:
            # a stale descriptor from before a front-end failure/respawn
            # cycle: the slot has moved on — never touch it
            return None
        self._m_handoff.observe(
            max(0.0, time.monotonic() - views.stamps[slot]),
            exemplar=(
                _read_text(views.text[slot], 0, REQ_TEXT_BYTES).decode(
                    "ascii", "replace"
                ) or None
            ),
        )
        n_rows = int(meta[_M_ROWS])
        n_features = int(meta[_M_FEATURES])
        flat = views.data[slot, : n_rows * n_features]
        X = flat if n_features == 1 else flat.reshape(n_rows, n_features)
        trace_id = _read_text(views.text[slot], 0, REQ_TEXT_BYTES).decode(
            "ascii", "replace"
        ) or None
        with self._lock:
            self._in_flight += 1
            self._m_depth.set(float(self._in_flight))
        return _Submission(slot, gen, frontend_id, int(meta[_M_KIND]), X,
                           trace_id)

    def reply(self, sub: _Submission, status: int, predictions=None,
              bundle=None) -> None:
        """Write one reply and signal the owning front-end. ``bundle``
        is the ANSWERING served bundle (post-firewall) — its identity is
        what the front-end splices into the response, keeping
        disaggregated bytes identical to in-process bytes.

        Thread-safe: the serve loop and the coalescer's dispatcher
        thread both land here, and the rep rings are single-producer —
        an unserialized pair of pushes to the same ring can drop a
        reply descriptor (the waiting front-end would hang into its
        rendezvous timeout), so the whole reply serializes through
        ``self._lock``."""
        views = self._views
        with self._lock:
            meta = views.meta[sub.slot]
            if int(meta[_M_GEN]) != sub.gen:
                return  # the front-end moved on; never write a stale slot
            n = 0
            if predictions is not None:
                arr = np.asarray(predictions, dtype=np.float32).ravel()
                n = int(arr.shape[0])
                views.reply[sub.slot, :n] = arr
            blob = b"[null, null, null]"
            if bundle is not None:
                encoded = json.dumps([
                    bundle.model_key, bundle.model_info, bundle.model_date,
                ]).encode()
                if len(encoded) <= REP_TEXT_BYTES:
                    blob = encoded
                else:  # never tear the region; degrade identity-less
                    log.error("reply bundle identity exceeds the text region")
            _write_text(views.text[sub.slot], REQ_TEXT_BYTES, REP_TEXT_BYTES,
                        blob)
            meta[_M_REPLY_ROWS] = n
            meta[_M_STATUS] = status
            self._in_flight = max(0, self._in_flight - 1)
            self._m_depth.set(float(self._in_flight))
            # cannot fill (ring cap exceeds the slot pool); a dead
            # front-end simply never consumes — shared memory doesn't error
            self.queue.rep_rings[sub.frontend_id].push(
                (sub.gen << _SLOT_BITS) | sub.slot
            )
