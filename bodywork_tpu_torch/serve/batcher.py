"""Cross-request micro-batching for the scoring service (the port of
``bodywork_tpu.serve.batcher``; the per-source flush accounting of the
disaggregated front ends is a later slice).

Without it, every concurrent ``/score/v1`` request executes its OWN
bucket-padded device call: N threads of single-row traffic become N
serialized one-row dispatches, so per-worker throughput is bounded by
dispatch rate instead of the accelerator's batch dimension. The standard
accelerator-serving answer is request coalescing — hold a single-row
request for a tiny window, stack it with its concurrent neighbours, issue
ONE padded device call, scatter results back — trading a bounded latency
cost (at most the flush window) for throughput that scales with bucket
size under load.

Design:

- :class:`RequestCoalescer` owns a bounded pending list and one
  dispatcher thread. ``submit()`` blocks the calling request thread until
  its row's prediction is back.
- **Flush policy** (adaptive): the dispatcher flushes as soon as a batch
  reaches ``max_rows`` OR ``window_ms`` has elapsed since it started
  assembling one, whichever happens first. An idle service therefore pays
  at most one window of extra latency per request; a saturated one
  flushes full buckets back-to-back with no window wait at all.
- **Hot-swap safety**: every submission captures the app's served-model
  bundle (predictor + identity) at enqueue time, and a flush only takes
  the queue's leading run of submissions that share ONE bundle. A
  checkpoint swap landing mid-queue splits the queue into an old-model
  batch and a new-model batch — two device calls, each internally
  consistent — so a batch can never mix parameters from two model
  generations. ``drain()`` additionally lets the hot-swap path block
  until everything enqueued before the swap has been dispatched.
- **Overload**: when the pending list is full, ``submit()`` raises
  :class:`CoalescerSaturated` and the caller falls back to a direct
  per-request dispatch — backpressure degrades to the uncoalesced
  behaviour instead of dropping or deadlocking requests.
- A batch whose device call raises fails ONLY that batch: the error is
  scattered to its submitters (each request 500s) and the dispatcher
  keeps serving.

The coalescer is deliberately ignorant of HTTP and of predictor
internals: it stacks rows, calls ``served.predictor.predict`` once, and
indexes the result. The shape-bucket/pad/chunk algebra
(``serve.predictor``) is reused untouched, which is also why responses
are byte-identical with the batcher on or off — each output row of the
padded forward depends only on its own input row (on the card, each
bucket's captured graph).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.batcher")

#: default flush window: ~1-2 ms captures concurrent arrivals under load
#: while staying negligible next to the reference's 8.22 ms/score
DEFAULT_WINDOW_MS = 2.0
#: default batch cap; aligned with a mid-size predictor bucket so a full
#: flush pads to exactly one compiled shape
DEFAULT_MAX_ROWS = 64


class CoalescerSaturated(RuntimeError):
    """The pending queue is full (or the coalescer is stopped); the
    caller should fall back to a direct per-request dispatch."""


class _Submission:
    """One enqueued row: the input, the served bundle it must be scored
    by, and the rendezvous the request thread waits on. ``on_done`` is
    the OPTIONAL push-style completion channel (fired on the dispatcher
    thread right after ``event`` is set): the asyncio front-end sets it
    to hand the result back to its event loop without parking a thread
    on ``event.wait`` — the threaded engine keeps the blocking wait.
    ``trace`` is the submitting request's SAMPLED span context (None for
    unsampled or untraced requests): the dispatcher records the
    queue-wait and the shared device-dispatch span into each sampled
    member's trace, linked across the batch."""

    __slots__ = ("row", "served", "event", "result", "error", "enqueued_at", "on_done",
                 "trace", "enqueued_perf")

    def __init__(self, row: np.ndarray, served, on_done=None, trace=None):
        self.row = row
        self.served = served
        self.event = threading.Event()
        self.result: float | None = None
        self.error: BaseException | None = None
        self.enqueued_at = time.monotonic()
        self.on_done = on_done
        self.trace = trace
        # perf_counter twin of enqueued_at: spans live on the perf_counter
        # timeline (obs.tracing); taken only when traced
        self.enqueued_perf = time.perf_counter() if trace is not None else 0.0


class RequestCoalescer:
    """Batches concurrent single-row predictions into shared device calls.

    Thread-safe; one dispatcher thread per instance (one instance per
    worker process — replicas never share one, exactly as they never
    share a predictor).
    """

    def __init__(
        self,
        window_ms: float = DEFAULT_WINDOW_MS,
        max_rows: int = DEFAULT_MAX_ROWS,
        max_pending: int = 4096,
    ):
        if window_ms <= 0:
            raise ValueError(f"window_ms must be > 0, got {window_ms}")
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.window_s = window_ms / 1000.0
        self.max_rows = max_rows
        self.max_pending = max_pending
        self._cond = threading.Condition()
        self._pending: list[_Submission] = []
        #: submissions taken by the dispatcher but not yet scattered —
        #: kept as objects (not a count) so drain() can wait on exactly
        #: the submissions that existed when it was called
        self._inflight: list[_Submission] = []
        self._stopped = False
        self._started = False
        # observability: the dispatches-vs-requests ratio IS the payoff
        self.rows_submitted = 0
        self.batches_dispatched = 0
        self.rows_dispatched = 0
        self.max_batch_rows = 0
        # phase histograms (obs.registry): queue wait is the latency the
        # coalescer COSTS, device dispatch the work it AMORTISES — the
        # same bodywork_tpu_device_dispatch_seconds the app's direct
        # (uncoalesced) path observes into, so the two paths compare
        reg = get_registry()
        self._m_queue_wait = reg.histogram(
            "bodywork_tpu_queue_wait_seconds",
            "Coalescer queue wait: row enqueue -> batch execution start",
        )
        self._m_dispatch = reg.histogram(
            "bodywork_tpu_device_dispatch_seconds",
            "Device-dispatch phase: one padded predictor call",
        )
        self._m_batch_rows = reg.histogram(
            "bodywork_tpu_coalesced_batch_rows",
            "Rows per coalesced device dispatch (amortisation factor)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
        )
        self._m_saturated = reg.counter(
            "bodywork_tpu_coalescer_saturated_total",
            "submit() rejections: pending queue full or coalescer stopped",
        )
        # flush telemetry (the JAX package's tuner reads it as its
        # window/max_rows signal): occupancy says whether flushes FILL (window
        # too small / max_rows too big leaves capacity on the table;
        # ~1.0 under load means max_rows is the binding constraint), the
        # reason split says WHICH policy edge is firing
        self._m_occupancy = reg.histogram(
            "bodywork_tpu_serve_batch_occupancy_ratio",
            "Coalesced-flush occupancy: rows flushed / max_rows",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
        )
        self._m_flush_reason = reg.counter(
            "bodywork_tpu_serve_batch_flush_total",
            "Coalesced-batch flushes by triggering policy edge "
            "(window=deadline elapsed, max_rows=batch filled during the "
            "window, saturation=a full batch was already queued — no "
            "window wait at all)",
        )
        self._thread = threading.Thread(
            target=self._run, name="request-coalescer", daemon=True
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RequestCoalescer":
        with self._cond:
            if self._started:
                return self
            self._started = True
        self._thread.start()
        log.info(
            f"request coalescer on: window={self.window_s * 1e3:.1f}ms "
            f"max_rows={self.max_rows}"
        )
        return self

    def reconfigure(self, window_ms: float | None = None,
                    max_rows: int | None = None) -> dict:
        """Mutate the live coalescing policy in place (the online tuning
        controller's apply path): the dispatcher reads ``window_s`` /
        ``max_rows`` fresh on every loop iteration under ``_cond``, so a
        change here takes effect on the NEXT batch boundary — no drain,
        no dropped submissions, in-flight batches finish under the
        policy they started with. Validation matches the constructor
        (``window_ms`` must stay > 0: coalescing on/off is an app-level
        topology decision — a dispatcher thread cannot un-exist — so
        the 0=off transition is deliberately NOT live-mutable and the
        controller pins that in its mutable-live contract). Returns the
        applied values."""
        if window_ms is not None and window_ms <= 0:
            raise ValueError(f"window_ms must be > 0, got {window_ms}")
        if max_rows is not None and max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        with self._cond:
            if window_ms is not None:
                self.window_s = window_ms / 1000.0
            if max_rows is not None:
                self.max_rows = int(max_rows)
            # wake the dispatcher so a SHORTENED window re-arms its
            # deadline now instead of after the old (longer) wait
            self._cond.notify_all()
            applied = {
                "window_ms": round(self.window_s * 1e3, 3),
                "max_rows": self.max_rows,
            }
        log.info(
            f"coalescer reconfigured live: window="
            f"{applied['window_ms']}ms max_rows={applied['max_rows']}"
        )
        return applied

    def stop(self) -> None:
        """Flush everything already enqueued, then stop the dispatcher.
        Late ``submit()`` calls raise :class:`CoalescerSaturated` (the
        caller's direct-dispatch fallback), so shutdown never strands a
        request thread."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread.ident is not None:
            self._thread.join(timeout=10)

    # -- request path ------------------------------------------------------
    def submit_nowait(self, served, row: np.ndarray, on_done=None,
                      trace=None) -> _Submission:
        """Enqueue one row WITHOUT waiting: returns the submission whose
        ``event`` (pull) or ``on_done`` callback (push — must be set
        HERE, before the enqueue, or the dispatcher can complete the
        batch first and the callback never fires) signals completion.
        The asyncio front-end's bridge into the coalescer; raises
        :class:`CoalescerSaturated` exactly as :meth:`submit` does.
        ``trace``: the request's sampled span context, or None."""
        sub = _Submission(np.asarray(row, dtype=np.float32), served, on_done, trace)
        with self._cond:
            if self._stopped or not self._started:
                self._m_saturated.inc()
                raise CoalescerSaturated("coalescer is not running")
            if len(self._pending) >= self.max_pending:
                self._m_saturated.inc()
                raise CoalescerSaturated(
                    f"{len(self._pending)} requests already pending"
                )
            self._pending.append(sub)
            self.rows_submitted += 1
            self._cond.notify_all()
        return sub

    def pending_depth(self) -> int:
        """Rows enqueued or mid-dispatch — the coalescer's contribution
        to the queue-depth picture (/healthz surfaces it when no
        admission controller owns the number)."""
        with self._cond:
            return len(self._pending) + len(self._inflight)

    def submit(self, served, row: np.ndarray, timeout_s: float = 60.0,
               trace=None) -> float:
        """Enqueue one ``(1, n_features)``-shaped row against ``served``
        (the app's immutable served-model bundle) and block until its
        prediction returns. Raises :class:`CoalescerSaturated` when the
        queue is full/stopped, or the batch's own error if the device
        call failed."""
        sub = self.submit_nowait(served, row, trace=trace)
        if not sub.event.wait(timeout_s):
            raise TimeoutError(
                f"coalesced prediction not ready within {timeout_s:.0f}s"
            )
        if sub.error is not None:
            raise sub.error
        return sub.result

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every submission enqueued before this call has
        been dispatched and scattered — the hot-swap path calls this
        after an atomic model swap so no ALREADY-ENQUEUED old-model row
        is still queued when the swap returns. (A request thread that
        snapshotted the old bundle but has not yet enqueued is the same
        in-flight case as the unbatched app: it finishes on the model it
        started with — the swap bounds, it does not eliminate, the old
        generation's lifetime.) Only the submissions present at call
        time are waited on (their completion events fire on scatter,
        success or error): new traffic arriving mid-drain never extends
        the wait, so a swap under sustained load still returns promptly.
        Returns False on timeout."""
        with self._cond:
            targets = self._pending + self._inflight
        deadline = time.monotonic() + timeout_s
        for sub in targets:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not sub.event.wait(remaining):
                return False
        return True

    # -- dispatcher --------------------------------------------------------
    def _take_batch_locked(self) -> list[_Submission]:
        """The queue's leading run of submissions sharing one served
        bundle AND one row shape, up to ``max_rows``. Grouping by bundle
        identity is the hot-swap guarantee (a batch can never span a
        model swap); grouping by shape keeps a concurrent odd-width row
        (e.g. a multi-feature payload scored for its first row) from
        failing the whole stack for its neighbours."""
        head = self._pending[0]
        n = 1
        while (
            n < len(self._pending)
            and n < self.max_rows
            and self._pending[n].served is head.served
            and self._pending[n].row.shape == head.row.shape
        ):
            n += 1
        batch, self._pending = self._pending[:n], self._pending[n:]
        self._inflight.extend(batch)
        return batch

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopped:
                    self._cond.wait()
                if not self._pending and self._stopped:
                    return
                # assemble: wait out the window for neighbours unless the
                # batch fills (or a swap boundary caps it) first. The
                # deadline is anchored to the HEAD's enqueue time, not
                # this loop iteration: a row left behind by a previous
                # partial take (shape/bundle split, max_rows cap) has
                # already aged and flushes the moment its own window is
                # up — "at most one window of extra latency" holds for
                # every request, not just batch heads. A stopping
                # coalescer flushes immediately.
                # pre-wait depth classifies the flush: a backlog already
                # holding a full batch means this flush waited for
                # nothing (saturation — back-to-back full flushes)
                initial_depth = len(self._pending)
                deadline = self._pending[0].enqueued_at + self.window_s
                while not self._stopped and len(self._pending) < self.max_rows:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._take_batch_locked()
            if initial_depth >= self.max_rows:
                reason = "saturation"
            elif len(batch) >= self.max_rows:
                reason = "max_rows"
            else:
                reason = "window"
            self._execute(batch, reason)
            with self._cond:
                # single dispatcher: the in-flight set IS this batch
                self._inflight.clear()

    def _execute(self, batch: list[_Submission],
                 reason: str = "window") -> None:
        served = batch[0].served
        now = time.monotonic()
        t_exec = time.perf_counter()
        for sub in batch:
            self._m_queue_wait.observe(now - sub.enqueued_at)
        self._m_batch_rows.observe(len(batch))
        self._m_occupancy.observe(len(batch) / self.max_rows)
        self._m_flush_reason.inc(reason=reason)
        # trace fan-in: each SAMPLED member gets its queue-wait span and
        # the batch's shared device-dispatch span, which carries every
        # member's request span id as links (obs.tracing). The dispatch
        # span ends when predict returns, after the predictor's copy of
        # the results to the host, which waits for the card.
        traced = [sub for sub in batch if sub.trace is not None]
        links = [sub.trace.root_span_id for sub in traced]
        try:
            X = np.vstack([sub.row for sub in batch])
            t0 = time.perf_counter()
            predictions = served.predictor.predict(X)
            t1 = time.perf_counter()
            self._m_dispatch.observe(t1 - t0)
            for sub in traced:
                sub.trace.add("queue-wait", sub.enqueued_perf, t_exec)
                sub.trace.add("device-dispatch", t0, t1, coalesced=True,
                              batch_rows=len(batch), links=links)
            for i, sub in enumerate(batch):
                sub.result = float(predictions[i])
        except BaseException as exc:  # scatter, don't kill the dispatcher
            log.error(
                f"coalesced batch of {len(batch)} failed: {exc!r}"
            )
            for sub in batch:
                sub.error = exc
        finally:
            self.batches_dispatched += 1
            self.rows_dispatched += len(batch)
            self.max_batch_rows = max(self.max_batch_rows, len(batch))
            for sub in batch:
                sub.event.set()
                if sub.on_done is not None:
                    try:
                        # push-style completion (the asyncio bridge); a
                        # broken callback must not strand the REST of
                        # the batch or kill the dispatcher
                        sub.on_done(sub)
                    except Exception as exc:
                        log.error(f"submission on_done callback failed: {exc!r}")

    def stats(self) -> dict:
        """Dispatch accounting: ``rows_dispatched / batches_dispatched``
        is the realised mean batch size — the amortisation factor."""
        with self._cond:
            return {
                "rows_submitted": self.rows_submitted,
                "batches_dispatched": self.batches_dispatched,
                "rows_dispatched": self.rows_dispatched,
                "max_batch_rows": self.max_batch_rows,
                "window_ms": round(self.window_s * 1e3, 3),
                "max_rows": self.max_rows,
            }
