"""Admission control for the scoring service (the port of
``bodywork_tpu.serve.admission``).

Without admission control an overloaded server queues without bound:
every request eventually answers, seconds late, which a client cannot
tell from an outage. This module bounds the work the server holds and
**sheds the rest at the front door**: a 429 + ``Retry-After`` returned
before any parsing, coalescer enqueue or device work costs microseconds
and tells a well-behaved client when to come back.

:class:`AdmissionController` is the one admission point both serving
front ends share (the thread engine checks it at the top of
``ScoringApp.handle``; the asyncio engine on the event loop before it
touches the coalescer):

- **Bounded pending budget**: at most ``max_pending`` scoring requests
  admitted and unfinished at once; the next one is shed.
- **External depth probe** (:meth:`attach_depth_probe`): on the asyncio
  engine the event loop itself is a queue, upstream of the admission
  check; the probe folds its busy-connection count into the same budget.
- **EWMA queue-delay estimator**: every released request reports the
  delay it saw (admission -> response ready); the moving average, clamped
  to ``[retry_after_min_s, retry_after_max_s]``, is the ``Retry-After``
  every shed 429 and no-model 503 carries.
- **Cost-priced shed** (:meth:`AdmissionController.configure_cost_shed`,
  armed by ``serve --cost-budget-s`` from the learned cost model,
  ``tune/costmodel.py``): each request is priced in estimated
  dispatch-seconds before any work, and shed (``reason="cost"``) while
  the priced work admitted and unfinished would pass the budget.
- **Saturation signals**: the ``bodywork_tpu_serve_queue_depth`` and
  ``bodywork_tpu_serve_pending_cost_seconds`` gauges and
  ``bodywork_tpu_serve_shed_total{reason}`` (``admission`` for the
  budget, ``cost`` for the priced budget, ``drain`` during a graceful
  shutdown); ``/healthz`` shows :meth:`state`.

- **One budget across processes** (:class:`SharedBudgetSlot`, wired by
  ``serve --workers N``): every replica admits against the sum of a
  ``multiprocessing.Array('i', n)``, one slot per worker, so
  ``max_pending`` bounds the service's held work and
  ``state()["shared_pending"]`` reads it; the supervisor zeroes a dead
  worker's slot, so a crash cannot leak budget. Without it the field is
  null, as in the JAX package.
"""
from __future__ import annotations

import collections
import math
import threading

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.admission")

__all__ = [
    "DEFAULT_MAX_PENDING",
    "PENDING_COST_METRIC",
    "SHED_TOTAL_METRIC",
    "QUEUE_DEPTH_METRIC",
    "AdmissionController",
    "SharedBudgetSlot",
    "build_admission",
    "count_shed",
]

#: default pending-request budget when admission is on without an
#: explicit size (``serve --server-engine aio`` with no
#: ``--max-pending``): 512 queued single-row requests drain in ~8 full
#: 64-row flushes
DEFAULT_MAX_PENDING = 512

#: sheds by reason: ``admission`` (budget exceeded), ``drain``
#: (shutting down)
SHED_TOTAL_METRIC = "bodywork_tpu_serve_shed_total"
#: admitted-and-unfinished scoring requests; gauge aggregate ``sum``
QUEUE_DEPTH_METRIC = "bodywork_tpu_serve_queue_depth"
#: estimated dispatch-seconds of admitted-and-unfinished work while the
#: cost-priced shed is armed (:meth:`AdmissionController.configure_cost_shed`)
PENDING_COST_METRIC = "bodywork_tpu_serve_pending_cost_seconds"


def count_shed(reason: str) -> None:
    """Increment the shared shed counter (one helper, so every shedding
    layer counts into one metric)."""
    get_registry().counter(
        SHED_TOTAL_METRIC,
        "Scoring requests refused before any work, by reason "
        "(admission=budget exceeded, chaos=injected fault)",
    ).inc(reason=reason)


class SharedBudgetSlot:
    """One worker's slot in a cross-process admission budget: a
    ``multiprocessing.Array('i', n_workers)`` whose slot ``i`` only worker
    ``i`` mutates (its admitted count); an admission compares the array's
    sum, the service-wide held work, against ``max_pending`` under the
    array's one lock. Per-slot accounting heals itself: the supervisor
    zeroes a dead replica's slot before respawning it."""

    def __init__(self, array, index: int):
        self.array = array
        self.index = int(index)

    def admit(self, max_pending: int) -> tuple[bool, int]:
        """Try to take one unit; returns ``(admitted, service_total)``."""
        with self.array.get_lock():
            total = sum(self.array)
            if total >= max_pending:
                return False, total
            self.array[self.index] += 1
            return True, total + 1

    def release(self) -> None:
        with self.array.get_lock():
            if self.array[self.index] > 0:
                self.array[self.index] -= 1

    def total(self) -> int:
        with self.array.get_lock():
            return sum(self.array)

    @staticmethod
    def clear(array, index: int) -> None:
        """Zero a (dead) worker's slot: the supervisor's reclaim hook."""
        with array.get_lock():
            array[index] = 0


class AdmissionController:
    """Bounded-pending admission with an EWMA queue-delay estimator.

    Request lifecycle::

        if not admission.try_admit():
            return 429 + Retry-After: admission.retry_after_s()
        t0 = time.perf_counter()
        try:
            ... parse, enqueue, score, serialize ...
        finally:
            admission.release(time.perf_counter() - t0)

    ``try_admit`` is the only path that counts a shed; ``release`` the
    only path that shrinks the depth, so both engines wrap the whole
    handler.
    """

    def __init__(
        self,
        max_pending: int = DEFAULT_MAX_PENDING,
        ewma_alpha: float = 0.2,
        retry_after_min_s: float = 1.0,
        retry_after_max_s: float = 30.0,
        shared_slot: SharedBudgetSlot | None = None,
    ):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if not 0.0 < retry_after_min_s <= retry_after_max_s:
            raise ValueError(
                f"need 0 < retry_after_min_s <= retry_after_max_s, got "
                f"{retry_after_min_s}..{retry_after_max_s}"
            )
        self.max_pending = max_pending
        self.ewma_alpha = ewma_alpha
        self.retry_after_min_s = retry_after_min_s
        self.retry_after_max_s = retry_after_max_s
        self._lock = threading.Lock()
        #: the service-wide budget slot (``serve --workers``), or None
        self._shared = shared_slot
        self._pending = 0
        self._draining = False
        self._depth_probe = None
        #: high-water mark of the pending depth (never > max_pending)
        self.max_observed_pending = 0
        self._ewma_delay_s: float | None = None
        self._shed_count = 0
        self._admitted_count = 0
        #: the cost-priced shed (:meth:`configure_cost_shed`), off by default
        self._cost_pricer = None
        self._cost_budget_s: float | None = None
        self._pending_cost_s = 0.0
        #: per-admit estimates, one popped per release: releases may come
        #: out of order, but every admit pushes once and every release pops
        #: once, so the pending sum drains to zero with the queue
        self._cost_fifo: collections.deque = collections.deque()
        reg = get_registry()
        self._g_cost = reg.gauge(
            PENDING_COST_METRIC,
            "Estimated dispatch-seconds of admitted-and-unfinished work "
            "(cost-priced shed; 0 when unarmed)",
            aggregate="sum",
        )
        self._g_cost.set(0.0)
        self._g_depth = reg.gauge(
            QUEUE_DEPTH_METRIC,
            "Admitted-and-unfinished scoring requests (per worker; the "
            "multiproc aggregation sums replicas)",
            aggregate="sum",
        )
        self._g_depth.set(0.0)

    # -- admission ----------------------------------------------------------
    def attach_depth_probe(self, probe) -> None:
        """Register a zero-arg callable reporting work queued upstream of
        this controller (the aio engine's busy-connection count), folded
        into every admission decision, :attr:`queue_depth` and
        :meth:`state`."""
        self._depth_probe = probe

    def _external_depth(self) -> int:
        probe = self._depth_probe
        if probe is None:
            return 0
        try:
            return max(0, int(probe()))
        except Exception:  # a broken probe must never break admission
            return 0

    def begin_drain(self) -> None:
        """Graceful-shutdown mode (SIGTERM): every later ``try_admit``
        sheds (429 + Retry-After, counted ``reason="drain"``) while
        in-flight requests keep their budget and release normally.
        One-way: the process is exiting."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def configure_cost_shed(self, pricer, budget_s: float | None) -> None:
        """Arm (or, with ``pricer=None``, disarm) the cost-priced shed:
        ``pricer(rows)`` returns a request's estimated dispatch-seconds
        (``tune.costmodel.cost_pricer`` builds one from the learned cost
        model), and admission sheds (reason ``"cost"``) while the
        estimated cost of admitted-and-unfinished work would exceed
        ``budget_s``. The count budget bounds how many requests are held;
        the cost budget how much device time they represent."""
        if pricer is not None and (budget_s is None or budget_s <= 0.0):
            raise ValueError(f"cost budget_s must be > 0, got {budget_s}")
        with self._lock:
            self._cost_pricer = pricer
            self._cost_budget_s = float(budget_s) if pricer is not None else None
            if pricer is None:
                self._pending_cost_s = 0.0
                self._cost_fifo.clear()
        self._g_cost.set(self._pending_cost_s)

    def _price(self, rows: int) -> float | None:
        """Estimated dispatch-seconds of a ``rows``-row request, or None
        when unarmed or the pricer fails (a broken pricer must never
        break admission)."""
        pricer = self._cost_pricer
        if pricer is None:
            return None
        try:
            est = float(pricer(rows))
        except Exception:
            return None
        return est if est >= 0.0 and math.isfinite(est) else None

    def try_admit(self, rows: int = 1) -> bool:
        """Admit one request against the pending budget. Returns False,
        and counts the shed, when the budget is exhausted by admitted
        requests or by upstream backlog (the depth probe; ``>`` not
        ``>=`` because the probing request's own connection is part of
        that count), when the controller is draining, or when the armed
        cost-priced shed prices this request past its budget. ``rows``
        is advisory (callers that cannot know it pass 1)."""
        if self._draining:
            with self._lock:
                self._shed_count += 1
            count_shed("drain")
            return False
        est = self._price(rows)
        if est is not None:
            with self._lock:
                budget = self._cost_budget_s
                over = (
                    budget is not None
                    and self._pending_cost_s + est > budget
                    # an empty service always admits one request, or a
                    # budget below one request's cost would be an outage
                    and self._pending_cost_s > 0.0
                )
                if over:
                    self._shed_count += 1
            if over:
                count_shed("cost")
                return False
        external = self._external_depth()
        shared = self._shared
        if shared is not None:
            # the service-wide budget: the sum of every replica's admitted
            # and unfinished work (one cross-process lock, O(workers))
            if external > self.max_pending:
                admitted, shared_total = False, 0
            else:
                admitted, shared_total = shared.admit(self.max_pending)
            with self._lock:
                if admitted:
                    self._pending += 1
                    self._admitted_count += 1
                    if shared_total > self.max_observed_pending:
                        self.max_observed_pending = shared_total
                    cost = self._cost_admit_locked(est)
                else:
                    self._shed_count += 1
                    cost = None
                depth = self._pending
            self._g_depth.set(float(depth))
            if cost is not None:
                self._g_cost.set(cost)
            if not admitted:
                count_shed("admission")
                return False
            return True
        with self._lock:
            if self._pending >= self.max_pending or external > self.max_pending:
                self._shed_count += 1
                shed = True
                cost = None
            else:
                self._pending += 1
                self._admitted_count += 1
                if self._pending > self.max_observed_pending:
                    self.max_observed_pending = self._pending
                cost = self._cost_admit_locked(est)
                shed = False
            depth = max(self._pending, external)
        self._g_depth.set(float(depth))
        if cost is not None:
            self._g_cost.set(cost)
        if shed:
            count_shed("admission")
            return False
        return True

    def _cost_admit_locked(self, est: float | None) -> float | None:
        """Record an admitted request's estimate (the caller holds the
        lock); the new pending cost, or None when it was not priced."""
        if est is None:
            return None
        self._pending_cost_s += est
        self._cost_fifo.append(est)
        return self._pending_cost_s

    def release(self, observed_delay_s: float | None = None) -> None:
        """Return one unit of budget; ``observed_delay_s`` (admission ->
        response ready) feeds the EWMA estimator."""
        shared = self._shared
        external = self._external_depth() if shared is None else 0
        with self._lock:
            if self._pending > 0:
                self._pending -= 1
                if shared is not None:
                    shared.release()
                if self._cost_fifo:
                    # clamped: a mid-flight configure_cost_shed may only
                    # under-count pending cost, never shed on phantom cost
                    self._pending_cost_s = max(
                        0.0, self._pending_cost_s - self._cost_fifo.popleft())
            depth = self._pending if shared is not None else max(self._pending, external)
            cost = self._pending_cost_s
            if observed_delay_s is not None and observed_delay_s >= 0.0:
                if self._ewma_delay_s is None:
                    self._ewma_delay_s = float(observed_delay_s)
                else:
                    a = self.ewma_alpha
                    self._ewma_delay_s = (
                        a * float(observed_delay_s) + (1.0 - a) * self._ewma_delay_s
                    )
        self._g_depth.set(float(depth))
        if self._cost_pricer is not None:
            self._g_cost.set(cost)

    # -- signals ------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests held anywhere: admitted and unfinished, or queued
        upstream of admission (the depth probe); with a shared budget, the
        service-wide admitted count."""
        external = self._external_depth()
        shared = self._shared
        if shared is not None:
            return max(shared.total(), external)
        with self._lock:
            return max(self._pending, external)

    @property
    def ewma_delay_s(self) -> float | None:
        with self._lock:
            return self._ewma_delay_s

    def retry_after_s(self) -> int:
        """The numeric ``Retry-After`` (whole seconds) every backpressure
        response carries: the EWMA queue delay, ceiled, clamped to
        ``[retry_after_min_s, retry_after_max_s]``."""
        with self._lock:
            estimate = self._ewma_delay_s
        if estimate is None:
            estimate = 0.0
        clamped = min(max(estimate, self.retry_after_min_s), self.retry_after_max_s)
        return int(math.ceil(clamped))

    def state(self) -> dict:
        """The /healthz admission block, in the JAX package's schema."""
        external = self._external_depth()
        shared = self._shared
        shared_total = shared.total() if shared is not None else None
        with self._lock:
            pending = self._pending
            ewma = self._ewma_delay_s
            shed = self._shed_count
            admitted = self._admitted_count
            cost_armed = self._cost_pricer is not None
            pending_cost = self._pending_cost_s
            cost_budget = self._cost_budget_s
        budget_used = shared_total if shared_total is not None else pending
        return {
            "queue_depth": max(budget_used, external),
            "pending": pending,
            # the service-wide admitted count under serve --workers, else None
            "shared_pending": shared_total,
            "upstream_depth": external,
            "max_pending": self.max_pending,
            # the exact try_admit predicate
            "shedding": budget_used >= self.max_pending or external > self.max_pending,
            "retry_after_s": self.retry_after_s(),
            "ewma_queue_delay_s": round(ewma, 6) if ewma is not None else None,
            "admitted_total": admitted,
            "shed_total": shed,
            # the cost-priced shed: None until configure_cost_shed arms it
            "cost_shed": (
                {"pending_cost_s": round(pending_cost, 6), "budget_s": cost_budget}
                if cost_armed else None
            ),
        }


def build_admission(server_engine: str, max_pending: int | None,
                    retry_after_max_s: float | None = None, shared_slot=None):
    """The admission controller for a serving process, or ``None``: armed
    by an explicit ``max_pending`` on either engine, and by default (at
    :data:`DEFAULT_MAX_PENDING`) on the aio engine, which exists to stay
    responsive past saturation. The thread engine keeps its
    admit-everything default. ``shared_slot`` (:class:`SharedBudgetSlot`)
    makes ``max_pending`` one budget for every replica process."""
    if max_pending is None and server_engine != "aio":
        return None
    kwargs: dict = {}
    if max_pending is not None:
        kwargs["max_pending"] = max_pending
    if retry_after_max_s is not None:
        kwargs["retry_after_max_s"] = retry_after_max_s
    if shared_slot is not None:
        kwargs["shared_slot"] = shared_slot
    return AdmissionController(**kwargs)
