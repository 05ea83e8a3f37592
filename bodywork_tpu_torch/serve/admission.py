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
- **Saturation signals**: the ``bodywork_tpu_serve_queue_depth`` gauge
  and ``bodywork_tpu_serve_shed_total{reason}`` (``admission`` for the
  budget, ``drain`` during a graceful shutdown); ``/healthz`` shows
  :meth:`state`.

The JAX package's cross-process budget (``SharedBudgetSlot``, for
``serve --workers``) and its cost-priced shed (for the online tuner) are
later slices; here ``state()["shared_pending"]`` and
``state()["cost_shed"]`` are always null, as they are in the JAX package
without those options.
"""
from __future__ import annotations

import math
import threading

from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.admission")

__all__ = [
    "DEFAULT_MAX_PENDING",
    "SHED_TOTAL_METRIC",
    "QUEUE_DEPTH_METRIC",
    "AdmissionController",
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


def count_shed(reason: str) -> None:
    """Increment the shared shed counter (one helper, so every shedding
    layer counts into one metric)."""
    get_registry().counter(
        SHED_TOTAL_METRIC,
        "Scoring requests refused before any work, by reason "
        "(admission=budget exceeded, chaos=injected fault)",
    ).inc(reason=reason)


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
        self._pending = 0
        self._draining = False
        self._depth_probe = None
        #: high-water mark of the pending depth (never > max_pending)
        self.max_observed_pending = 0
        self._ewma_delay_s: float | None = None
        self._shed_count = 0
        self._admitted_count = 0
        self._g_depth = get_registry().gauge(
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

    def try_admit(self) -> bool:
        """Admit one request against the pending budget. Returns False,
        and counts the shed, when the budget is exhausted by admitted
        requests or by upstream backlog (the depth probe; ``>`` not
        ``>=`` because the probing request's own connection is part of
        that count), or when the controller is draining."""
        if self._draining:
            with self._lock:
                self._shed_count += 1
            count_shed("drain")
            return False
        external = self._external_depth()
        with self._lock:
            if self._pending >= self.max_pending or external > self.max_pending:
                self._shed_count += 1
                shed = True
            else:
                self._pending += 1
                self._admitted_count += 1
                if self._pending > self.max_observed_pending:
                    self.max_observed_pending = self._pending
                shed = False
            depth = max(self._pending, external)
        self._g_depth.set(float(depth))
        if shed:
            count_shed("admission")
            return False
        return True

    def release(self, observed_delay_s: float | None = None) -> None:
        """Return one unit of budget; ``observed_delay_s`` (admission ->
        response ready) feeds the EWMA estimator."""
        external = self._external_depth()
        with self._lock:
            if self._pending > 0:
                self._pending -= 1
            depth = max(self._pending, external)
            if observed_delay_s is not None and observed_delay_s >= 0.0:
                if self._ewma_delay_s is None:
                    self._ewma_delay_s = float(observed_delay_s)
                else:
                    a = self.ewma_alpha
                    self._ewma_delay_s = (
                        a * float(observed_delay_s) + (1.0 - a) * self._ewma_delay_s
                    )
        self._g_depth.set(float(depth))

    # -- signals ------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests held anywhere: admitted and unfinished, or queued
        upstream of admission (the depth probe)."""
        external = self._external_depth()
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
        with self._lock:
            pending = self._pending
            ewma = self._ewma_delay_s
            shed = self._shed_count
            admitted = self._admitted_count
        return {
            "queue_depth": max(pending, external),
            "pending": pending,
            "shared_pending": None,
            "upstream_depth": external,
            "max_pending": self.max_pending,
            # the exact try_admit predicate
            "shedding": pending >= self.max_pending or external > self.max_pending,
            "retry_after_s": self.retry_after_s(),
            "ewma_queue_delay_s": round(ewma, 6) if ewma is not None else None,
            "admitted_total": admitted,
            "shed_total": shed,
            "cost_shed": None,
        }


def build_admission(server_engine: str, max_pending: int | None,
                    retry_after_max_s: float | None = None):
    """The admission controller for a serving process, or ``None``: armed
    by an explicit ``max_pending`` on either engine, and by default (at
    :data:`DEFAULT_MAX_PENDING`) on the aio engine, which exists to stay
    responsive past saturation. The thread engine keeps its
    admit-everything default."""
    if max_pending is None and server_engine != "aio":
        return None
    kwargs: dict = {}
    if max_pending is not None:
        kwargs["max_pending"] = max_pending
    if retry_after_max_s is not None:
        kwargs["retry_after_max_s"] = retry_after_max_s
    return AdmissionController(**kwargs)
