"""Resilience primitives (the port's copy of ``bodywork_tpu.utils.retry``):
the error taxonomy, the retry policy and the circuit breaker.

- **Taxonomy**: :func:`is_transient` (an allowlist matched by
  exception-class NAME through the MRO, so an optional dependency's
  classes count without being importable), :func:`is_permanent` and
  :func:`classify_error`, which walks the ``__cause__``/``__context__``
  chain so a wrapped transient error keeps its retryability.
- **Policy**: :class:`RetryPolicy` + :func:`call_with_retry`, exponential
  backoff with FULL jitter (sleep ~ U(0, min(base·2ᵏ, max))), an attempt
  budget, a deadline budget and a ``retry_after_s`` floor taken from an
  HTTP ``Retry-After`` header.
- **Breaker**: :class:`CircuitBreaker`, closed -> open after N
  consecutive failures -> one half-open probe -> closed on its success;
  ``store.resilient.ResilientStore`` wires it over any store backend.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

from bodywork_tpu_torch.utils.errors import StageError

__all__ = [
    "TRANSIENT_ERROR_NAMES",
    "PERMANENT_ERROR_TYPES",
    "TransientError",
    "is_transient",
    "is_permanent",
    "classify_error",
    "RetryPolicy",
    "call_with_retry",
    "full_jitter_delay",
    "CircuitBreaker",
    "CircuitOpenError",
]

#: exception type names treated as transient: the JAX package's allowlist
#: (google.api_core's 503/429/5xx classes, connection-level failures, this
#: module's marker class) plus ``URLError``, which the port's urllib
#: scoring client raises where the JAX one raises ``requests``' classes.
#: An ALLOWLIST: unknown errors are not retried
TRANSIENT_ERROR_NAMES = frozenset({
    "ServiceUnavailable",
    "TooManyRequests",
    "InternalServerError",
    "BadGateway",
    "GatewayTimeout",
    "DeadlineExceeded",
    "RetryError",
    "ConnectionError",
    "ConnectionResetError",
    "BrokenPipeError",
    "TimeoutError",
    "Timeout",
    "ConnectTimeout",
    "ReadTimeout",
    "URLError",
    "TransientError",
})

#: deterministic failures: retrying can never succeed (``ArtefactNotFound``
#: is a ``KeyError`` and lands here)
PERMANENT_ERROR_TYPES = (
    ValueError,
    TypeError,
    KeyError,
    AttributeError,
    NotImplementedError,
)


class TransientError(Exception):
    """A failure expected to clear on retry (the chaos plan's injected
    faults subclass it). ``retry_after_s``, where the failing side names
    one, floors the jittered sleep of :func:`call_with_retry`."""

    retry_after_s: float | None = None


def is_transient(exc: BaseException) -> bool:
    return any(t.__name__ in TRANSIENT_ERROR_NAMES for t in type(exc).__mro__)


def _chain(exc: BaseException, limit: int = 8):
    seen = set()
    while exc is not None and id(exc) not in seen and limit > 0:
        seen.add(id(exc))
        limit -= 1
        yield exc
        exc = exc.__cause__ or exc.__context__


def is_permanent(exc: BaseException) -> bool:
    """True when ``exc`` is a deterministic failure (a denylist match with
    no transient error anywhere in its cause chain)."""
    return classify_error(exc) == "permanent"


def classify_error(exc: BaseException) -> str:
    """``"transient"`` | ``"permanent"`` | ``"unknown"``: a transient
    error anywhere in the cause chain wins, then the permanent denylist
    (and a failed stage, :class:`~bodywork_tpu_torch.utils.errors.StageError`),
    then ``"unknown"``, which each caller treats
    per its own default."""
    if any(is_transient(e) for e in _chain(exc)):
        return "transient"
    if isinstance(exc, (*PERMANENT_ERROR_TYPES, StageError)):
        return "permanent"
    return "unknown"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with full jitter and a deadline budget.
    ``attempts`` includes the first try; ``deadline_s`` caps the
    cumulative time (op time + sleeps) across retries."""

    attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 2.0
    deadline_s: float = 30.0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")


def full_jitter_delay(attempt: int, base_s: float, max_s: float) -> float:
    """``U(0, min(base·2^attempt, max))`` (attempt 0 = first retry)."""
    cap = min(base_s * (2 ** max(0, attempt)), max_s)
    if cap <= 0:
        return 0.0
    return random.uniform(0.0, cap)


def call_with_retry(fn, policy: RetryPolicy = RetryPolicy(), *,
                    is_retryable=is_transient, on_retry=None):
    """Run ``fn()`` under ``policy``, retrying failures ``is_retryable``
    accepts until the attempt or deadline budget runs out (then the last
    error propagates). A ``retry_after_s`` attribute on the error floors
    the jittered sleep, up to ``policy.max_delay_s``. ``on_retry(exc,
    attempt, sleep_s)`` fires before each backoff sleep: the hook through
    which a caller counts its retries (this module stays metric-free)."""
    start = time.monotonic()
    for attempt in range(policy.attempts):
        try:
            return fn()
        except Exception as exc:
            if not is_retryable(exc) or attempt == policy.attempts - 1:
                raise
            remaining = policy.deadline_s - (time.monotonic() - start)
            if remaining <= 0:
                raise
            delay = full_jitter_delay(
                attempt, policy.base_delay_s, policy.max_delay_s
            )
            floor = getattr(exc, "retry_after_s", None)
            if floor:
                delay = max(delay, min(float(floor), policy.max_delay_s))
            delay = min(delay, remaining)
            if on_retry is not None:
                on_retry(exc, attempt + 1, delay)
            time.sleep(delay)


class CircuitOpenError(RuntimeError):
    """Fast-fail: the breaker is open. Neither transient (a store retry
    loop must not spin against an open breaker) nor permanent (a stage
    retry may succeed once the backend recovers)."""


class CircuitBreaker:
    """closed -> open after ``failure_threshold`` consecutive failures ->
    (after ``reset_timeout_s``) half-open, admitting ONE probe -> closed
    on its success, open again on its failure.

    Callers bracket each op: :meth:`allow` before (raises
    :class:`CircuitOpenError` when rejecting), then exactly one of
    :meth:`record_success` / :meth:`record_failure`. ``on_state_change``
    receives each new state name, fired outside the lock so a hook that
    reads ``state`` cannot deadlock."""

    CLOSED = "closed"
    HALF_OPEN = "half_open"
    OPEN = "open"

    #: gauge encoding of the state machine
    STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}

    def __init__(self, failure_threshold: int = 5, reset_timeout_s: float = 30.0,
                 clock=time.monotonic, on_state_change=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self.on_state_change = on_state_change
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at: float | None = None
        self._probe_in_flight = False
        self._probe_started_at: float | None = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str) -> str | None:
        """Apply a transition (lock held) and return the state to notify
        for, or None."""
        if state == self._state:
            return None
        self._state = state
        return state

    def _notify(self, state: str | None) -> None:
        if state is not None and self.on_state_change is not None:
            self.on_state_change(state)

    def allow(self) -> None:
        """Admit one op or raise :class:`CircuitOpenError`."""
        notify = None
        with self._lock:
            if self._state == self.OPEN:
                if (self._opened_at is not None
                        and self._clock() - self._opened_at >= self.reset_timeout_s):
                    notify = self._set_state(self.HALF_OPEN)
                    self._probe_in_flight = True
                    self._probe_started_at = self._clock()
                else:
                    raise CircuitOpenError(
                        f"circuit open after {self._consecutive} consecutive "
                        f"failures; probing again in <= {self.reset_timeout_s}s"
                    )
            elif self._state == self.HALF_OPEN:
                if self._probe_in_flight:
                    # a probe that never reported back must not wedge the
                    # breaker half-open: after the reset timeout its slot
                    # is taken over
                    if (self._probe_started_at is not None
                            and self._clock() - self._probe_started_at
                            >= self.reset_timeout_s):
                        self._probe_started_at = self._clock()
                    else:
                        raise CircuitOpenError("half-open probe already in flight")
                else:
                    self._probe_in_flight = True
                    self._probe_started_at = self._clock()
        self._notify(notify)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_in_flight = False
            self._opened_at = None
            notify = self._set_state(self.CLOSED)
        self._notify(notify)

    def record_failure(self) -> None:
        notify = None
        with self._lock:
            self._probe_in_flight = False
            self._consecutive += 1
            if self._state == self.HALF_OPEN or self._consecutive >= self.failure_threshold:
                self._opened_at = self._clock()
                notify = self._set_state(self.OPEN)
        self._notify(notify)
