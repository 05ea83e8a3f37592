"""Retry policy for the scoring client: the part of
``bodywork_tpu.utils.retry`` the live-service test stage uses.

Exponential backoff with FULL jitter (sleep ~ U(0, min(base·2ᵏ, max))),
an attempt budget and a deadline budget, and a ``retry_after_s`` floor
taken from an HTTP ``Retry-After`` header. The transient allowlist is
matched by exception-class name through the MRO, as in the reference.
"""
from __future__ import annotations

import dataclasses
import random
import time

__all__ = ["RetryPolicy", "call_with_retry", "full_jitter_delay", "is_transient"]

#: exception type names treated as transient (connection-level failures);
#: an ALLOWLIST: unknown errors are not retried
TRANSIENT_ERROR_NAMES = frozenset({
    "ConnectionError",
    "ConnectionResetError",
    "ConnectionRefusedError",
    "BrokenPipeError",
    "TimeoutError",
    "URLError",
})


def is_transient(exc: BaseException) -> bool:
    return any(t.__name__ in TRANSIENT_ERROR_NAMES for t in type(exc).__mro__)


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
