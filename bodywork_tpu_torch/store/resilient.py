"""Resilience layer over any artefact-store backend: retries + breaker
(the port's copy of ``bodywork_tpu.store.resilient``).

:class:`ResilientStore` wraps any :class:`~bodywork_tpu_torch.store.base.
ArtefactStore` and routes every fallible public op (``put_bytes``,
``get_bytes``, ``get_many``, ``list_keys``, ``delete``, ``exists``)
through the shared retry policy (:mod:`bodywork_tpu_torch.utils.retry`:
transient-only, exponential backoff with full jitter, per-op deadline
budget) and a circuit breaker:

- **closed** — ops flow; consecutive op-level transient failures (i.e.
  failures that survived the retry budget) are counted;
- **open** — after ``failure_threshold`` consecutive failures, ops
  fast-fail with :class:`~bodywork_tpu_torch.utils.retry.CircuitOpenError`
  without touching the backend, until ``reset_timeout_s`` elapses;
- **half-open** — one probe op is admitted; success closes the breaker,
  failure re-opens it.

``version_token``/``version_tokens`` delegate un-retried: their contract
is "never raise", and backends with remote tokens (GCS) already retry
internally through the same shared policy.

Exported metrics: ``bodywork_tpu_store_retries_total{backend,op}`` (one
increment per backoff sleep — shared with the GCS backend's internal
retries) and ``bodywork_tpu_store_breaker_state{backend}`` (0=closed,
1=half-open, 2=open).

Composition (see ``store/base.py``): the chaos fault injector sits
BELOW this wrapper, so injected faults exercise exactly the retry and
breaker paths production faults would; the per-attempt epoch guard sits
above.
"""
from __future__ import annotations

from bodywork_tpu_torch.store.base import (
    ArtefactStore,
    DelegatingStore,
    innermost_backend,
)
from bodywork_tpu_torch.utils.retry import (
    CircuitBreaker,
    RetryPolicy,
    call_with_retry,
    is_transient,
)

__all__ = ["ResilientStore"]


class ResilientStore(DelegatingStore):
    def __init__(
        self,
        inner: ArtefactStore,
        policy: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        label: str | None = None,
    ):
        super().__init__(inner)
        backend = innermost_backend(inner)
        if policy is None:
            # Exactly ONE layer owns retrying: DIRECTLY over a backend
            # whose ops already run under the shared policy internally
            # (GCS), this wrapper contributes only the breaker — a second
            # retry loop would multiply attempt budgets and double-count
            # the metric. The check is on the IMMEDIATE inner store, not
            # the innermost backend: a wrapper in between (the chaos
            # fault injector) raises failures ABOVE the backend's
            # internal loop, and those only this layer can retry.
            policy = (
                RetryPolicy(attempts=1)
                if inner.self_retrying
                else RetryPolicy()
            )
        self._policy = policy
        self._label = label or (
            backend.backend_label if backend is not None else None
        ) or "wrapped"
        from bodywork_tpu_torch.obs import get_registry

        reg = get_registry()
        self._retries = reg.counter(
            "bodywork_tpu_store_retries_total",
            "Artefact-store op retries by backend and op",
        )
        self._breaker_gauge = reg.gauge(
            "bodywork_tpu_store_breaker_state",
            "Store circuit-breaker state: 0=closed, 1=half-open, 2=open",
            aggregate="max",
        )
        if breaker is None:
            breaker = CircuitBreaker()
        # chain, don't clobber: a caller-installed state hook (e.g. an
        # alerting callback on a supplied breaker) keeps firing alongside
        # the gauge export
        caller_hook = breaker.on_state_change
        if caller_hook is None:
            breaker.on_state_change = self._record_state
        else:
            def _both(state, _caller=caller_hook):
                self._record_state(state)
                _caller(state)

            breaker.on_state_change = _both
        self._breaker = breaker
        self._record_state(breaker.state)

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def _record_state(self, state: str) -> None:
        self._breaker_gauge.set(
            CircuitBreaker.STATE_VALUES[state], backend=self._label
        )

    def _guarded(self, op: str, fn):
        """One public op: breaker admission ONCE (so a half-open probe is
        one op, internal retries included), then the shared retry policy
        around the delegated call. The breaker counts OP-level outcomes
        (a transient failure that survives the whole retry budget), not
        per-attempt ones — the retry layer is the first line of defence,
        the breaker the backstop behind it. Every admitted op records an
        outcome: a NON-transient error (e.g. ``ArtefactNotFound``) counts
        as success — the backend answered, which is exactly the health
        signal the breaker watches."""
        self._breaker.allow()  # raises CircuitOpenError when open

        def on_retry(exc, n, sleep_s):
            self._retries.inc(backend=self._label, op=op)

        try:
            result = call_with_retry(fn, self._policy, on_retry=on_retry)
        except Exception as exc:
            if is_transient(exc):
                self._breaker.record_failure()
            else:
                self._breaker.record_success()
            raise
        self._breaker.record_success()
        return result

    # -- guarded public ops ------------------------------------------------

    def put_bytes(self, key: str, data: bytes) -> None:
        self._guarded("put_bytes", lambda: self._inner.put_bytes(key, data))

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        # CAS rides the same retry+breaker as every other op. Safe to
        # retry: CasConflict is not on the transient allowlist (a lost
        # race propagates immediately, attempt budget intact), and a
        # transient failure AFTER the write applied surfaces on retry as
        # a conflict the backend disambiguates (GCS's own-write
        # post-check turns it back into success)
        return self._guarded(
            "put_bytes_if_match",
            lambda: self._inner.put_bytes_if_match(key, data, expected_token),
        )

    def get_bytes(self, key: str) -> bytes:
        return self._guarded("get_bytes", lambda: self._inner.get_bytes(key))

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        # retried as a unit: the delegated call fully materialises its
        # result, so a retry re-fetches the whole batch (never splices
        # two half-batches from different attempts)
        return self._guarded("get_many", lambda: self._inner.get_many(keys))

    def list_keys(self, prefix: str = "") -> list[str]:
        return self._guarded("list_keys", lambda: self._inner.list_keys(prefix))

    def delete(self, key: str) -> None:
        self._guarded("delete", lambda: self._inner.delete(key))

    def exists(self, key: str) -> bool:
        return self._guarded("exists", lambda: self._inner.exists(key))
