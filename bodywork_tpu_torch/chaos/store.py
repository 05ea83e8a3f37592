"""Transparent fault-injecting store wrapper (the port's copy of
``bodywork_tpu.chaos.store``: the same decisions on the same op streams).

:class:`FaultInjectingStore` wraps any backend and injects the active
:class:`~bodywork_tpu_torch.chaos.plan.FaultPlan`'s store faults at the
primitive ops. It derives from
:class:`~bodywork_tpu_torch.store.base.DelegatingStore`, so it composes with
the rest of the wrapper stack exactly like the epoch guard does — and
because it declares no ``backend_label``, the real backend's
``bodywork_tpu_store_ops_total`` instrumentation keeps counting each
delegated call once, at the backend.

Injection semantics, chosen so every fault is *recoverable by the layer
above* (the point of the harness is to prove recovery, not to corrupt
state invisibly):

- **transient** faults raise BEFORE the op touches the backend — a
  retried op re-runs cleanly (a delete can never half-apply);
- **torn writes** persist a payload PREFIX and then raise a transient
  error — the retry's full rewrite repairs it (and if every retry were
  exhausted, the final-artefact comparison would catch the torn bytes);
- **corrupt reads** truncate the returned payload, only for key
  prefixes whose consumers carry an integrity check
  (``plan.corrupt_prefixes``: the snapshot loader validates row counts
  and falls back; registry readers validate the JSON schema and re-read
  under the consecutive cap — ``registry/records.py``);
- **latency** sleeps briefly before the op;
- ``version_token``/``version_tokens``/``exists`` get latency only:
  the token contract is "never raise".

Each op execution takes exactly ONE failure decision
(``plan.store_fault``): all failing kinds share the op stream's
consecutive-failure streak, so the plan's ``max_consecutive`` cap bounds
total consecutive failures — independent per-kind caps would compose
past the retry budget. ``get_many`` is likewise a single failure unit
(one decision per batch execution, matching the resilience layer's
retry-the-whole-batch semantics), with corruption still applied per key;
it reads sequentially so fault streams stay deterministic, trading the
backend's parallel fan-out for reproducibility — the right trade inside
a chaos run.
"""
from __future__ import annotations

from bodywork_tpu_torch.chaos.plan import FaultPlan, InjectedFault
from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore

__all__ = ["FaultInjectingStore"]


class FaultInjectingStore(DelegatingStore):
    def __init__(self, inner: ArtefactStore, plan: FaultPlan):
        super().__init__(inner)
        self.plan = plan

    def _maybe_fail(self, op: str, key: str) -> None:
        if self.plan.store_fault(op, key) == "transient":
            raise InjectedFault(f"injected transient store error: {op} {key!r}")

    def put_bytes(self, key: str, data: bytes) -> None:
        self.plan.store_latency("put_bytes", key)
        fault = self.plan.store_fault("put_bytes", key)
        if fault == "transient":
            raise InjectedFault(
                f"injected transient store error: put_bytes {key!r}"
            )
        if fault == "torn_write":
            self._inner.put_bytes(key, data[: max(1, len(data) // 2)])
            raise InjectedFault(
                f"injected crash after partial write of {key!r}"
            )
        self._inner.put_bytes(key, data)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        # transient-BEFORE faults only (no torn variant: the backend CAS
        # is atomic — tmp+rename / if_generation_match — so there is no
        # partial-payload state to simulate, and an applied-then-failed
        # injection would surface as a CasConflict the filesystem
        # backend cannot disambiguate, breaking the byte-identical
        # soak). The resilience layer's retry absorbs these within the
        # consecutive cap like any other op.
        self.plan.store_latency("put_bytes_if_match", key)
        self._maybe_fail("put_bytes_if_match", key)
        return self._inner.put_bytes_if_match(key, data, expected_token)

    def get_bytes(self, key: str) -> bytes:
        self.plan.store_latency("get_bytes", key)
        self._maybe_fail("get_bytes", key)
        return self.plan.corrupt_read(key, self._inner.get_bytes(key))

    def list_keys(self, prefix: str = "") -> list[str]:
        self.plan.store_latency("list_keys", prefix)
        self._maybe_fail("list_keys", prefix)
        return self._inner.list_keys(prefix)

    def delete(self, key: str) -> None:
        self.plan.store_latency("delete", key)
        self._maybe_fail("delete", key)
        self._inner.delete(key)

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        # ONE failure decision for the whole batch (its stream is stable
        # across same-batch retries), then sequential per-key reads with
        # per-key corruption — the batch is the retry layer's failure
        # unit, so per-key transient streams would let N independent
        # caps compose past one batch's retry budget
        if keys:
            batch_id = f"{keys[0]}..{keys[-1]}|{len(keys)}"
            self.plan.store_latency("get_many", batch_id)
            self._maybe_fail("get_many", batch_id)
        return {
            key: self.plan.corrupt_read(key, self._inner.get_bytes(key))
            for key in keys
        }

    def exists(self, key: str) -> bool:
        self.plan.store_latency("exists", key)
        return self._inner.exists(key)

    def version_token(self, key: str):
        self.plan.store_latency("version_token", key)
        return self._inner.version_token(key)

    def version_tokens(self, keys: list[str]) -> dict[str, object]:
        self.plan.store_latency("version_tokens", keys[0] if keys else "")
        return self._inner.version_tokens(keys)
