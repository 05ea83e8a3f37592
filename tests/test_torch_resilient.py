"""The port's resilience layer against the JAX package's: the error
taxonomy, the circuit breaker's state machine, and ``ResilientStore`` over
the fault-injecting store (the cases of ``tests/test_chaos.py``'s retry and
breaker section, run on the port's classes)."""
import pathlib
import urllib.error

import pytest

from bodywork_tpu.utils import retry as jax_retry
from bodywork_tpu_torch.chaos.plan import FaultPlan, InjectedFault
from bodywork_tpu_torch.chaos.store import FaultInjectingStore
from bodywork_tpu_torch.obs import get_registry
from bodywork_tpu_torch.store import ArtefactNotFound, CasConflict, FilesystemStore
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.resilient import ResilientStore
from bodywork_tpu_torch.utils import retry
from bodywork_tpu_torch.utils.retry import CircuitBreaker, CircuitOpenError, RetryPolicy

FAST = RetryPolicy(attempts=4, base_delay_s=0.0001, max_delay_s=0.001)


def _named(name: str, base=Exception):
    return type(name, (base,), {})


def _caused(exc: BaseException, cause: BaseException) -> BaseException:
    exc.__cause__ = cause
    return exc


def _cases():
    """One exception per class of the taxonomy, by name (an optional
    dependency's class counts without being importable), through the MRO
    and down the cause chain."""
    return {
        "service_unavailable": _named("ServiceUnavailable")(),
        "too_many_requests": _named("TooManyRequests")(),
        "gateway_timeout": _named("GatewayTimeout")(),
        "read_timeout": _named("ReadTimeout")(),
        "connection_reset": ConnectionResetError(),
        "connection_refused": ConnectionRefusedError(),
        "broken_pipe": BrokenPipeError(),
        "timeout": TimeoutError(),
        "subclass_of_transient": _named("Flaky", ConnectionError)(),
        "value_error": ValueError("bad"),
        "key_error": KeyError("k"),
        "artefact_not_found": ArtefactNotFound("k"),
        "type_error": TypeError(),
        "not_implemented": NotImplementedError(),
        "runtime_error": RuntimeError(),
        "os_error": OSError(),
        "circuit_open": CircuitOpenError(),
        "cas_conflict": CasConflict(),
        "wrapped_transient": _caused(RuntimeError("stage"), ConnectionResetError()),
        "wrapped_permanent": _caused(RuntimeError("stage"), ValueError()),
        "value_error_from_transient": _caused(ValueError("x"), TimeoutError()),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_error_taxonomy_equals_jaxs(case):
    exc = _cases()[case]
    assert retry.classify_error(exc) == jax_retry.classify_error(exc)
    assert retry.is_transient(exc) == jax_retry.is_transient(exc)
    assert retry.is_permanent(exc) == jax_retry.is_permanent(exc)


def test_the_allowlist_is_jaxs_plus_urllibs_url_error():
    """The port's scoring client raises ``urllib``'s ``URLError`` where
    the JAX one raises ``requests``' classes: that name is the port's one
    addition."""
    assert retry.TRANSIENT_ERROR_NAMES - jax_retry.TRANSIENT_ERROR_NAMES == {"URLError"}
    assert jax_retry.TRANSIENT_ERROR_NAMES <= retry.TRANSIENT_ERROR_NAMES
    assert retry.is_transient(urllib.error.URLError("refused"))
    assert retry.PERMANENT_ERROR_TYPES == jax_retry.PERMANENT_ERROR_TYPES


def test_a_failed_stage_is_permanent_as_jaxs_stage_error():
    from bodywork_tpu.utils.errors import StageError
    from bodywork_tpu_torch.pipeline.runner import StageFailure

    assert retry.classify_error(StageFailure("s", "m")) == "permanent"
    assert jax_retry.classify_error(StageError("s", "m")) == "permanent"
    wrapped = _caused(StageFailure("s", "m"), ConnectionResetError())
    assert retry.classify_error(wrapped) == "transient"


def _drive_breaker(module):
    t = [0.0]
    states = []
    breaker = module.CircuitBreaker(
        failure_threshold=3, reset_timeout_s=10.0, clock=lambda: t[0],
        on_state_change=states.append,
    )
    trace = [breaker.state]
    for _ in range(2):
        breaker.allow()
        breaker.record_failure()
    trace.append(breaker.state)
    breaker.allow()
    breaker.record_failure()
    trace.append(breaker.state)
    with pytest.raises(module.CircuitOpenError):
        breaker.allow()
    t[0] = 10.0
    breaker.allow()
    trace.append(breaker.state)
    with pytest.raises(module.CircuitOpenError):
        breaker.allow()
    breaker.record_failure()
    trace.append(breaker.state)
    t[0] = 25.0
    breaker.allow()
    breaker.record_success()
    trace.append(breaker.state)
    return trace, states


def test_breaker_state_machine_equals_jaxs():
    trace, states = _drive_breaker(retry)
    assert (trace, states) == _drive_breaker(jax_retry)
    assert trace == ["closed", "closed", "open", "half_open", "open", "closed"]
    assert states == ["open", "half_open", "open", "half_open", "closed"]
    assert CircuitBreaker.STATE_VALUES == jax_retry.CircuitBreaker.STATE_VALUES


def test_breaker_half_open_probe_slot_recovers_from_wedged_probe():
    t = [0.0]
    breaker = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0, clock=lambda: t[0])
    breaker.allow()
    breaker.record_failure()
    t[0] = 5.0
    breaker.allow()  # the probe, which never reports back
    with pytest.raises(CircuitOpenError):
        breaker.allow()
    t[0] = 10.0
    breaker.allow()  # its stale slot is taken over
    breaker.record_success()
    assert breaker.state == "closed"


def test_breaker_hook_may_read_the_state_without_deadlock():
    seen = []
    breaker = CircuitBreaker(failure_threshold=1)
    breaker.on_state_change = lambda state: seen.append((state, breaker.state))
    breaker.allow()
    breaker.record_failure()
    assert seen == [("open", "open")]


def test_resilient_store_absorbs_capped_transients(tmp_path):
    plan = FaultPlan(seed=1, store_transient_p=1.0, max_consecutive=2)
    store = ResilientStore(FaultInjectingStore(FilesystemStore(tmp_path), plan), policy=FAST)
    store.put_bytes("datasets/a.csv", b"hello")
    assert store.get_bytes("datasets/a.csv") == b"hello"
    assert store.list_keys("datasets/") == ["datasets/a.csv"]
    assert store.breaker.state == "closed"


def test_torn_write_is_repaired_by_retry(tmp_path):
    plan = FaultPlan(seed=1, torn_write_p=1.0, max_consecutive=2)
    inner = FilesystemStore(tmp_path)
    store = ResilientStore(FaultInjectingStore(inner, plan), policy=FAST)
    payload = bytes(range(64))
    store.put_bytes("models/m.npz", payload)
    assert inner.get_bytes("models/m.npz") == payload


def _retry_count(op: str, backend: str) -> float:
    return get_registry().counter("bodywork_tpu_store_retries_total").value(
        backend=backend, op=op)


_OPS = ("put_bytes", "put_bytes_if_match", "get_bytes", "get_many", "list_keys", "delete",
        "exists")


class _FlakyOnce(ArtefactStore):
    """Raises one transient error per op name, then delegates."""

    def __init__(self, inner):
        self._inner = inner
        self._failed = set()

    def _flaky(self, name, *args):
        if name not in self._failed:
            self._failed.add(name)
            raise type("ServiceUnavailable", (Exception,), {})(f"injected {name}")
        return getattr(self._inner, name)(*args)

    def put_bytes(self, key, data):
        return self._flaky("put_bytes", key, data)

    def put_bytes_if_match(self, key, data, expected_token=None):
        return self._flaky("put_bytes_if_match", key, data, expected_token)

    def get_bytes(self, key):
        return self._flaky("get_bytes", key)

    def get_many(self, keys):
        return self._flaky("get_many", keys)

    def list_keys(self, prefix=""):
        return self._flaky("list_keys", prefix)

    def delete(self, key):
        return self._flaky("delete", key)

    def exists(self, key):
        return self._flaky("exists", key)


def test_every_public_op_routes_through_the_shared_retry_policy(tmp_path):
    """Each op, the registry's CAS included, absorbs one transient failure
    and reports the retry through the one shared counter."""
    inner = FilesystemStore(tmp_path)
    inner.put_bytes("datasets/a.csv", b"x")
    store = ResilientStore(_FlakyOnce(inner), policy=FAST, label="guardtest")
    before = {op: _retry_count(op, "guardtest") for op in _OPS}
    store.put_bytes("datasets/b.csv", b"y")
    store.put_bytes_if_match("registry/aliases.json", b"v1", None)
    assert store.get_bytes("datasets/a.csv") == b"x"
    assert store.get_many(["datasets/a.csv"]) == {"datasets/a.csv": b"x"}
    assert store.list_keys("datasets/") == ["datasets/a.csv", "datasets/b.csv"]
    assert store.exists("datasets/a.csv")
    store.delete("datasets/b.csv")
    for op in _OPS:
        assert _retry_count(op, "guardtest") == before[op] + 1, op


def test_a_lost_cas_race_is_not_retried(tmp_path):
    store = ResilientStore(FilesystemStore(tmp_path), policy=FAST, label="castest")
    store.put_bytes_if_match("registry/aliases.json", b"v1", None)
    before = _retry_count("put_bytes_if_match", "castest")
    with pytest.raises(CasConflict):
        store.put_bytes_if_match("registry/aliases.json", b"v2", None)
    assert _retry_count("put_bytes_if_match", "castest") == before
    assert store.breaker.state == "closed"


def test_no_private_backoff_loops_in_the_ports_store_modules():
    import bodywork_tpu_torch.store as store_pkg
    from bodywork_tpu_torch.store import gcs

    for path in sorted(pathlib.Path(store_pkg.__file__).parent.glob("*.py")):
        source = path.read_text()
        assert "time.sleep" not in source, f"{path.name} sleeps privately"
        assert "delay *=" not in source, f"{path.name} grows its own backoff"
    assert gcs.call_with_retry is retry.call_with_retry


class _Counting(FilesystemStore):
    def __init__(self, root):
        super().__init__(root)
        self.gets = 0

    def get_bytes(self, key):
        self.gets += 1
        return super().get_bytes(key)


def test_breaker_opens_fast_fails_and_recovers_through_the_store(tmp_path):
    t = [0.0]
    breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=5.0, clock=lambda: t[0])
    plan = FaultPlan(seed=1, store_transient_p=1.0, max_consecutive=0)
    counting = _Counting(tmp_path)
    counting.put_bytes("datasets/a.csv", b"x")
    store = ResilientStore(FaultInjectingStore(counting, plan),
                           policy=RetryPolicy(attempts=2, base_delay_s=0.0001),
                           breaker=breaker, label="breakertest")
    gauge = get_registry().get("bodywork_tpu_store_breaker_state")
    for _ in range(2):
        with pytest.raises(InjectedFault):
            store.get_bytes("datasets/a.csv")
    assert breaker.state == "open"
    assert gauge.value(backend="breakertest") == 2.0
    reached = counting.gets
    with pytest.raises(CircuitOpenError):
        store.get_bytes("datasets/a.csv")
    assert counting.gets == reached  # rejected without touching the backend
    plan.store_transient_p = 0.0
    t[0] = 6.0
    assert store.get_bytes("datasets/a.csv") == b"x"
    assert breaker.state == "closed"
    assert gauge.value(backend="breakertest") == 0.0


def test_resilient_store_labels_by_the_innermost_backend(tmp_path):
    from bodywork_tpu_torch.audit import AuditedStore

    store = ResilientStore(AuditedStore(FilesystemStore(tmp_path)))
    assert store._label == "filesystem"
    assert store._policy == RetryPolicy()
