"""Artefact store interface (the port's copy of ``bodywork_tpu.store.base``,
cut to what the serving slice uses).

A flat byte store with ``/``-separated keys, versioned by a date embedded
in each key (the reference's S3 protocol, ``stage_1_train_model.py:61-67``):
``history`` lists the date-keyed artefacts under a prefix oldest first and
``latest`` is the newest. ``put_bytes_if_match`` is the compare-and-swap
write the model registry's documents and the run journal ride, against a
backend's ``version_token``; ``version_tokens`` and ``get_many`` are the
batched reads of the history loader (``data.io``). :class:`DelegatingStore`
is the base of the wrappers (the day loop's write fence, ``store.epoch``;
the kill switch, ``chaos.kill``).

A backend that declares a ``backend_label`` (``"filesystem"``) gets its
primitive operations counted and timed through the shared obs registry,
as in the JAX package: ``bodywork_tpu_store_ops_total{backend,op}`` and
``bodywork_tpu_store_op_seconds{backend,op}``. Wrappers declare none, so
a call through any stack of them is counted once, at the backend.
"""
from __future__ import annotations

import abc
import functools
import time
from datetime import date

from bodywork_tpu_torch.utils.dates import date_from_key


class ArtefactNotFound(KeyError):
    """No artefact exists at the requested key/prefix."""


class CasConflict(RuntimeError):
    """A ``put_bytes_if_match`` compare-and-swap lost its race: the key's
    current version token no longer matches the caller's (someone wrote
    between the caller's read and its write). The store is untouched by
    the losing write; the caller re-reads and decides whether to retry."""


#: the operations timed when a backend declares ``backend_label``
_INSTRUMENTED_OPS = (
    "put_bytes",
    "put_bytes_if_match",
    "get_bytes",
    "list_keys",
    "delete",
    "exists",
    "version_token",
    "version_tokens",
    "get_many",
)

#: store-op latency ladder: local-filesystem stats (~µs) up through remote
#: round-trips and retries (the JAX package's buckets)
_STORE_OP_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def _observe_store_op(backend: str, op: str, seconds: float) -> None:
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "bodywork_tpu_store_ops_total",
        "Artefact-store operations by backend and op",
    ).inc(backend=backend, op=op)
    reg.histogram(
        "bodywork_tpu_store_op_seconds",
        "Artefact-store operation latency by backend and op",
        buckets=_STORE_OP_BUCKETS,
    ).observe(seconds, backend=backend, op=op)


def _timed_op(impl, backend: str, op: str):
    @functools.wraps(impl)
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return impl(self, *args, **kwargs)
        finally:
            _observe_store_op(backend, op, time.perf_counter() - t0)

    wrapper.__wrapped_store_op__ = op
    return wrapper


class ArtefactStore(abc.ABC):
    """Flat byte store with ``/``-separated keys and date-key versioning."""

    #: set by real backends to have their primitive operations counted and
    #: timed; wrappers leave it unset
    backend_label: str | None = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        label = cls.__dict__.get("backend_label")
        if not label:
            return
        for op in _INSTRUMENTED_OPS:
            impl = cls.__dict__.get(op)
            if impl is not None and not hasattr(impl, "__wrapped_store_op__"):
                setattr(cls, op, _timed_op(impl, label, op))

    @staticmethod
    def validate_key(key: str) -> str:
        """Reject keys that could escape or alias the store namespace."""
        if not key or key.startswith(("/", "..")) or ".." in key.split("/"):
            raise ValueError(f"invalid artefact key: {key!r}")
        return key

    # -- raw byte plane ----------------------------------------------------
    @abc.abstractmethod
    def put_bytes(self, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get_bytes(self, key: str) -> bytes: ...

    @abc.abstractmethod
    def list_keys(self, prefix: str = "") -> list[str]:
        """All keys under ``prefix``, sorted lexicographically."""

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    def delete(self, key: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot delete artefacts")

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        """``{key: bytes}`` for many keys, in input order; raises
        :class:`ArtefactNotFound` naming the first missing key (callers
        batch keys they just listed, so a miss is a torn read)."""
        return {key: self.get_bytes(key) for key in keys}

    def version_token(self, key: str):
        """Opaque token of the current content of ``key``, or None (absent,
        or no cheap validity check). Equal non-None tokens guarantee equal
        bytes."""
        return None

    def version_tokens(self, keys: list[str]) -> dict[str, object]:
        """Version tokens of many keys at once, None values omitted."""
        out = {}
        for key in keys:
            token = self.version_token(key)
            if token is not None:
                out[key] = token
        return out

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        """Compare-and-swap write: persist ``data`` at ``key`` only if the
        key's current :meth:`version_token` equals ``expected_token``
        (None = create-only: the key must not exist). Raises
        :class:`CasConflict`, leaving the store untouched, otherwise, and
        returns the new token. The model registry's documents are written
        only through it."""
        raise NotImplementedError(f"{type(self).__name__} has no compare-and-swap write")

    def mutable_cache(self, name: str) -> dict:
        """A named mutable cache dict that lives on the store (wrappers
        delegate it to the store they wrap, so it outlives them)."""
        return self.__dict__.setdefault(name, {})

    # -- text convenience --------------------------------------------------
    def put_text(self, key: str, text: str) -> None:
        self.put_bytes(key, text.encode("utf-8"))

    def get_text(self, key: str) -> str:
        return self.get_bytes(key).decode("utf-8")

    # -- date-key versioning protocol -------------------------------------
    def history(self, prefix: str) -> list[tuple[str, date]]:
        """All date-keyed artefacts under ``prefix``, oldest first. Keys
        without an embedded date are ignored."""
        keyed = []
        for key in self.list_keys(prefix):
            d = date_from_key(key)
            if d is not None:
                keyed.append((key, d))
        keyed.sort(key=lambda e: (e[1], e[0]))
        return keyed

    def latest(self, prefix: str) -> tuple[str, date]:
        """Key and date of the most recent artefact under ``prefix``."""
        hist = self.history(prefix)
        if not hist:
            raise ArtefactNotFound(f"no date-keyed artefacts under '{prefix}'")
        return hist[-1]


class DelegatingStore(ArtefactStore):
    """A store that forwards every operation to an inner store; wrappers
    subclass it and override only what they change. The batched reads and
    ``mutable_cache`` are delegated too: the history loader's caches must
    live on the one long-lived store, not on a per-attempt wrapper that
    dies with the attempt."""

    def __init__(self, inner: ArtefactStore):
        self._inner = inner

    def put_bytes(self, key: str, data: bytes) -> None:
        self._inner.put_bytes(key, data)

    def get_bytes(self, key: str) -> bytes:
        return self._inner.get_bytes(key)

    def list_keys(self, prefix: str = "") -> list[str]:
        return self._inner.list_keys(prefix)

    def exists(self, key: str) -> bool:
        return self._inner.exists(key)

    def delete(self, key: str) -> None:
        self._inner.delete(key)

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        return self._inner.get_many(keys)

    def version_token(self, key: str):
        return self._inner.version_token(key)

    def version_tokens(self, keys: list[str]) -> dict[str, object]:
        return self._inner.version_tokens(keys)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        # delegated, not inherited: the real backend's own CAS protocol
        # (its lock file) must arbitrate, not a lock on this wrapper
        return self._inner.put_bytes_if_match(key, data, expected_token)

    def mutable_cache(self, name: str) -> dict:
        return self._inner.mutable_cache(name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._inner!r})"
