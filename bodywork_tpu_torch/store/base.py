"""Artefact store interface (the port's copy of ``bodywork_tpu.store.base``,
cut to what the serving slice uses).

A flat byte store with ``/``-separated keys, versioned by a date embedded
in each key (the reference's S3 protocol, ``stage_1_train_model.py:61-67``):
``history`` lists the date-keyed artefacts under a prefix oldest first and
``latest`` is the newest. ``put_bytes_if_match`` is the compare-and-swap
write the model registry's documents ride, against a backend's
``version_token``. :class:`DelegatingStore` is the base of the wrappers
(the day loop's write fence, ``store.epoch``); metrics instrumentation
waits for the slice that needs it.
"""
from __future__ import annotations

import abc
from datetime import date

from bodywork_tpu_torch.utils.dates import date_from_key


class ArtefactNotFound(KeyError):
    """No artefact exists at the requested key/prefix."""


class CasConflict(RuntimeError):
    """A ``put_bytes_if_match`` compare-and-swap lost its race: the key's
    current version token no longer matches the caller's (someone wrote
    between the caller's read and its write). The store is untouched by
    the losing write; the caller re-reads and decides whether to retry."""


class ArtefactStore(abc.ABC):
    """Flat byte store with ``/``-separated keys and date-key versioning."""

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

    def version_token(self, key: str):
        """Opaque token of the current content of ``key``, or None (absent,
        or no cheap validity check). Equal non-None tokens guarantee equal
        bytes."""
        return None

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
    subclass it and override only what they change."""

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

    def version_token(self, key: str):
        return self._inner.version_token(key)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        # delegated, not inherited: the real backend's own CAS protocol
        # (its lock file) must arbitrate, not a lock on this wrapper
        return self._inner.put_bytes_if_match(key, data, expected_token)

    def mutable_cache(self, name: str) -> dict:
        return self._inner.mutable_cache(name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._inner!r})"
