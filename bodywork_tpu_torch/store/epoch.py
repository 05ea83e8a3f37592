"""Write-epoch fence for abandoned stage attempts (the port of
``bodywork_tpu.store.epoch``).

The local runner cannot kill a batch-stage attempt that ran past its
deadline: Python has no thread kill. It abandons the worker thread and
fails the stage, but the thread still holds the store. Each attempt
therefore writes through its own :class:`EpochGuardedStore`; when the
runner abandons the attempt it revokes the epoch, and every later write
through it (``put_bytes``, ``put_bytes_if_match``, ``delete``) raises
:class:`WriteEpochRevoked` instead of landing. Reads stay allowed: an
abandoned reader is harmless.
"""
from __future__ import annotations

import threading

from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore

__all__ = ["EpochGuardedStore", "WriteEpochRevoked"]


class WriteEpochRevoked(RuntimeError):
    """A write arrived through a store epoch the runner revoked (the
    writing stage attempt timed out and was abandoned)."""


class EpochGuardedStore(DelegatingStore):
    def __init__(self, inner: ArtefactStore, label: str = "stage"):
        super().__init__(inner)
        self._label = label
        self._revoked = threading.Event()

    def revoke(self) -> None:
        """Reject all future writes through this epoch (idempotent)."""
        self._revoked.set()

    @property
    def revoked(self) -> bool:
        return self._revoked.is_set()

    def _check_writable(self, key: str) -> None:
        if self._revoked.is_set():
            raise WriteEpochRevoked(
                f"write of {key!r} rejected: the {self._label} attempt "
                "holding this store epoch was timed out and abandoned"
            )

    def put_bytes(self, key: str, data: bytes) -> None:
        self._check_writable(key)
        self._inner.put_bytes(key, data)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        # a CAS write is a write: an abandoned attempt must not move the
        # registry's alias after its epoch ended
        self._check_writable(key)
        return self._inner.put_bytes_if_match(key, data, expected_token)

    def delete(self, key: str) -> None:
        self._check_writable(key)
        self._inner.delete(key)
