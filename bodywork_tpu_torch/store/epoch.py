"""Write-epoch fence for abandoned stage attempts (the port of
``bodywork_tpu.store.epoch``).

The local runner cannot kill a batch-stage attempt that ran past its
deadline: Python has no thread kill. It abandons the worker thread and
fails the stage, but the thread still holds the store. Each attempt
therefore writes through its own :class:`EpochGuardedStore`; when the
runner abandons the attempt it revokes the epoch, and every later write
through it raises :class:`WriteEpochRevoked` instead of landing. Reads
stay allowed: an abandoned reader is harmless.
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

    def put_bytes(self, key: str, data: bytes) -> None:
        if self._revoked.is_set():
            raise WriteEpochRevoked(
                f"write of {key!r} rejected: the {self._label} attempt "
                "holding this store epoch was timed out and abandoned"
            )
        self._inner.put_bytes(key, data)
