"""Artefact store: the subset of ``bodywork_tpu.store`` the serving slice
needs, on the same on-disk layout so each package opens the other's
store."""
from __future__ import annotations

import os

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.store.filesystem import FilesystemStore

__all__ = ["ArtefactNotFound", "ArtefactStore", "CasConflict", "FilesystemStore", "open_store"]


def open_store(location: str | os.PathLike | ArtefactStore) -> ArtefactStore:
    """A store for a directory path (or an already-open store). Object
    stores (``gs://``) wait for a later slice of the port."""
    if isinstance(location, ArtefactStore):
        return location
    if str(location).startswith("gs://"):
        raise ValueError(
            "gs:// stores are not ported yet; use a filesystem store path"
        )
    return FilesystemStore(location)
