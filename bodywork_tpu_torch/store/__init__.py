"""Artefact store (the port's copy of ``bodywork_tpu.store``), on the same
on-disk layout, so each package opens the other's store."""
from __future__ import annotations

import os

from bodywork_tpu_torch.store.base import (
    ArtefactNotFound,
    ArtefactStore,
    CasConflict,
    DelegatingStore,
)
from bodywork_tpu_torch.store.filesystem import FilesystemStore
from bodywork_tpu_torch.store.resilient import ResilientStore
from bodywork_tpu_torch.store import schema
from bodywork_tpu_torch.store.schema import (
    DATASETS_PREFIX,
    MODELS_PREFIX,
    MODEL_METRICS_PREFIX,
    REGISTRY_ALIAS_KEY,
    REGISTRY_PREFIX,
    REGISTRY_RECORDS_PREFIX,
    SNAPSHOTS_PREFIX,
    TEST_METRICS_PREFIX,
    dataset_key,
    model_key,
    model_metrics_key,
    registry_record_key,
    snapshot_key,
    test_metrics_key,
)

__all__ = ["ArtefactNotFound", "ArtefactStore", "CasConflict", "DelegatingStore",
           "FilesystemStore", "ResilientStore", "open_scoped_store", "open_store", "schema",
           "DATASETS_PREFIX", "MODELS_PREFIX", "MODEL_METRICS_PREFIX", "REGISTRY_ALIAS_KEY",
           "REGISTRY_PREFIX", "REGISTRY_RECORDS_PREFIX", "SNAPSHOTS_PREFIX",
           "TEST_METRICS_PREFIX", "dataset_key", "model_key", "model_metrics_key",
           "registry_record_key", "snapshot_key", "test_metrics_key"]


def open_store(location: str | os.PathLike | ArtefactStore) -> ArtefactStore:
    """Open an artefact store from a URL-ish spec (an open store is
    returned as it is):

    - ``/path/to/dir`` or ``file:///path`` -> :class:`FilesystemStore`
    - ``gs://bucket/prefix`` -> :class:`~bodywork_tpu_torch.store.gcs.GCSStore`

    The backend comes wrapped, outermost, in the audit subsystem's
    :class:`~bodywork_tpu_torch.audit.manifest.AuditedStore`, as in the
    JAX package: every write through an entry point records its
    write-time digest sidecar under ``audit/``, the evidence ``cli fsck``
    verifies cold artefacts against."""
    if isinstance(location, ArtefactStore):
        return location
    from bodywork_tpu_torch.audit.manifest import AuditedStore

    url = str(location)
    if url.startswith("gs://"):
        from bodywork_tpu_torch.store.gcs import GCSStore

        return AuditedStore(GCSStore.from_url(url))
    if url.startswith("file://"):
        url = url[len("file://"):]
    return AuditedStore(FilesystemStore(url))


def open_scoped_store(location: str | os.PathLike | ArtefactStore) -> ArtefactStore:
    """:func:`open_store`, scoped to the tenant ``BODYWORK_TPU_TENANT``
    names (a malformed value degrades to the root with a warning): the
    seam for spawned serving processes, which inherit their configuration
    through the environment. CLI entry points call :func:`open_store` and
    apply their flag-beats-env precedence themselves."""
    from bodywork_tpu_torch.tenancy.namespace import scoped_store, tenant_from_env

    return scoped_store(open_store(location), tenant_from_env())
