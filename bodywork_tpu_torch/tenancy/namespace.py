"""Tenant-scoped store views (the port's copy of
``bodywork_tpu.tenancy.namespace``).

A tenant's artefacts live under ``tenants/<id>/``, the whole store schema
mirrored there; the reserved ``default`` tenant is the unprefixed root.
:class:`TenantStore` rebases every key and prefix on the way in and
strips it on the way out, so a caller sees a single-tenant store and
training, the registry, journals, snapshots, sidecars and tuned configs
become tenant-aware without learning a tenant argument. Listings stay
prefix-bounded: a scoped ``list_keys(p)`` walks only
``tenants/<id>/p`` on the backend.
"""
from __future__ import annotations

import os

from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore
from bodywork_tpu_torch.store.schema import (
    DEFAULT_TENANT,
    TENANT_ID_PATTERN,
    TENANTS_PREFIX,
    tenant_prefix,
    validate_tenant_id,
)
from bodywork_tpu_torch.utils.logging import get_logger

__all__ = ["TENANT_ENV", "TenantStore", "list_tenants", "scoped_store", "tenant_from_env",
           "tenant_of"]

log = get_logger("tenancy.namespace")

#: the pod environment's tenant knob, parsed with the stages' contract:
#: a malformed value degrades to ``default`` with a warning
TENANT_ENV = "BODYWORK_TPU_TENANT"


class TenantStore(DelegatingStore):
    """A store view scoped to one tenant's namespace. ``mutable_cache`` is
    namespaced per tenant too: two tenants share key names with different
    content."""

    def __init__(self, inner: ArtefactStore, tenant_id: str):
        super().__init__(inner)
        self.tenant_id = validate_tenant_id(tenant_id)
        self._prefix = tenant_prefix(tenant_id)

    def __repr__(self) -> str:
        return f"TenantStore({self._inner!r}, tenant={self.tenant_id!r})"

    def _rebase(self, key: str) -> str:
        return f"{self._prefix}{key}"

    def _strip(self, key: str) -> str:
        return key[len(self._prefix):]

    def put_bytes(self, key: str, data: bytes) -> None:
        self._inner.put_bytes(self._rebase(key), data)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        return self._inner.put_bytes_if_match(self._rebase(key), data, expected_token)

    def get_bytes(self, key: str) -> bytes:
        return self._inner.get_bytes(self._rebase(key))

    def list_keys(self, prefix: str = "") -> list[str]:
        return [self._strip(k) for k in self._inner.list_keys(self._rebase(prefix))]

    def delete(self, key: str) -> None:
        self._inner.delete(self._rebase(key))

    def exists(self, key: str) -> bool:
        return self._inner.exists(self._rebase(key))

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        got = self._inner.get_many([self._rebase(k) for k in keys])
        return {self._strip(k): v for k, v in got.items()}

    def version_token(self, key: str):
        return self._inner.version_token(self._rebase(key))

    def version_tokens(self, keys: list[str]) -> dict[str, object]:
        got = self._inner.version_tokens([self._rebase(k) for k in keys])
        return {self._strip(k): v for k, v in got.items()}

    def mutable_cache(self, name: str) -> dict:
        return self._inner.mutable_cache(f"{self._prefix}{name}")


def scoped_store(store: ArtefactStore, tenant_id: str) -> ArtefactStore:
    """``store`` viewed through ``tenant_id``'s namespace; the reserved
    ``default`` tenant returns ``store`` unwrapped, so a root deployment's
    keys stay byte-identical. Callers scope the root store once, when it
    is opened (``cli --tenant`` / :data:`TENANT_ENV`)."""
    validate_tenant_id(tenant_id)
    if tenant_id == DEFAULT_TENANT:
        return store
    return TenantStore(store, tenant_id)


def tenant_of(store: ArtefactStore) -> str:
    """The tenant a store view is scoped to (``default`` for a store that
    is not a :class:`TenantStore`): the label of tenant metric families."""
    while store is not None:
        if isinstance(store, TenantStore):
            return store.tenant_id
        store = getattr(store, "_inner", None)
    return DEFAULT_TENANT


def tenant_from_env(environ=None) -> str:
    """The deployed tenant from :data:`TENANT_ENV`. A malformed value
    degrades to ``default`` with a warning (a typo never crashes the pod
    and can touch only the root namespace); the ``--tenant`` flag, by
    contrast, refuses it."""
    env = os.environ if environ is None else environ
    raw = env.get(TENANT_ENV, "").strip()
    if not raw:
        return DEFAULT_TENANT
    try:
        return validate_tenant_id(raw)
    except ValueError:
        log.warning(
            f"ignoring {TENANT_ENV}={raw!r} "
            f"(want lowercase DNS-label, pattern {TENANT_ID_PATTERN.pattern})"
        )
        return DEFAULT_TENANT


def list_tenants(store: ArtefactStore) -> list[str]:
    """Every tenant id with an artefact under ``tenants/``, sorted; ids
    that fail validation are skipped and ``default`` is never listed."""
    seen = set()
    for key in store.list_keys(TENANTS_PREFIX):
        segment = key[len(TENANTS_PREFIX):].split("/", 1)[0]
        if segment not in seen and TENANT_ID_PATTERN.match(segment) and "--" not in segment:
            seen.add(segment)
    return sorted(seen)
