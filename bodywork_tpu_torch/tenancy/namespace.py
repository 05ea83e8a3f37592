"""Tenant-scoped store views (the port's copy of the part of
``bodywork_tpu.tenancy.namespace`` that fsck uses).

A tenant's artefacts live under ``tenants/<id>/``, the whole store schema
mirrored there; the reserved ``default`` tenant is the unprefixed root.
:class:`TenantStore` rebases every key and prefix on the way in and
strips it on the way out, so a caller sees a single-tenant store.
"""
from __future__ import annotations

from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore
from bodywork_tpu_torch.store.schema import (
    TENANT_ID_PATTERN,
    TENANTS_PREFIX,
    tenant_prefix,
    validate_tenant_id,
)

__all__ = ["TenantStore", "list_tenants"]


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


def list_tenants(store: ArtefactStore) -> list[str]:
    """Every tenant id with an artefact under ``tenants/``, sorted; ids
    that fail validation are skipped and ``default`` is never listed."""
    seen = set()
    for key in store.list_keys(TENANTS_PREFIX):
        segment = key[len(TENANTS_PREFIX):].split("/", 1)[0]
        if segment not in seen and TENANT_ID_PATTERN.match(segment) and "--" not in segment:
            seen.add(segment)
    return sorted(seen)
