"""Tenant namespaces: the part of ``bodywork_tpu.tenancy`` the integrity
scrub reads (``tenants/<id>/`` subtrees of a store the JAX package
wrote); the fleet soak and the scoped entry points wait for a later slice
of the port."""
from bodywork_tpu_torch.tenancy.namespace import TenantStore, list_tenants

__all__ = ["TenantStore", "list_tenants"]
