"""The multi-tenant fleet layer (the port of ``bodywork_tpu.tenancy``):
tenant-namespaced stores (:mod:`.namespace`), stacked one-dispatch
serving of many same-architecture tenants (:mod:`.stacked`), the scenario
zoo (:mod:`.scenarios`), fair round-robin retrain scheduling
(:mod:`.scheduler`) and the seeded fleet soak (:mod:`.fleet`).

:mod:`.namespace`, :mod:`.scenarios` and :mod:`.scheduler` import no
torch, so front ends and the cli load them without a device runtime;
:mod:`.stacked` and :mod:`.fleet` hold the torch-facing pieces. This
``__init__`` re-exports only the torch-free surface, as the JAX
package's re-exports only its jax-free one.
"""
from bodywork_tpu_torch.tenancy.namespace import (
    TENANT_ENV,
    TenantStore,
    list_tenants,
    scoped_store,
    tenant_from_env,
)
from bodywork_tpu_torch.tenancy.scenarios import (
    SCENARIOS,
    TRAFFIC_SHAPES,
    TenantSpec,
    traffic_profile,
    zoo,
)
from bodywork_tpu_torch.tenancy.scheduler import FairScheduler

__all__ = ["SCENARIOS", "TENANT_ENV", "TRAFFIC_SHAPES", "FairScheduler", "TenantSpec",
           "TenantStore", "list_tenants", "scoped_store", "tenant_from_env",
           "traffic_profile", "zoo"]
