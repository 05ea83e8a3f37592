"""The model registry: gated promotion, shadow evaluation, one-CAS
rollback, the canary lifecycle (the port of ``bodywork_tpu.registry``).

Training registers candidates, the gate promotes or rejects them,
serving resolves the ``production`` alias, and rollback flips it back to
``previous`` in one compare-and-swap. Records and the alias document are
the JAX package's, byte for byte: either package reads and writes the
other's registry.
"""
from bodywork_tpu_torch.registry.gates import GateDecision, GatePolicy, evaluate_candidate
from bodywork_tpu_torch.registry.manager import (
    CANARY_ACTION_METHODS,
    CANARY_ACTIONS,
    ModelRegistry,
    PromotionConflict,
    RegistryError,
    RollbackBlocked,
)
from bodywork_tpu_torch.registry.records import (
    RegistryCorrupt,
    read_aliases,
    register_candidate,
    registry_exists,
    resolve_alias,
    resolve_canary,
)
from bodywork_tpu_torch.registry.shadow import shadow_evaluate

__all__ = [
    "CANARY_ACTIONS",
    "CANARY_ACTION_METHODS",
    "GateDecision",
    "GatePolicy",
    "ModelRegistry",
    "PromotionConflict",
    "RegistryCorrupt",
    "RegistryError",
    "RollbackBlocked",
    "evaluate_candidate",
    "read_aliases",
    "register_candidate",
    "registry_exists",
    "resolve_alias",
    "resolve_canary",
    "shadow_evaluate",
]
