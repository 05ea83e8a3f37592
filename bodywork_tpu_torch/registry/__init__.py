"""The model registry: gated promotion, shadow evaluation, one-CAS
rollback (the port of ``bodywork_tpu.registry``, without the canary).

Training registers candidates, the gate promotes or rejects them,
serving resolves the ``production`` alias, and rollback flips it back to
``previous`` in one compare-and-swap. Records and the alias document are
the JAX package's, byte for byte: either package reads and writes the
other's registry.
"""
from bodywork_tpu_torch.registry.gates import GateDecision, GatePolicy, evaluate_candidate
from bodywork_tpu_torch.registry.manager import (
    ModelRegistry,
    PromotionConflict,
    RegistryError,
    RollbackBlocked,
)
from bodywork_tpu_torch.registry.records import (
    RegistryCorrupt,
    read_aliases,
    register_candidate,
    resolve_alias,
)
from bodywork_tpu_torch.registry.shadow import shadow_evaluate

__all__ = [
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
    "resolve_alias",
    "shadow_evaluate",
]
