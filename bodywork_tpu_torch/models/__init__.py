from bodywork_tpu_torch.models.checkpoint import (
    MODEL_REGISTRY,
    load_model,
    load_model_bytes,
    resolve_serving_key,
    save_model,
    save_model_bytes,
)
from bodywork_tpu_torch.models.mlp import (
    MLPConfig,
    MLPNet,
    MLPRegressor,
    init_mlp_params,
    mlp_apply,
    params_from_jax,
)

__all__ = [
    "MODEL_REGISTRY",
    "MLPConfig",
    "MLPNet",
    "MLPRegressor",
    "init_mlp_params",
    "load_model",
    "load_model_bytes",
    "mlp_apply",
    "params_from_jax",
    "resolve_serving_key",
    "save_model",
    "save_model_bytes",
]
