from bodywork_tpu_torch.models.checkpoint import (
    MODEL_REGISTRY,
    load_model,
    load_model_bytes,
    resolve_serving_key,
    save_model,
    save_model_bytes,
)
from bodywork_tpu_torch.models.base import Regressor, TrainSplit, train_test_split
from bodywork_tpu_torch.models.linear import LinearConfig, LinearRegressor
from bodywork_tpu_torch.models.metrics import regression_metrics
from bodywork_tpu_torch.models.mlp import (
    MLPConfig,
    MLPNet,
    MLPRegressor,
    init_mlp_params,
    mlp_apply,
    params_from_jax,
)

__all__ = [
    "LinearConfig",
    "LinearRegressor",
    "MODEL_REGISTRY",
    "MLPConfig",
    "MLPNet",
    "MLPRegressor",
    "init_mlp_params",
    "load_model",
    "load_model_bytes",
    "mlp_apply",
    "Regressor",
    "TrainSplit",
    "params_from_jax",
    "regression_metrics",
    "resolve_serving_key",
    "save_model",
    "save_model_bytes",
    "train_test_split",
]
