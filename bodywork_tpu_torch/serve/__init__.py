from bodywork_tpu_torch.serve.app import (
    PredictionSanityError,
    ScoringApp,
    as_bounds,
    sanity_violation,
)
from bodywork_tpu_torch.serve.predictor import (
    SERVE_DTYPES,
    BF16MLPPredictor,
    Int8MLPPredictor,
    KernelMLPPredictor,
    PaddedPredictor,
)
from bodywork_tpu_torch.serve.server import (
    ENGINE_NAMES,
    RoundRobinApp,
    ServiceHandle,
    build_predictor,
    build_serving_predictor,
    quantized_engine_for,
    resolve_engine,
    serve_latest_model,
    serve_model,
)

__all__ = [
    "ENGINE_NAMES",
    "SERVE_DTYPES",
    "BF16MLPPredictor",
    "Int8MLPPredictor",
    "KernelMLPPredictor",
    "PaddedPredictor",
    "PredictionSanityError",
    "RoundRobinApp",
    "ScoringApp",
    "ServiceHandle",
    "as_bounds",
    "build_predictor",
    "build_serving_predictor",
    "quantized_engine_for",
    "resolve_engine",
    "sanity_violation",
    "serve_latest_model",
    "serve_model",
]
