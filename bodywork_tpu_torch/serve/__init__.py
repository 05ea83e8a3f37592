from bodywork_tpu_torch.serve.app import ScoringApp
from bodywork_tpu_torch.serve.predictor import KernelMLPPredictor, PaddedPredictor
from bodywork_tpu_torch.serve.server import (
    ENGINE_NAMES,
    RoundRobinApp,
    ServiceHandle,
    build_predictor,
    resolve_engine,
    serve_latest_model,
    serve_model,
)

__all__ = [
    "ENGINE_NAMES",
    "KernelMLPPredictor",
    "PaddedPredictor",
    "RoundRobinApp",
    "ScoringApp",
    "ServiceHandle",
    "build_predictor",
    "resolve_engine",
    "serve_latest_model",
    "serve_model",
]
