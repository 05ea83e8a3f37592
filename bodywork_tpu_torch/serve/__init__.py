from bodywork_tpu_torch.serve.app import ScoringApp
from bodywork_tpu_torch.serve.predictor import KernelMLPPredictor, PaddedPredictor
from bodywork_tpu_torch.serve.server import (
    ENGINE_NAMES,
    ServiceHandle,
    build_predictor,
    resolve_engine,
    serve_latest_model,
)

__all__ = [
    "ENGINE_NAMES",
    "KernelMLPPredictor",
    "PaddedPredictor",
    "ScoringApp",
    "ServiceHandle",
    "build_predictor",
    "resolve_engine",
    "serve_latest_model",
]
