from bodywork_tpu_torch.serve.admission import (
    DEFAULT_MAX_PENDING,
    AdmissionController,
    build_admission,
    count_shed,
)
from bodywork_tpu_torch.serve.aio import AioServiceHandle
from bodywork_tpu_torch.serve.app import (
    PredictionSanityError,
    ScoringApp,
    as_bounds,
    create_app,
    sanity_violation,
)
from bodywork_tpu_torch.serve.batcher import CoalescerSaturated, RequestCoalescer
from bodywork_tpu_torch.serve.multiproc import MultiProcessService
from bodywork_tpu_torch.serve.predictor import (
    GRAPH_CACHE,
    SERVE_DTYPES,
    BF16MLPPredictor,
    GraphCache,
    Int8MLPPredictor,
    KernelMLPPredictor,
    PaddedPredictor,
    params_shape_digest,
)
from bodywork_tpu_torch.serve.server import (
    ENGINE_NAMES,
    SERVER_ENGINES,
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
    "DEFAULT_MAX_PENDING",
    "ENGINE_NAMES",
    "GRAPH_CACHE",
    "SERVE_DTYPES",
    "SERVER_ENGINES",
    "AdmissionController",
    "AioServiceHandle",
    "BF16MLPPredictor",
    "CoalescerSaturated",
    "GraphCache",
    "Int8MLPPredictor",
    "KernelMLPPredictor",
    "MultiProcessService",
    "PaddedPredictor",
    "PredictionSanityError",
    "RequestCoalescer",
    "RoundRobinApp",
    "ScoringApp",
    "ServiceHandle",
    "as_bounds",
    "build_admission",
    "build_predictor",
    "build_serving_predictor",
    "count_shed",
    "create_app",
    "params_shape_digest",
    "quantized_engine_for",
    "resolve_engine",
    "sanity_violation",
    "serve_latest_model",
    "serve_model",
]
