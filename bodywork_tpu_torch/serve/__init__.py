"""Serving package. Attribute access is lazy (PEP 562), as in the JAX
package's ``bodywork_tpu.serve``: the disaggregated front-end processes
(``serve.frontend``, ``serve.wire``, ``serve.rowqueue``,
``serve.netqueue``) live under this package but must stay torch-free, so
importing ``bodywork_tpu_torch.serve.<leaf>`` cannot drag ``predictor``
or ``server`` (and therefore torch) in eagerly. ``from
bodywork_tpu_torch.serve import create_app`` still works; it pays the
import at first access instead of at package import."""
from __future__ import annotations

import importlib

#: public name -> defining submodule; the package namespace resolves
#: these on first attribute access
_EXPORTS = {
    "DEFAULT_MAX_PENDING": "admission",
    "AdmissionController": "admission",
    "SharedBudgetSlot": "admission",
    "build_admission": "admission",
    "count_shed": "admission",
    "AioServiceHandle": "aio",
    "PredictionSanityError": "app",
    "ScoringApp": "app",
    "as_bounds": "app",
    "create_app": "app",
    "sanity_violation": "app",
    "CoalescerSaturated": "batcher",
    "RequestCoalescer": "batcher",
    "FrontendApp": "frontend",
    "MultiProcessService": "multiproc",
    "GRAPH_CACHE": "predictor",
    "SERVE_DTYPES": "predictor",
    "BF16MLPPredictor": "predictor",
    "GraphCache": "predictor",
    "Int8MLPPredictor": "predictor",
    "KernelMLPPredictor": "predictor",
    "PaddedPredictor": "predictor",
    "params_shape_digest": "predictor",
    "CheckpointWatcher": "reload",
    "ENGINE_NAMES": "server",
    "SERVER_ENGINES": "server",
    "RoundRobinApp": "server",
    "ServiceHandle": "server",
    "build_predictor": "server",
    "build_serving_predictor": "server",
    "quantized_engine_for": "server",
    "resolve_engine": "server",
    "serve_latest_model": "server",
    "serve_model": "server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
