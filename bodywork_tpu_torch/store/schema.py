"""The artefact key schema, shared byte-for-byte with
``bodywork_tpu.store.schema`` so the two packages read each other's
stores:

- ``datasets/regression-dataset-<date>.csv``
- ``models/regressor-<date>.npz``
- ``model-metrics/regressor-<date>.csv`` — the train stage's held-out
  metrics
- ``test-metrics/regressor-test-results-<date>.csv``
- ``registry/`` — the JAX package's model registry (records + the alias
  document). The port does not read it yet, and refuses to serve from a
  store that has one (``models.checkpoint.resolve_serving_key``).
"""
from __future__ import annotations

from datetime import date

DATASETS_PREFIX = "datasets/"
MODELS_PREFIX = "models/"
MODEL_METRICS_PREFIX = "model-metrics/"
TEST_METRICS_PREFIX = "test-metrics/"
REGISTRY_RECORDS_PREFIX = "registry/records/"
REGISTRY_ALIAS_KEY = "registry/aliases.json"


def dataset_key(d: date) -> str:
    return f"{DATASETS_PREFIX}regression-dataset-{d}.csv"


def model_key(d: date, suffix: str = "npz") -> str:
    return f"{MODELS_PREFIX}regressor-{d}.{suffix}"


def model_metrics_key(d: date) -> str:
    return f"{MODEL_METRICS_PREFIX}regressor-{d}.csv"


def test_metrics_key(d: date) -> str:
    return f"{TEST_METRICS_PREFIX}regressor-test-results-{d}.csv"
