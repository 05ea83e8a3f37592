"""The artefact key schema, shared byte-for-byte with
``bodywork_tpu.store.schema`` so the two packages read each other's
stores:

- ``datasets/regression-dataset-<date>.csv``
- ``models/regressor-<date>.npz``
- ``model-metrics/regressor-<date>.csv`` — the train stage's held-out
  metrics
- ``test-metrics/regressor-test-results-<date>.csv``
- ``registry/records/regressor-<date>.json`` — one model registry record
  per checkpoint, and ``registry/aliases.json``, the alias document
  (``bodywork_tpu_torch.registry``)
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


def registry_record_key(model_key: str) -> str:
    """The registry record's key for a model key: the checkpoint's
    basename, extension dropped, under ``registry/records/`` (so records
    carry the model's date and sort by it)."""
    base = model_key.rsplit("/", 1)[-1]
    stem = base.rsplit(".", 1)[0] if "." in base else base
    return f"{REGISTRY_RECORDS_PREFIX}{stem}.json"
