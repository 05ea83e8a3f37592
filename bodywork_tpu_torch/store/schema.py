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
- ``trainstate/<model_type>-suffstats.json`` — incremental training's
  sufficient statistics (``bodywork_tpu_torch.train.incremental``)
- ``snapshots/history-snapshot-<date>.npz`` — consolidated dataset
  history (``bodywork_tpu_torch.data.snapshot``)
- ``runs/<date>/journal.json`` — one day's run journal and lease
  (``bodywork_tpu_torch.pipeline.journal``)
- ``obs/flightrec/flight-<seq>-<verdict>-<digest>.json`` — flight-recorder
  dumps of sampled request traces (``bodywork_tpu_torch.obs.tracing``):
  diagnostic evidence nothing else reads, so deleting the prefix only
  loses the record of past verdicts
"""
from __future__ import annotations

from datetime import date

DATASETS_PREFIX = "datasets/"
MODELS_PREFIX = "models/"
MODEL_METRICS_PREFIX = "model-metrics/"
TEST_METRICS_PREFIX = "test-metrics/"
REGISTRY_RECORDS_PREFIX = "registry/records/"
REGISTRY_ALIAS_KEY = "registry/aliases.json"
TRAINSTATE_PREFIX = "trainstate/"
SNAPSHOTS_PREFIX = "snapshots/"
RUNS_PREFIX = "runs/"
FLIGHTREC_PREFIX = "obs/flightrec/"
#: the JAX schema's prefixes of modules not ported yet, named here so
#: :data:`ALL_PREFIXES` is the JAX package's tuple
REGISTRY_PREFIX = "registry/"
TUNING_PREFIX = "tuning/"
AUDIT_PREFIX = "audit/"
QUARANTINE_PREFIX = "quarantine/"
SERVE_PREFIX = "serve/"
TENANTS_PREFIX = "tenants/"

#: every prefix of the store schema, in the JAX package's order (the
#: default scope of the fault plan's at-rest bit-rot decisions)
ALL_PREFIXES = (
    DATASETS_PREFIX,
    MODELS_PREFIX,
    MODEL_METRICS_PREFIX,
    TEST_METRICS_PREFIX,
    SNAPSHOTS_PREFIX,
    TRAINSTATE_PREFIX,
    RUNS_PREFIX,
    REGISTRY_PREFIX,
    TUNING_PREFIX,
    AUDIT_PREFIX,
    QUARANTINE_PREFIX,
    FLIGHTREC_PREFIX,
    SERVE_PREFIX,
    TENANTS_PREFIX,
)


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


def trainstate_key(model_type: str) -> str:
    """The incremental-training sufficient-statistics document of one
    model type. It carries no date: like the alias document it is a live,
    compare-and-swap mutated document, outside the ``history``/``latest``
    protocol."""
    return f"{TRAINSTATE_PREFIX}{model_type}-suffstats.json"


def run_journal_key(d: date) -> str:
    """The day-run journal document of simulated day ``d``: the embedded
    date keeps journals visible to the date-key protocol."""
    return f"{RUNS_PREFIX}{d}/journal.json"


def snapshot_key(d: date) -> str:
    """The consolidated-history snapshot covering every dataset day up to
    ``d``, its most recent covered day (so ``history``/``latest`` version
    snapshots too)."""
    return f"{SNAPSHOTS_PREFIX}history-snapshot-{d}.npz"


def flight_record_key(seq: int, verdict: str, doc_digest: str) -> str:
    """Where one flight-recorder dump lands: ``seq`` (the count of dumps
    already stored, no wall clock) leads, so a listing is write order; the
    content digest's fragment keeps distinct concurrent dumps apart."""
    fragment = doc_digest.removeprefix("sha256:")[:16]
    return f"{FLIGHTREC_PREFIX}flight-{seq:06d}-{verdict}-{fragment}.json"
