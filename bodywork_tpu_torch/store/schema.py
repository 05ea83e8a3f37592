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
- ``audit/digests/<key>.json`` — the write-time digest sidecar of
  ``<key>`` (``bodywork_tpu_torch.audit.manifest``), and
  ``quarantine/<key>`` — corrupt bytes the fsck repair planner parked
  (``bodywork_tpu_torch.audit.repair``)
- ``tuning/tuned-config-<date>.json``, ``tuning/cost-model-<date>.json``
  and ``tuning/config-log.json`` — the tuned serving configs, the learned
  dispatch-cost models and the config lifecycle log
  (``bodywork_tpu_torch.tune``, ``bodywork_tpu_torch.registry.configlog``)
- ``serve/`` and ``tenants/<id>/`` — the dispatcher leader lease and the
  tenant namespaces of the JAX package; the port does not write them
  yet, and its fsck audits them in a store the JAX package wrote
"""
from __future__ import annotations

import re
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
REGISTRY_PREFIX = "registry/"
AUDIT_PREFIX = "audit/"
AUDIT_DIGESTS_PREFIX = "audit/digests/"
QUARANTINE_PREFIX = "quarantine/"
#: tuned serving configs, cost models and the config log (``tune/``)
TUNING_PREFIX = "tuning/"
#: the JAX schema's prefixes of modules not ported yet, named here so
#: :data:`ALL_PREFIXES` is the JAX package's tuple and fsck audits them
SERVE_PREFIX = "serve/"
TENANTS_PREFIX = "tenants/"

#: the schema tags of the documents under ``tuning/`` and ``serve/``
#: (``registry/configlog.py``, ``tune/config.py``, ``tune/costmodel.py``,
#: and the JAX package's ``serve/leadership.py``): defined here once, and
#: read by their writers, their loaders and fsck
CONFIG_LOG_SCHEMA = "bodywork_tpu.config_log/1"
TUNED_CONFIG_SCHEMA = "bodywork_tpu.tuned_config/1"
COST_MODEL_SCHEMA = "bodywork_tpu.cost_model/1"
LEADER_SCHEMA = "bodywork_tpu.dispatcher_leader/1"

#: the reserved tenant whose namespace IS the unprefixed root
DEFAULT_TENANT = "default"

#: what a tenant id may look like: a DNS label, 1-63 lowercase
#: alphanumerics and single interior hyphens
TENANT_ID_PATTERN = re.compile(r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")


def validate_tenant_id(tenant_id: str) -> str:
    """``tenant_id`` if it matches :data:`TENANT_ID_PATTERN` (and holds no
    ``--``), else ``ValueError`` naming the value and the grammar."""
    if not isinstance(tenant_id, str) or not TENANT_ID_PATTERN.match(tenant_id):
        raise ValueError(
            f"invalid tenant id {tenant_id!r}: want lowercase DNS-label "
            "(^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$)"
        )
    if "--" in tenant_id:
        raise ValueError(
            f"invalid tenant id {tenant_id!r}: consecutive hyphens reserved"
        )
    return tenant_id


def tenant_prefix(tenant_id: str) -> str:
    """The key prefix of ``tenant_id``'s namespace (empty for
    :data:`DEFAULT_TENANT`)."""
    validate_tenant_id(tenant_id)
    if tenant_id == DEFAULT_TENANT:
        return ""
    return f"{TENANTS_PREFIX}{tenant_id}/"

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


def dispatcher_leader_key() -> str:
    """The dispatcher leadership lease document of a namespace."""
    return f"{SERVE_PREFIX}dispatcher-leader.json"


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


def tuned_config_key(d: date) -> str:
    """The tuned serving-config document fitted on day ``d``
    (``tune/config.py``): date-keyed, so ``--tuned-config latest``
    resolves through the ``history``/``latest`` protocol."""
    return f"{TUNING_PREFIX}tuned-config-{d}.json"


def cost_model_key(d: date) -> str:
    """The learned dispatch-cost model fitted on day ``d``
    (``tune/costmodel.py``); its basename keeps tuned-config ``latest``
    resolution and fsck's per-kind validation apart."""
    return f"{TUNING_PREFIX}cost-model-{d}.json"


#: the config lifecycle log (``registry/configlog.py``): the active tuned
#: config, the one before it and the applied/reverted history. A live
#: compare-and-swap document with no date, outside ``history``/``latest``.
CONFIG_LOG_KEY = f"{TUNING_PREFIX}config-log.json"


def audit_digest_key(key: str) -> str:
    """The write-time digest sidecar of artefact ``key``: its path
    mirrored under ``audit/digests/`` with a ``.json`` suffix, so a
    sidecar never collides with a primary and :func:`audit_primary_key`
    inverts it exactly."""
    return f"{AUDIT_DIGESTS_PREFIX}{key}.json"


def audit_primary_key(sidecar_key: str) -> str | None:
    """Inverse of :func:`audit_digest_key`, or None for a key that is not
    a well-formed sidecar key."""
    if not sidecar_key.startswith(AUDIT_DIGESTS_PREFIX) or not sidecar_key.endswith(".json"):
        return None
    return sidecar_key[len(AUDIT_DIGESTS_PREFIX):-len(".json")]


#: suffix of a quarantine METADATA document, beside the parked payload
QUARANTINE_META_SUFFIX = ".quarantine.json"


def quarantine_key(key: str) -> str:
    """Where the fsck repair planner parks corrupt bytes found at
    ``key``: its path mirrored under ``quarantine/``."""
    return f"{QUARANTINE_PREFIX}{key}"


def quarantine_meta_key(key: str) -> str:
    """The metadata document of the bytes quarantined from ``key``."""
    return f"{QUARANTINE_PREFIX}{key}{QUARANTINE_META_SUFFIX}"
