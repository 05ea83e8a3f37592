"""Registry records and the alias document (the port's copy of
``bodywork_tpu.registry.records``).

The registry sits between training and serving: training registers each
checkpoint as a *candidate* record, the gate (:mod:`.gates`) promotes or
rejects it, and serving resolves the ``production`` alias instead of the
newest key under ``models/``. Two kinds of plain JSON artefact, in the
JAX package's schema and bytes, so either package reads and writes the
other's registry:

- **Records** under ``registry/records/``: one date-keyed document per
  checkpoint with its lineage (model key, content digest, dataset-day
  coverage, metrics key), a status (``candidate`` / ``production`` /
  ``rejected`` / ``archived``) and an append-only ``history`` of events.
- **The alias document** ``registry/aliases.json``: the one mapping of
  ``production`` / ``previous`` to model keys. It is written only by the
  store's compare-and-swap (``put_bytes_if_match``), so of two
  concurrent promoters exactly one wins and the document never tears.
  A live canary takes the ``canary*`` slots (:func:`resolve_canary`
  reads them; ``manager.ModelRegistry.canary_*`` writes them).

Records hold no wall clock (events carry the simulated day, lineage is a
content digest), so the same inputs give the same bytes in both packages.

A record that fails JSON/schema/digest validation on every read of the
retry budget is treated as absent and flags ``repair_needed`` on the
store's registry state; a corrupt alias document raises
:class:`RegistryCorrupt` instead, because treating it as absent would put
the ungated latest checkpoint live. (The JAX package also counts corrupt
reads on its metrics registry, which the port does not have yet.)
"""
from __future__ import annotations

import json
from datetime import date

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import (
    DATASETS_PREFIX,
    REGISTRY_ALIAS_KEY,
    REGISTRY_RECORDS_PREFIX,
    model_metrics_key,
    registry_record_key,
)
from bodywork_tpu_torch.utils.dates import date_from_key
from bodywork_tpu_torch.utils.integrity import sha256_digest, stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("registry.records")

RECORD_SCHEMA = "bodywork_tpu.registry_record/1"
ALIAS_SCHEMA = "bodywork_tpu.registry_aliases/1"

#: the states a record moves through
STATUSES = ("candidate", "production", "rejected", "archived")

#: alias-document keys that together describe a live canary; cleared as a
#: unit by every canary-ending CAS (abort, promote, repair) and kept across
#: an ordinary promotion
CANARY_DOC_KEYS = ("canary", "canary_fraction", "canary_seed", "canary_day")

#: a validating read makes 1 + CORRUPT_READ_RETRIES attempts
CORRUPT_READ_RETRIES = 2


class RegistryCorrupt(RuntimeError):
    """The alias document failed validation on every read attempt.
    Callers keep their current state: falling back to the latest
    checkpoint here would put an ungated model live."""


def _count_corrupt(kind: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_corrupt_records_total",
        "Registry reads that failed JSON/schema validation, by kind",
    ).inc(kind=kind)


def _validated_read(store: ArtefactStore, key: str, schema: str, kind: str) -> dict | None:
    """Read and validate a registry JSON document: None when the key is
    absent, or when it stays corrupt past the retry budget (which flags
    the store's registry state for repair). Every corrupt attempt counts
    into ``bodywork_tpu_registry_corrupt_records_total{kind}``."""
    corrupt = False
    for _attempt in range(1 + CORRUPT_READ_RETRIES):
        try:
            raw = store.get_bytes(key)
        except ArtefactNotFound:
            return None
        try:
            doc = json.loads(raw.decode("utf-8"))
            # a digest-less legacy document (None) stays acceptable
            if (isinstance(doc, dict) and doc.get("schema") == schema
                    and verify_doc(doc) is not False):
                return doc
        except (UnicodeDecodeError, ValueError):
            pass
        corrupt = True
        _count_corrupt(kind)
        log.warning(f"corrupt registry document at {key!r}; re-reading")
    if corrupt:
        store.mutable_cache("_registry_state")["repair_needed"] = True
    return None


def _dumps(doc: dict) -> bytes:
    """The stored form of a registry document, byte for byte the JAX
    package's: digest-stamped, sorted keys, indent 1."""
    return json.dumps(stamp_doc(doc), sort_keys=True, indent=1).encode("utf-8")


# -- per-model records -----------------------------------------------------


def load_record(store: ArtefactStore, model_key: str, with_token: bool = False):
    """The record for ``model_key``, or None (absent, or corrupt past the
    retry budget). ``with_token=True`` returns ``(record_or_None, token)``
    with the token read before the payload, so a CAS against it wins only
    if nothing changed since; ``(None, token)`` means the key exists but
    is corrupt, and a CAS against the token repairs it."""
    key = registry_record_key(model_key)
    token = store.version_token(key) if with_token else None
    doc = _validated_read(store, key, RECORD_SCHEMA, "record")
    return (doc, token) if with_token else doc


def put_record(store: ArtefactStore, record: dict, expected_token) -> str:
    """Write one record by CAS against the token its read was taken
    under (None: create-only)."""
    key = registry_record_key(record["model_key"])
    store.put_bytes_if_match(key, _dumps(record), expected_token)
    return key


def update_record(store: ArtefactStore, model_key: str, mutate, attempts: int = 4):
    """CAS read-modify-write of one record: load (token first), apply
    ``mutate(record_or_None) -> record_or_None``, write conditionally; a
    lost race re-reads and re-applies. Returns the written record, or
    None when ``mutate`` returned None (nothing to do)."""
    last: CasConflict | None = None
    for _attempt in range(attempts):
        record, token = load_record(store, model_key, with_token=True)
        updated = mutate(record)
        if updated is None:
            return None
        try:
            put_record(store, updated, expected_token=token)
            return updated
        except CasConflict as exc:
            last = exc
    raise last


def list_records(store: ArtefactStore) -> list[dict]:
    """All readable records, oldest first (date-key order)."""
    out = []
    for key, _d in store.history(REGISTRY_RECORDS_PREFIX):
        doc = _validated_read(store, key, RECORD_SCHEMA, "record")
        if doc is not None:
            out.append(doc)
    return out


def model_digest(data: bytes) -> str:
    """A checkpoint's lineage digest: sha256 of its bytes (independent of
    the backend, unlike a version token)."""
    return sha256_digest(data)


def _dataset_days(store: ArtefactStore) -> dict:
    days = [str(d) for _k, d in store.history(DATASETS_PREFIX)]
    return {"first": days[0] if days else None, "last": days[-1] if days else None,
            "count": len(days)}


def register_candidate(
    store: ArtefactStore,
    model_key: str,
    metrics_key: str | None = None,
    day: date | None = None,
    model_bytes: bytes | None = None,
    prediction_bounds: dict | None = None,
) -> dict:
    """Create (or refresh) the candidate record of a persisted checkpoint:
    its lineage and a ``registered`` event. The checkpoint takes traffic
    only after a promotion moves the alias. Registering the same bytes
    again leaves the record byte-stable; new bytes under the same key
    refresh the lineage (and make a rejected or archived record a
    candidate again; production keeps its status). ``model_bytes`` spares
    a caller that just wrote the checkpoint its re-read;
    ``prediction_bounds`` (``{"lo", "hi"}``) is the serving firewall's
    sanity band."""
    model_date = date_from_key(model_key)
    day = day or model_date
    if metrics_key is None and model_date is not None:
        metrics_key = model_metrics_key(model_date)
        if not store.exists(metrics_key):
            metrics_key = None
    if model_bytes is None:
        model_bytes = store.get_bytes(model_key)
    digest = model_digest(model_bytes)
    days = _dataset_days(store)

    def _mutate(existing: dict | None) -> dict | None:
        if existing is not None:
            if existing.get("model_digest") == digest:
                return None  # the same checkpoint: the record stands
            record = existing
            record["model_digest"] = digest
            record["metrics_key"] = metrics_key
            record["dataset_days"] = days
            if prediction_bounds is not None:
                record["prediction_bounds"] = prediction_bounds
            if record.get("status") != "production":
                record["status"] = "candidate"
        else:
            record = {
                "schema": RECORD_SCHEMA,
                "model_key": model_key,
                "model_digest": digest,
                "data_date": str(model_date) if model_date else None,
                "dataset_days": days,
                "metrics_key": metrics_key,
                "status": "candidate",
                "history": [],
            }
            if prediction_bounds is not None:
                record["prediction_bounds"] = prediction_bounds
        record["history"].append(
            {"event": "registered", "day": str(day) if day else None,
             **({"digest_changed": True} if existing is not None else {})}
        )
        return record

    record = update_record(store, model_key, _mutate)
    if record is None:
        return load_record(store, model_key)
    log.info(f"registered candidate {model_key} ({digest[:15]}…)")
    return record


def append_event(store: ArtefactStore, model_key: str, event: dict,
                 status: str | None = None) -> dict | None:
    """Append one event to a record's history and optionally move its
    status (one CAS read-modify-write). None when there is no record."""
    if status is not None and status not in STATUSES:
        raise ValueError(f"unknown record status {status!r}")

    def _mutate(record: dict | None) -> dict | None:
        if record is None:
            return None
        record["history"].append(event)
        if status is not None:
            record["status"] = status
        return record

    return update_record(store, model_key, _mutate)


# -- the alias document ----------------------------------------------------


def read_aliases(store: ArtefactStore, with_token: bool = False):
    """The validated alias document, or None when there is none.
    ``with_token=True`` returns ``(doc, token)`` with the token read
    before the payload. Raises :class:`RegistryCorrupt` when the document
    exists but stays invalid past the retry budget."""
    token = store.version_token(REGISTRY_ALIAS_KEY)
    if token is None and not store.exists(REGISTRY_ALIAS_KEY):
        return (None, None) if with_token else None
    doc = _validated_read(store, REGISTRY_ALIAS_KEY, ALIAS_SCHEMA, "alias")
    if doc is None:
        if store.exists(REGISTRY_ALIAS_KEY):
            raise RegistryCorrupt(
                f"alias document {REGISTRY_ALIAS_KEY!r} failed validation "
                "on every read attempt"
            )
        return (None, None) if with_token else None
    return (doc, token) if with_token else doc


def write_aliases(store: ArtefactStore, doc: dict, expected_token):
    """One CAS write of the alias document (raises
    :class:`~bodywork_tpu_torch.store.base.CasConflict` when another
    writer won): the only way it is ever written."""
    if doc.get("schema") != ALIAS_SCHEMA:
        raise ValueError(f"not an alias document: {doc!r}")
    return store.put_bytes_if_match(REGISTRY_ALIAS_KEY, _dumps(doc), expected_token)


def registry_exists(store: ArtefactStore) -> bool:
    """True when the store has an active registry, an alias document.
    Records alone do not count: before the first promotion there is
    nothing gated to serve, so serving keeps the latest checkpoint."""
    return store.exists(REGISTRY_ALIAS_KEY)


def resolve_alias(store: ArtefactStore, alias: str = "production") -> str | None:
    """The model key ``alias`` maps to, or None (no registry, or the
    alias unset). Raises :class:`RegistryCorrupt` for an unreadable alias
    document."""
    doc = read_aliases(store)
    if doc is None:
        return None
    return doc.get(alias)


def resolve_canary(store: ArtefactStore, doc: dict | None = None):
    """The live canary's serving state from the alias document:
    ``(state, dangling_reason)``. ``state`` is ``{"key", "fraction",
    "seed", "day", "bounds"}`` for a serveable canary, else None;
    ``dangling_reason`` says why a set slot must be ignored (the canary is
    production already, its checkpoint is gone, its record rejected, or
    its fraction or seed malformed): serving then runs production only,
    and the reload watcher repairs the slot. ``doc`` spares a caller that
    already read the alias document a second read."""
    if doc is None:
        doc = read_aliases(store)
    if not doc:
        return None, None
    key = doc.get("canary")
    if not key:
        return None, None
    if key == doc.get("production"):
        return None, f"canary {key!r} already IS production"
    if not store.exists(key):
        return None, f"canary checkpoint {key!r} missing from the store"
    record = load_record(store, key)
    if record is not None and record.get("status") == "rejected":
        return None, f"canary {key!r} record is rejected"
    bounds = (record or {}).get("prediction_bounds")
    try:
        fraction = float(doc.get("canary_fraction", 0.1))
        seed = int(doc.get("canary_seed", 0))
    except (TypeError, ValueError):
        return None, f"canary {key!r} has malformed fraction/seed"
    if not 0.0 < fraction <= 1.0:
        return None, f"canary {key!r} fraction {fraction!r} outside (0, 1]"
    state = {
        "key": key,
        "fraction": fraction,
        "seed": seed,
        "day": doc.get("canary_day"),
        "bounds": bounds,
    }
    return state, None
