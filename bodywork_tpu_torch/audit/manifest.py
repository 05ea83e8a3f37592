"""Write-time digest manifest: sidecar integrity records under ``audit/``
(the port's copy of ``bodywork_tpu.audit.manifest``: the same sidecar
documents, byte for byte, so either package's fsck verifies the other's
store).

Every durability layer shipped before this subsystem verifies *lazily at
read time* — an artefact nobody reads stays unverified forever. The
manifest closes the first half of that gap: for artefact classes that do
not already carry a content digest (per-day dataset CSVs, model
checkpoints, the two metrics CSV families, registry documents), a
sidecar JSON record is written alongside every write at
``audit/digests/<key>.json`` (:func:`bodywork_tpu_torch.store.schema.audit_digest_key`)
recording the primary artefact's sha256 and size. The integrity
scrubber (:mod:`bodywork_tpu_torch.audit.fsck`) re-hashes primaries against
these records on a schedule, so silent at-rest corruption of a COLD
artefact is found by the scrub loop, not by the rollback or rebuild
that lands on it months later.

For small classes with no other redundancy (checkpoints, metrics CSVs,
registry records, the alias document) the sidecar additionally embeds a
zlib-compressed REPLICA of the primary bytes — the redundancy the fsck
repair planner restores from, digest-verified, when the primary rots.
Dataset CSVs deliberately carry no replica: their redundancy is the
consolidated history snapshot (``data/snapshot.py``), and duplicating
the largest artefact class would double the store. Snapshots get a
digest sidecar but no replica — they are derived (rebuildable from
datasets), and while they partially self-validate (zip CRC + manifest
row counts), a byte flip landing in zip slack can be structurally
harmless, so only the raw-byte digest makes EVERY flip detectable.

Sidecar documents are DETERMINISTIC functions of the primary bytes
(canonical JSON, no wall clock, fixed zlib level), so the chaos
byte-identity guarantee extends over ``audit/digests/`` — with two
exceptions excluded from twin comparison
(``chaos.sim._COMPARE_EXCLUDED``): ``test-metrics/`` bytes embed a
wall-clock column and ``snapshots/`` bytes embed backend version
tokens, so those classes' sidecars legitimately differ between twins.

:class:`AuditedStore` is the transparent :class:`DelegatingStore`
wrapper that records sidecars on the write path; ``store.open_store``
installs it over every backend, so all CLI entrypoints and k8s pods
write the manifest without any stage knowing it exists.
"""
from __future__ import annotations

import base64
import json
import zlib

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, DelegatingStore
from bodywork_tpu_torch.store.schema import (
    AUDIT_PREFIX,
    DATASETS_PREFIX,
    FLIGHTREC_PREFIX,
    MODEL_METRICS_PREFIX,
    MODELS_PREFIX,
    REGISTRY_PREFIX,
    SNAPSHOTS_PREFIX,
    TEST_METRICS_PREFIX,
    TUNING_PREFIX,
    audit_digest_key,
)
from bodywork_tpu_torch.utils.integrity import sha256_digest, stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("audit.manifest")

DIGEST_SCHEMA = "bodywork_tpu.audit_digest/1"

#: classes whose raw ``put_bytes`` writes get a digest sidecar — the
#: artefact classes that carry no (complete) content digest of their
#: own: datasets, checkpoints, both metrics families, and snapshots
#: (whose zip CRC misses flips in structural slack)
PUT_SIDECAR_PREFIXES = (
    DATASETS_PREFIX,
    MODELS_PREFIX,
    MODEL_METRICS_PREFIX,
    TEST_METRICS_PREFIX,
    SNAPSHOTS_PREFIX,
    # flight-recorder dumps are one-shot evidence with no producer to
    # rebuild them — the sidecar (with replica, below) is their only
    # redundancy against at-rest rot
    FLIGHTREC_PREFIX,
    # tuned serving configs (tune/config.py): the traces they were
    # fitted from may be gone by scrub time, so the sidecar replica is
    # what makes at-rest rot restorable instead of a silent revert to
    # the hand-set defaults
    TUNING_PREFIX,
)

#: CAS-mutated classes that also get a sidecar, written after each
#: successful ``put_bytes_if_match`` (registry records + the alias
#: document, plus the tuning config-lifecycle log — a live CAS pointer
#: exactly like the alias doc, so the same stale-by-one-write rules
#: apply; journals are deliberately excluded — their bytes embed
#: lease wall-clocks, so sidecars would break the chaos twin
#: comparison, and they already embed a ``doc_digest``)
CAS_SIDECAR_PREFIXES = (REGISTRY_PREFIX, TUNING_PREFIX)

#: subset whose sidecars embed a compressed replica (small artefacts
#: with no other redundancy; datasets restore from snapshots instead)
REPLICA_PREFIXES = (
    MODELS_PREFIX,
    MODEL_METRICS_PREFIX,
    TEST_METRICS_PREFIX,
    REGISTRY_PREFIX,
    # dumps are ring-buffer bounded (a few hundred KB at most), so the
    # compressed replica is cheap insurance for unrebuildable evidence
    FLIGHTREC_PREFIX,
    # tuned configs are a few KB of knobs + decision trace
    TUNING_PREFIX,
)

#: fixed zlib level: replica bytes must be deterministic across
#: processes and platforms for the chaos twin comparison
_ZLIB_LEVEL = 6

__all__ = [
    "AuditedStore",
    "CAS_SIDECAR_PREFIXES",
    "DIGEST_SCHEMA",
    "PUT_SIDECAR_PREFIXES",
    "REPLICA_PREFIXES",
    "artefact_sha256",
    "read_sidecar",
    "replica_bytes",
    "sidecar_covered",
    "sidecar_doc",
    "write_sidecar",
]


def artefact_sha256(data: bytes) -> str:
    """Raw-byte content digest — the shared ``sha256:`` form
    (``utils.integrity.sha256_digest``) the run journal and registry
    lineage also delegate to, so evidence from all three sources
    cross-checks directly."""
    return sha256_digest(data)


def sidecar_covered(key: str) -> bool:
    """True when writes to ``key`` should record a digest sidecar."""
    return key.startswith(PUT_SIDECAR_PREFIXES + CAS_SIDECAR_PREFIXES) and (
        not key.startswith(AUDIT_PREFIX)
    )


def sidecar_doc(key: str, data: bytes) -> dict:
    doc = {
        "schema": DIGEST_SCHEMA,
        "key": key,
        "sha256": artefact_sha256(data),
        "size": len(data),
    }
    if key.startswith(REPLICA_PREFIXES):
        doc["replica_codec"] = "zlib+b64"
        doc["replica"] = base64.b64encode(
            zlib.compress(data, _ZLIB_LEVEL)
        ).decode("ascii")
    return stamp_doc(doc)


def write_sidecar(store: ArtefactStore, key: str, data: bytes) -> str:
    """Record (or refresh) the digest sidecar for ``key`` holding
    ``data``. Plain overwrite, not CAS: the sidecar is a pure function
    of the primary bytes, so concurrent writers racing on the primary
    converge on the sidecar too."""
    sidecar = audit_digest_key(key)
    store.put_bytes(
        sidecar,
        json.dumps(
            sidecar_doc(key, data), sort_keys=True, indent=1
        ).encode("utf-8"),
    )
    return sidecar


def read_sidecar(store: ArtefactStore, key: str):
    """``(doc_or_None, status)`` for ``key``'s sidecar: status is
    ``"ok"``, ``"absent"``, or ``"corrupt"`` (unparseable, wrong
    schema/key, or failed its own embedded digest)."""
    try:
        raw = store.get_bytes(audit_digest_key(key))
    except ArtefactNotFound:
        return None, "absent"
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None, "corrupt"
    if (
        not isinstance(doc, dict)
        or doc.get("schema") != DIGEST_SCHEMA
        or doc.get("key") != key
        or verify_doc(doc) is False
    ):
        return None, "corrupt"
    return doc, "ok"


def replica_bytes(doc: dict) -> bytes | None:
    """The replica payload carried by a valid sidecar doc, verified
    against the doc's own recorded digest — or None when the sidecar
    carries no replica or the decoded bytes do not hash to the recorded
    digest (a lying replica must never be restored)."""
    blob = doc.get("replica")
    if not blob or doc.get("replica_codec") != "zlib+b64":
        return None
    try:
        data = zlib.decompress(base64.b64decode(blob))
    except (ValueError, zlib.error):
        return None
    if artefact_sha256(data) != doc.get("sha256"):
        return None
    return data


class AuditedStore(DelegatingStore):
    """Transparent wrapper recording write-time digest sidecars.

    Sits OUTERMOST in the store composition (``open_store`` installs
    it), so the sidecar write rides the same resilience/chaos stack as
    the primary write it records. The primary write always lands first
    — never the reverse order, where a sidecar could describe bytes
    that were never written. A crash between the two leaves either a
    MISSING sidecar (first write of a key: the scrubber reports an
    advisory ``undigested`` finding and backfills) or a STALE one (an
    overwrite of an existing key). For journaled flows the run
    journal's digest arbitrates the stale case (the scrub trusts the
    primary and refreshes the sidecar); for a NON-journaled overwrite
    (a standalone ``cli train`` rerun) no independent evidence
    survives, so the scrub sides with the recorded evidence and may
    restore the prior write — the state the registry ledger last knew,
    since the crash also preceded re-registration. The next producer
    run converges either way.
    """

    def put_bytes(self, key: str, data: bytes) -> None:
        self._inner.put_bytes(key, data)
        if key.startswith(PUT_SIDECAR_PREFIXES):
            write_sidecar(self._inner, key, data)

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        token = self._inner.put_bytes_if_match(key, data, expected_token)
        if key.startswith(CAS_SIDECAR_PREFIXES):
            write_sidecar(self._inner, key, data)
        return token

    def delete(self, key: str) -> None:
        self._inner.delete(key)
        if sidecar_covered(key):
            try:
                self._inner.delete(audit_digest_key(key))
            except ArtefactNotFound:
                pass  # never recorded (pre-manifest artefact)
