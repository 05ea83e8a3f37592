"""Full-store integrity scrub ("fsck"): find at-rest corruption NOW (the
port's copy of ``bodywork_tpu.audit.fsck``: the same checkers, findings,
report document and counters, so both packages' scrubs of one store
report alike).

Every durability guarantee before this subsystem verifies *lazily at
read time*: the snapshot loader validates when training reads, registry
readers validate when the gate runs, resume verification re-hashes when
a day restarts. An artefact nobody reads stays unverified forever — so
silent at-rest corruption of a COLD artefact (an old dataset day, the
``previous`` alias checkpoint, a tail snapshot) is a latent outage that
detonates exactly when the resilience machinery needs it: a rollback or
trainstate rebuild lands on garbage. The scrubber closes that gap by
walking EVERY prefix in ``schema.ALL_PREFIXES`` on a schedule (``cli
fsck``, the k8s scrub CronJob) and verifying each artefact against
write-time evidence:

- raw-byte sha256 sidecars for datasets, checkpoints, and metrics
  (:mod:`bodywork_tpu_torch.audit.manifest`), cross-checked against run-journal
  artefact digests and registry lineage digests;
- embedded ``doc_digest`` fields for journals, registry records, and the
  alias document (``utils.integrity``); trainstate's own payload digest;
- structural self-validation for snapshots (zip CRC + manifest row
  counts — a single-byte flip always changes the CRC32);
- the cross-subsystem reference graph: alias slots -> records ->
  checkpoints/metrics, snapshot manifests -> dataset days, journals ->
  stage artefacts.

Findings carry a severity from the repair planner's point of view:

- ``rebuildable`` — derived state with a deterministic rebuild path
  (snapshots re-compact from datasets; trainstate and journals are
  rebuilt by the next train/run);
- ``restorable`` — an independent redundant copy exists (dataset days
  restore from snapshot slices, checkpoints/metrics/registry documents
  from their sidecar replicas, dangling alias slots demote in one CAS)
  and every restore is DIGEST-VERIFIED before it lands;
- ``data_loss`` — no redundancy survives; the corrupt bytes are
  quarantined and reported, never silently "fixed";
- ``advisory`` — hygiene, not corruption (missing write-time digest on
  a legacy artefact, orphan sidecars, stale lineage digests).

``run_fsck(store, repair=True)`` executes the safe subset
(:mod:`bodywork_tpu_torch.audit.repair`): corrupt bytes move to
``quarantine/`` (CAS-written, never deleted by the framework), derived
artefacts are rebuilt, replicas restored, dangling references demoted.
Metrics: ``bodywork_tpu_audit_scans_total{prefix}``,
``bodywork_tpu_audit_findings_total{prefix,severity,problem}``,
``bodywork_tpu_audit_repairs_total{prefix,action,outcome}``.

The checker registry :data:`CHECKERS` covers exactly
``schema.ALL_PREFIXES`` (tests/test_torch_audit.py pins it).

Deliberately torch-free and jax-free: the scrubber runs on plain CPU pods
(the scrub CronJob) and must never pay, or require, an accelerator
runtime (a subprocess test pins it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json

from bodywork_tpu_torch.audit.manifest import artefact_sha256, read_sidecar
from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import (
    ALL_PREFIXES,
    AUDIT_PREFIX,
    DATASETS_PREFIX,
    FLIGHTREC_PREFIX,
    MODEL_METRICS_PREFIX,
    MODELS_PREFIX,
    QUARANTINE_META_SUFFIX,
    QUARANTINE_PREFIX,
    REGISTRY_ALIAS_KEY,
    REGISTRY_PREFIX,
    REGISTRY_RECORDS_PREFIX,
    RUNS_PREFIX,
    SERVE_PREFIX,
    SNAPSHOTS_PREFIX,
    TENANTS_PREFIX,
    TEST_METRICS_PREFIX,
    TRAINSTATE_PREFIX,
    TUNING_PREFIX,
    audit_digest_key,
    audit_primary_key,
)
from bodywork_tpu_torch.utils.integrity import verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("audit.fsck")

FSCK_REPORT_SCHEMA = "bodywork_tpu.fsck_report/1"

#: the severity taxonomy, most to least repairable (module docstring)
SEVERITIES = ("rebuildable", "restorable", "data_loss", "advisory")

#: severities an operator must care about (everything but hygiene)
ACTIONABLE = ("rebuildable", "restorable", "data_loss")

__all__ = [
    "ACTIONABLE",
    "CHECKERS",
    "FSCK_REPORT_SCHEMA",
    "Finding",
    "FsckContext",
    "SEVERITIES",
    "run_fsck",
]


@dataclasses.dataclass
class Finding:
    """One integrity defect at one key. ``repair`` names the planner
    action that can fix it (None = not auto-repairable: data loss, or
    an operator decision like a dangling production alias)."""

    key: str
    prefix: str
    problem: str
    severity: str
    detail: str = ""
    repair: str | None = None

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _get(store: ArtefactStore, key: str) -> bytes | None:
    try:
        return store.get_bytes(key)
    except ArtefactNotFound:
        return None  # listed-then-vanished: racing maintenance, skip


def _json_doc(data: bytes) -> dict | None:
    try:
        doc = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _csv_parses(data: bytes) -> bool:
    """Cheap structural sanity for CSV artefacts: decodable text whose
    rows all carry the header's column count. (The authoritative check
    is the digest; this only grades corruption of UNDIGESTED legacy
    artefacts.)"""
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        return False
    lines = [ln for ln in text.splitlines() if ln]
    if not lines:
        return False
    width = lines[0].count(",")
    return all(ln.count(",") == width for ln in lines)


# -- trainstate validation (mirrors train/incremental.py, torch-free) ------

_TRAINSTATE_SCHEMA = "bodywork_tpu.trainstate/1"


def _trainstate_payload_digest(doc: dict) -> str:
    # mirror of train.incremental._payload_digest, duplicated here so
    # the scrubber never imports the training stack (which pulls torch);
    # tests/test_torch_audit.py pins the two implementations equal
    payload = json.dumps(
        [doc["model_type"], doc["feature_dim"], doc["split"],
         doc["cum_g"], doc["cum_c"], doc["days"]],
        sort_keys=True,
    ).encode("utf-8")
    return "sha256:" + hashlib.sha256(payload).hexdigest()


def _trainstate_valid(doc: dict | None) -> bool:
    if doc is None or doc.get("schema") != _TRAINSTATE_SCHEMA:
        return False
    try:
        return doc.get("digest") == _trainstate_payload_digest(doc)
    except (KeyError, TypeError, ValueError):
        return False


# -- the shared scan context ----------------------------------------------


class FsckContext:
    """One scrub's shared evidence: listings per prefix, run-journal
    artefact digests, registry lineage digests, sidecar reads, and
    loadable snapshot manifests — each computed once, consulted by
    every checker."""

    def __init__(self, store: ArtefactStore):
        self.store = store
        self.keys = {p: store.list_keys(p) for p in ALL_PREFIXES}
        #: every listed key across all prefixes — existence checks
        #: answer from the listings already fetched instead of paying
        #: one store round-trip per key
        self.all_keys: set[str] = set().union(*self.keys.values())
        self._sidecars: dict[str, tuple] = {}
        self._journal_digests: dict[str, str] | None = None
        self._record_digests: dict[str, str] | None = None
        self._snapshots: list[tuple[str, dict]] | None = None

    def record_keys(self) -> list[str]:
        return [
            k for k in self.keys[REGISTRY_PREFIX]
            if k.startswith(REGISTRY_RECORDS_PREFIX)
        ]

    def sidecar(self, key: str):
        if key not in self._sidecars:
            self._sidecars[key] = read_sidecar(self.store, key)
        return self._sidecars[key]

    def journal_digests(self) -> dict[str, str]:
        """``{artefact key: digest}`` across every VALID journal's
        completed stages — independent write-time evidence that
        predates this subsystem's sidecars."""
        if self._journal_digests is None:
            out: dict[str, str] = {}
            for key in self.keys[RUNS_PREFIX]:
                doc = _json_doc(_get(self.store, key) or b"")
                if (
                    doc is None
                    or doc.get("schema") != "bodywork_tpu.run_journal/1"
                    or verify_doc(doc) is False
                ):
                    continue  # the runs/ checker reports it
                for entry in (doc.get("stages") or {}).values():
                    if entry.get("state") == "complete":
                        out.update(entry.get("artefacts") or {})
            self._journal_digests = out
        return self._journal_digests

    def record_digests(self) -> dict[str, str]:
        """``{model key: lineage digest}`` from every VALID registry
        record."""
        if self._record_digests is None:
            out = {}
            for key in self.record_keys():
                doc = _json_doc(_get(self.store, key) or b"")
                if (
                    doc is not None
                    and doc.get("schema") == "bodywork_tpu.registry_record/1"
                    and verify_doc(doc) is not False
                    and doc.get("model_key")
                    and doc.get("model_digest")
                ):
                    out[doc["model_key"]] = doc["model_digest"]
            self._record_digests = out
        return self._record_digests

    def snapshots(self) -> list[tuple[str, dict]]:
        """Every LOADABLE snapshot as ``(key, manifest)``, newest first
        — the dataset restore sources. Loading fully reads each
        artefact, which is the corruption check (zip CRC)."""
        if self._snapshots is None:
            import numpy as np

            out = []
            for key in reversed(self.keys[SNAPSHOTS_PREFIX]):
                raw = _get(self.store, key)
                if raw is None:
                    continue
                try:
                    with np.load(io.BytesIO(raw), allow_pickle=False) as npz:
                        manifest = json.loads(str(npz["manifest"][()]))
                        n_rows = sum(
                            e["rows"] for e in manifest["covered"]
                        )
                        if (
                            manifest.get("schema")
                            != "bodywork_tpu.history_snapshot/1"
                            or npz["X"].shape[0] != n_rows
                            or npz["y"].shape[0] != n_rows
                        ):
                            raise ValueError("manifest/array mismatch")
                except Exception:
                    continue  # the snapshots/ checker reports it
                out.append((key, manifest))
            self._snapshots = out
        return self._snapshots

    def snapshot_covered(self, key: str) -> bool:
        return any(
            any(e["key"] == key for e in manifest["covered"])
            for _k, manifest in self.snapshots()
        )

    def evidence(self, key: str) -> dict[str, str]:
        """Every self-valid write-time digest recorded for ``key``, by
        source. A source that is itself corrupt never testifies (its
        own checker reports it instead)."""
        out = {}
        doc, status = self.sidecar(key)
        if status == "ok":
            out["sidecar"] = doc["sha256"]
        digest = self.journal_digests().get(key)
        if digest:
            out["journal"] = digest
        if key.startswith(MODELS_PREFIX):
            digest = self.record_digests().get(key)
            if digest:
                out["record"] = digest
        return out


# -- per-prefix checkers ---------------------------------------------------


def _corruption_resolution(ctx: FsckContext, key: str):
    """``(severity, repair)`` for a corrupt/missing primary artefact —
    the repair-feasibility half of the taxonomy."""
    if key.startswith(DATASETS_PREFIX):
        if ctx.snapshot_covered(key):
            return "restorable", "restore_dataset"
        return "data_loss", None
    doc, status = ctx.sidecar(key)
    if status == "ok" and doc.get("replica"):
        return "restorable", "restore_replica"
    return "data_loss", None


def _check_digested_prefix(ctx: FsckContext, prefix: str) -> list[Finding]:
    """The shared scan for raw-byte-digested classes (datasets, models,
    both metrics families): re-hash each artefact against every
    write-time evidence source, then sweep for referenced-but-missing
    keys."""
    out = []
    present = set(ctx.keys[prefix])
    for key in ctx.keys[prefix]:
        data = _get(ctx.store, key)
        if data is None:
            continue
        actual = artefact_sha256(data)
        sources = ctx.evidence(key)
        if not sources:
            out.append(Finding(
                key, prefix, "undigested", "advisory",
                detail="no write-time digest recorded (pre-manifest "
                       "artefact); corruption here would be invisible",
                repair="backfill_digest",
            ))
            if not _csv_parses(data) and not key.startswith(MODELS_PREFIX):
                severity, repair = _corruption_resolution(ctx, key)
                out.append(Finding(
                    key, prefix, "unreadable", severity,
                    detail="undigested artefact fails structural parse",
                    repair=repair,
                ))
            continue
        if actual in sources.values():
            # healthy primary; a DISAGREEING stale source is that
            # source's defect, not the artefact's
            doc, status = ctx.sidecar(key)
            if status == "ok" and doc["sha256"] != actual:
                out.append(Finding(
                    audit_digest_key(key), AUDIT_PREFIX,
                    "stale_sidecar", "restorable",
                    detail=f"sidecar digest disagrees with a healthy "
                           f"{key!r} (journal/record evidence matches)",
                    repair="rebuild_sidecar",
                ))
            if (
                key.startswith(MODELS_PREFIX)
                and "record" in sources
                and sources["record"] != actual
            ):
                out.append(Finding(
                    key, prefix, "lineage_mismatch", "advisory",
                    detail="registry record digest is stale for a "
                           "checkpoint whose sidecar/journal evidence "
                           "matches",
                    repair="reregister_digest",
                ))
            continue
        severity, repair = _corruption_resolution(ctx, key)
        expected = sources.get("sidecar") or next(iter(sources.values()))
        out.append(Finding(
            key, prefix, "digest_mismatch", severity,
            detail=f"recorded {expected[:15]}… "
                   f"({'/'.join(sorted(sources))}) != actual "
                   f"{actual[:15]}…",
            repair=repair,
        ))
    # the reference graph: evidence for keys that no longer exist
    referenced = {
        k for k in ctx.journal_digests() if k.startswith(prefix)
    }
    referenced |= {
        audit_primary_key(s) for s in ctx.keys[AUDIT_PREFIX]
        if (audit_primary_key(s) or "").startswith(prefix)
    }
    if prefix == MODELS_PREFIX:
        referenced |= set(ctx.record_digests())
    for key in sorted(referenced - present):
        severity, repair = _corruption_resolution(ctx, key)
        out.append(Finding(
            key, prefix, "missing_artefact", severity,
            detail="referenced by journal/sidecar/record evidence but "
                   "absent from the store",
            repair=repair,
        ))
    return out


def _check_datasets(ctx: FsckContext) -> list[Finding]:
    return _check_digested_prefix(ctx, DATASETS_PREFIX)


def _check_models(ctx: FsckContext) -> list[Finding]:
    return _check_digested_prefix(ctx, MODELS_PREFIX)


def _check_model_metrics(ctx: FsckContext) -> list[Finding]:
    return _check_digested_prefix(ctx, MODEL_METRICS_PREFIX)


def _check_test_metrics(ctx: FsckContext) -> list[Finding]:
    return _check_digested_prefix(ctx, TEST_METRICS_PREFIX)


def _check_snapshots(ctx: FsckContext) -> list[Finding]:
    out = []
    loadable = {key for key, _m in ctx.snapshots()}
    dataset_keys = set(ctx.keys[DATASETS_PREFIX])
    for key in ctx.keys[SNAPSHOTS_PREFIX]:
        data = _get(ctx.store, key)
        if data is None:
            continue
        doc, status = ctx.sidecar(key)
        if status == "ok" and doc["sha256"] != artefact_sha256(data):
            # the raw-byte check: a flip in zip slack loads fine but is
            # still rot — derived state, so the resolution is the same
            # re-compaction as a structural failure
            out.append(Finding(
                key, SNAPSHOTS_PREFIX, "digest_mismatch", "rebuildable",
                detail="snapshot bytes no longer match the write-time "
                       "sidecar digest — re-compacted from the per-day "
                       "datasets",
                repair="rebuild_snapshot",
            ))
        elif key not in loadable:
            out.append(Finding(
                key, SNAPSHOTS_PREFIX, "unreadable", "rebuildable",
                detail="snapshot fails to load (zip CRC / manifest "
                       "validation) — derived state, re-compacted from "
                       "the per-day datasets",
                repair="rebuild_snapshot",
            ))
        elif status == "absent":
            out.append(Finding(
                key, SNAPSHOTS_PREFIX, "undigested", "advisory",
                detail="no write-time digest recorded (pre-manifest "
                       "snapshot); zip-slack rot here would be invisible",
                repair="backfill_digest",
            ))
    for key, manifest in ctx.snapshots():
        missing = [
            e["key"] for e in manifest["covered"]
            if e["key"] not in dataset_keys
        ]
        if missing:
            out.append(Finding(
                key, SNAPSHOTS_PREFIX, "missing_ref", "advisory",
                detail=f"manifest covers deleted dataset day(s) "
                       f"{missing[:3]} — stale, the compactor's next "
                       "write supersedes it",
            ))
    return out


def _check_trainstate(ctx: FsckContext) -> list[Finding]:
    out = []
    dataset_keys = set(ctx.keys[DATASETS_PREFIX])
    for key in ctx.keys[TRAINSTATE_PREFIX]:
        doc = _json_doc(_get(ctx.store, key) or b"")
        if not _trainstate_valid(doc):
            out.append(Finding(
                key, TRAINSTATE_PREFIX, "digest_mismatch", "rebuildable",
                detail="trainstate fails schema/payload-digest "
                       "validation — derived state, the next train run "
                       "rebuilds it from the datasets (one O(history) "
                       "refit, never a wrong model)",
                repair="drop_trainstate",
            ))
            continue
        from datetime import date as _date

        from bodywork_tpu_torch.store.schema import dataset_key

        def _absent(day: str) -> bool:
            try:
                return dataset_key(_date.fromisoformat(day)) not in dataset_keys
            except ValueError:
                return True

        stale = [d for d in doc.get("days", {}) if _absent(d)]
        if stale:
            out.append(Finding(
                key, TRAINSTATE_PREFIX, "missing_ref", "advisory",
                detail=f"covers deleted dataset day(s) {stale[:3]}; "
                       "the next train run refolds from what exists",
            ))
    return out


def _check_runs(ctx: FsckContext) -> list[Finding]:
    out = []
    for key in ctx.keys[RUNS_PREFIX]:
        doc = _json_doc(_get(ctx.store, key) or b"")
        if (
            doc is None
            or doc.get("schema") != "bodywork_tpu.run_journal/1"
            or verify_doc(doc) is False
        ):
            out.append(Finding(
                key, RUNS_PREFIX, "unreadable", "rebuildable",
                detail="journal fails schema/doc-digest validation — "
                       "operational state; dropping it only forfeits "
                       "crash-resume for that day (the next run "
                       "re-executes and converges)",
                repair="drop_journal",
            ))
    return out


def _stale_registry_sidecar(ctx: FsckContext, key: str, data: bytes):
    """A HEALTHY (self-digest-valid) registry document whose sidecar
    records a different sha is carrying a stale replica — the crash
    window between the primary CAS and the sidecar write. Undetected,
    a later replica restore would silently roll the document back one
    write, so the scrub refreshes it from the (trustworthy) primary."""
    doc, status = ctx.sidecar(key)
    if status == "ok" and doc["sha256"] != artefact_sha256(data):
        return Finding(
            audit_digest_key(key), AUDIT_PREFIX, "stale_sidecar",
            "restorable",
            detail=f"sidecar replica lags the healthy {key!r} (a crash "
                   "between the CAS and the sidecar write); re-recorded "
                   "so a future restore cannot roll the document back",
            repair="rebuild_sidecar",
        )
    return None


def _check_registry(ctx: FsckContext) -> list[Finding]:
    out = []
    model_keys = set(ctx.keys[MODELS_PREFIX])
    for key in ctx.record_keys():
        raw = _get(ctx.store, key) or b""
        doc = _json_doc(raw)
        if (
            doc is not None
            and doc.get("schema") == "bodywork_tpu.registry_record/1"
            and verify_doc(doc) is not False
        ):
            stale = _stale_registry_sidecar(ctx, key, raw)
            if stale is not None:
                out.append(stale)
        if (
            doc is None
            or doc.get("schema") != "bodywork_tpu.registry_record/1"
            or verify_doc(doc) is False
        ):
            sidecar_doc, status = ctx.sidecar(key)
            restorable = status == "ok" and sidecar_doc.get("replica")
            out.append(Finding(
                key, REGISTRY_PREFIX, "unreadable",
                "restorable" if restorable else "data_loss",
                detail="record fails schema/doc-digest validation"
                       + ("" if restorable else
                          " and carries no sidecar replica — lineage "
                          "history lost"),
                repair="restore_replica" if restorable else None,
            ))
    # the alias document and its reference graph
    alias_raw = _get(ctx.store, REGISTRY_ALIAS_KEY)
    if alias_raw is not None:
        doc = _json_doc(alias_raw)
        if (
            doc is None
            or doc.get("schema") != "bodywork_tpu.registry_aliases/1"
            or verify_doc(doc) is False
        ):
            sidecar_doc, status = ctx.sidecar(REGISTRY_ALIAS_KEY)
            restorable = status == "ok" and sidecar_doc.get("replica")
            out.append(Finding(
                REGISTRY_ALIAS_KEY, REGISTRY_PREFIX, "unreadable",
                "restorable" if restorable else "data_loss",
                detail="alias document fails validation (serving "
                       "readers raise RegistryCorrupt)"
                       + ("; sidecar replica restores it — note the "
                          "replica may lag the last CAS by one write"
                          if restorable else
                          " and no sidecar replica survives"),
                repair="restore_replica" if restorable else None,
            ))
        else:
            stale = _stale_registry_sidecar(
                ctx, REGISTRY_ALIAS_KEY, alias_raw
            )
            if stale is not None:
                out.append(stale)
            production = doc.get("production")
            if production and production not in model_keys:
                out.append(Finding(
                    REGISTRY_ALIAS_KEY, REGISTRY_PREFIX, "dangling_alias",
                    "data_loss",
                    detail=f"production -> missing checkpoint "
                           f"{production!r}; NOT auto-repaired — "
                           "deciding what serves is an operator call "
                           "(rollback or promote; docs/RESILIENCE.md "
                           "§11 runbook)",
                ))
            previous = doc.get("previous")
            if previous and previous not in model_keys:
                out.append(Finding(
                    REGISTRY_ALIAS_KEY, REGISTRY_PREFIX, "dangling_alias",
                    "restorable",
                    detail=f"previous -> missing checkpoint "
                           f"{previous!r}; demoted (slot cleared in one "
                           "CAS) so a future rollback cannot land on it",
                    repair="clear_previous",
                ))
            canary = doc.get("canary")
            if canary and canary not in model_keys:
                out.append(Finding(
                    REGISTRY_ALIAS_KEY, REGISTRY_PREFIX, "dangling_alias",
                    "restorable",
                    detail=f"canary -> missing checkpoint {canary!r}; "
                           "repaired exactly like the reload watcher "
                           "would (one CAS + a canary_repaired event)",
                    repair="repair_canary",
                ))
    return out


def _check_audit(ctx: FsckContext) -> list[Finding]:
    out = []
    for sidecar_key in ctx.keys[AUDIT_PREFIX]:
        primary = audit_primary_key(sidecar_key)
        if primary is None:
            out.append(Finding(
                sidecar_key, AUDIT_PREFIX, "unexpected_key", "advisory",
                detail="not a well-formed digest-sidecar key",
            ))
            continue
        primary_exists = primary in ctx.all_keys
        doc, status = ctx.sidecar(primary)
        if status == "corrupt":
            out.append(Finding(
                sidecar_key, AUDIT_PREFIX, "unreadable",
                "restorable" if primary_exists else "advisory",
                detail="sidecar fails validation; "
                       + ("re-recorded from the primary bytes"
                          if primary_exists else "primary is gone too"),
                repair=(
                    "rebuild_sidecar" if primary_exists
                    else "drop_orphan_sidecar"
                ),
            ))
        elif not primary_exists:
            out.append(Finding(
                sidecar_key, AUDIT_PREFIX, "orphan_sidecar", "advisory",
                detail=f"primary {primary!r} no longer exists",
                repair="drop_orphan_sidecar",
            ))
    return out


def _check_flightrec(ctx: FsckContext) -> list[Finding]:
    """Flight-recorder dumps (``obs/tracing.py``): schema-tagged JSON
    with an embedded ``doc_digest`` plus (when written through an
    audited store) a raw-byte sidecar carrying a compressed replica —
    evidence with no producer to rebuild it, so the sidecar replica is
    the ONLY restore path and a dump rotting without one is data loss
    of forensics (reported, quarantined, never fabricated)."""
    from bodywork_tpu_torch.obs.tracing import validate_flight_record

    out = []
    for key in ctx.keys[FLIGHTREC_PREFIX]:
        data = _get(ctx.store, key)
        if data is None:
            continue
        sidecar_doc, status = ctx.sidecar(key)
        valid = validate_flight_record(_json_doc(data))
        digest_ok = (
            status != "ok" or sidecar_doc["sha256"] == artefact_sha256(data)
        )
        if valid:
            if status == "absent":
                out.append(Finding(
                    key, FLIGHTREC_PREFIX, "undigested", "advisory",
                    detail="no write-time digest recorded (dump written "
                           "outside an audited store); whitespace rot "
                           "here would be invisible",
                    repair="backfill_digest",
                ))
            elif not digest_ok:
                # primary verifies its own embedded digest: the SIDECAR
                # is the stale half — restoring its replica would roll
                # the dump back, so re-record instead (registry rule)
                out.append(Finding(
                    audit_digest_key(key), AUDIT_PREFIX, "stale_sidecar",
                    "restorable",
                    detail=f"sidecar digest disagrees with a healthy "
                           f"{key!r} (doc digest verifies)",
                    repair="rebuild_sidecar",
                ))
            continue
        restorable = status == "ok" and sidecar_doc.get("replica")
        out.append(Finding(
            key, FLIGHTREC_PREFIX, "unreadable",
            "restorable" if restorable else "data_loss",
            detail="flight record fails schema/doc-digest validation"
                   + ("" if restorable else
                      " and no sidecar replica survives — the verdict's "
                      "forensic evidence is lost"),
            repair="restore_replica" if restorable else None,
        ))
    return out


def _check_tuning(ctx: FsckContext) -> list[Finding]:
    """Tuned serving-config documents (``tune/config.py``):
    schema-tagged JSON with an embedded ``doc_digest`` plus a raw-byte
    sidecar carrying a compressed replica. Rot is RESTORABLE while the
    replica survives; without one the document is merely rebuildable-
    by-deletion — serving already degrades to the built-in defaults on
    any validation failure, so dropping the corrupt document converges
    the store to the same state serving sees (re-running ``cli tune``
    re-fits it)."""
    from bodywork_tpu_torch.store.schema import (
        CONFIG_LOG_SCHEMA,
        COST_MODEL_SCHEMA,
        TUNED_CONFIG_SCHEMA,
    )

    out = []
    for key in ctx.keys[TUNING_PREFIX]:
        data = _get(ctx.store, key)
        if data is None:
            continue
        sidecar_doc, status = ctx.sidecar(key)
        doc = _json_doc(data)
        # the tuning/ prefix holds three document kinds, dispatched by
        # basename: the config-lifecycle log (a live CAS pointer), the
        # learned cost model, and the tuned configs themselves —
        # validating a cost model against the tuned-config schema would
        # quarantine every healthy one
        basename = key.rsplit("/", 1)[-1]
        if basename == "config-log.json":
            expected_schema = CONFIG_LOG_SCHEMA
            shape_ok = doc is not None and isinstance(
                doc.get("history"), list
            )
        elif basename.startswith("cost-model-"):
            expected_schema = COST_MODEL_SCHEMA
            shape_ok = doc is not None and isinstance(
                doc.get("weights"), list
            )
        else:
            expected_schema = TUNED_CONFIG_SCHEMA
            shape_ok = doc is not None and (
                doc.get("knobs") is None or isinstance(doc["knobs"], dict)
            )
        # validity deliberately MATCHES the serving loader's integrity
        # checks (schema tag + doc_digest + top-level shape), NOT its
        # per-knob value validation: a digest-valid document holding a
        # knob this version rejects (or none at all) was WRITTEN that
        # way — e.g. an evidence-poor fit or a newer schema — and the
        # loader degrades per knob; fsck flagging it would restore-flap
        # (replica == primary) or quarantine a healthy document
        valid = (
            doc is not None
            and doc.get("schema") == expected_schema
            and verify_doc(doc) is not False
            and shape_ok
        )
        digest_ok = (
            status != "ok" or sidecar_doc["sha256"] == artefact_sha256(data)
        )
        if valid:
            if status == "absent":
                out.append(Finding(
                    key, TUNING_PREFIX, "undigested", "advisory",
                    detail="no write-time digest recorded (tuned config "
                           "written outside an audited store); "
                           "whitespace rot here would be invisible",
                    repair="backfill_digest",
                ))
            elif not digest_ok:
                # primary verifies its own embedded digest: the SIDECAR
                # is the stale half (registry rule) — re-record it
                out.append(Finding(
                    audit_digest_key(key), AUDIT_PREFIX, "stale_sidecar",
                    "restorable",
                    detail=f"sidecar digest disagrees with a healthy "
                           f"{key!r} (doc digest verifies)",
                    repair="rebuild_sidecar",
                ))
            continue
        restorable = status == "ok" and sidecar_doc.get("replica")
        out.append(Finding(
            key, TUNING_PREFIX, "unreadable",
            "restorable" if restorable else "rebuildable",
            detail="tuned config fails schema/doc-digest/knob validation"
                   + (" — restored from the sidecar replica"
                      if restorable else
                      " and no sidecar replica survives — derived "
                      "artefact: dropped (serving already degrades to "
                      "the built-in defaults; `cli tune` re-fits it)"),
            repair="restore_replica" if restorable else "drop_tuned_config",
        ))
    return out


def _check_quarantine(ctx: FsckContext) -> list[Finding]:
    out = []
    keys = set(ctx.keys[QUARANTINE_PREFIX])
    for key in sorted(keys):
        if key.endswith(QUARANTINE_META_SUFFIX):
            doc = _json_doc(_get(ctx.store, key) or b"")
            if doc is None or verify_doc(doc) is False:
                out.append(Finding(
                    key, QUARANTINE_PREFIX, "unreadable", "advisory",
                    detail="quarantine metadata fails validation; the "
                           "incident evidence is degraded",
                ))
            continue
        meta_key = key + QUARANTINE_META_SUFFIX
        if meta_key not in keys:
            out.append(Finding(
                key, QUARANTINE_PREFIX, "missing_ref", "advisory",
                detail="quarantined payload has no metadata document",
            ))
            continue
        meta = _json_doc(_get(ctx.store, meta_key) or b"")
        data = _get(ctx.store, key)
        if (
            meta is not None
            and verify_doc(meta) is not False
            and data is not None
            and meta.get("sha256")
            and artefact_sha256(data) != meta["sha256"]
        ):
            out.append(Finding(
                key, QUARANTINE_PREFIX, "digest_mismatch", "advisory",
                detail="quarantined payload no longer matches its "
                       "capture digest — the evidence itself rotted",
            ))
    return out


def _check_tenants(ctx: FsckContext) -> list[Finding]:
    """Tenant namespaces (``tenancy/namespace.py``): every
    ``tenants/<id>/`` subtree is a complete artefact store in
    miniature, so fsck RECURSES — a tenant-scoped view of the store is
    scanned with the same per-prefix checkers, and each finding
    resurfaces here under its tenant-qualified key. Repair actions are
    deliberately stripped from the recursed findings: the repair
    planner resolves restore evidence (snapshots, sidecars, journals)
    relative to its own store root, so repair must run IN tenant scope
    — ``cli fsck --tenant <id>`` — never from the root scan. Keys whose
    first segment fails tenant-id validation cannot have been written
    through a scoped store and are flagged as hygiene defects."""
    from bodywork_tpu_torch.store.schema import validate_tenant_id
    from bodywork_tpu_torch.tenancy.namespace import TenantStore, list_tenants

    out = []
    for tid in list_tenants(ctx.store):
        sub = FsckContext(TenantStore(ctx.store, tid))
        for prefix in ALL_PREFIXES:
            for f in CHECKERS[prefix](sub):
                out.append(dataclasses.replace(
                    f,
                    key=f"{TENANTS_PREFIX}{tid}/{f.key}",
                    prefix=TENANTS_PREFIX,
                    detail=(
                        f"[tenant {tid}] {f.detail}" if f.detail
                        else f"[tenant {tid}] repairable only in tenant "
                             f"scope: cli fsck --tenant {tid}"
                    ),
                    repair=None,
                ))
    for key in ctx.keys[TENANTS_PREFIX]:
        seg = key[len(TENANTS_PREFIX):].split("/", 1)[0]
        try:
            validate_tenant_id(seg)
        except ValueError:
            out.append(Finding(
                key, TENANTS_PREFIX, "invalid_tenant_id", "advisory",
                detail=f"first segment {seg!r} fails tenant-id "
                       "validation; no scoped store can have written "
                       "this key",
            ))
    return out


def _check_serve(ctx: FsckContext) -> list[Finding]:
    """Serving-plane operational state (``serve/leadership.py``): the
    dispatcher-leader lease document. Purely operational — it names the
    CURRENT leader, not any artefact — so every defect is rebuildable:
    the next election's CAS acquire repairs a corrupt document in
    place, and a deleted one merely forces a fresh election (fence
    restarts at 1, which clients accept — fences only guard against
    REGRESSION within a document's history)."""
    from bodywork_tpu_torch.store.schema import LEADER_SCHEMA

    out = []
    for key in ctx.keys[SERVE_PREFIX]:
        doc = _json_doc(_get(ctx.store, key) or b"")
        if doc is None or doc.get("schema") != LEADER_SCHEMA:
            out.append(Finding(
                key, SERVE_PREFIX, "unreadable", "rebuildable",
                detail="serving-plane lease document fails validation; "
                       "operational state only — the next leadership "
                       "acquire CAS-repairs it in place (deleting it "
                       "just forces a fresh election)",
            ))
            continue
        if not isinstance(doc.get("fence"), int) or doc["fence"] < 0:
            out.append(Finding(
                key, SERVE_PREFIX, "unreadable", "rebuildable",
                detail="lease document carries no valid fence; the next "
                       "acquire rewrites it",
            ))
    return out


#: prefix -> auditor, pinned == schema.ALL_PREFIXES
#: (tests/test_torch_audit.py).
CHECKERS = {
    DATASETS_PREFIX: _check_datasets,
    MODELS_PREFIX: _check_models,
    MODEL_METRICS_PREFIX: _check_model_metrics,
    TEST_METRICS_PREFIX: _check_test_metrics,
    SNAPSHOTS_PREFIX: _check_snapshots,
    TRAINSTATE_PREFIX: _check_trainstate,
    RUNS_PREFIX: _check_runs,
    REGISTRY_PREFIX: _check_registry,
    TUNING_PREFIX: _check_tuning,
    AUDIT_PREFIX: _check_audit,
    QUARANTINE_PREFIX: _check_quarantine,
    FLIGHTREC_PREFIX: _check_flightrec,
    SERVE_PREFIX: _check_serve,
    TENANTS_PREFIX: _check_tenants,
}


def _count(name: str, help_text: str, **labels) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(name, help_text).inc(**labels)


def run_fsck(store: ArtefactStore, repair: bool = False) -> dict:
    """Scrub every prefix; optionally execute the safe repair subset.

    Returns the report document (schema
    ``bodywork_tpu.fsck_report/1``): per-prefix scan counts, every
    finding, repair outcomes, and the verdict pair ``clean`` (zero
    findings of any severity) / ``ok`` (zero ACTIONABLE findings left
    standing — with ``repair=True`` a finding whose repair succeeded no
    longer counts against it)."""
    ctx = FsckContext(store)
    findings: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for prefix in ALL_PREFIXES:
        _count(
            "bodywork_tpu_audit_scans_total",
            "Integrity-scrub prefix scans", prefix=prefix,
        )
        for finding in CHECKERS[prefix](ctx):
            if (finding.key, finding.problem) in seen:
                continue  # cross-checkers may converge on one defect
            seen.add((finding.key, finding.problem))
            findings.append(finding)
    for finding in findings:
        _count(
            "bodywork_tpu_audit_findings_total",
            "Integrity-scrub findings by prefix, severity, and problem",
            prefix=finding.prefix, severity=finding.severity,
            problem=finding.problem,
        )
        level = log.warning if finding.severity != "advisory" else log.info
        level(
            f"fsck {finding.severity}: {finding.problem} at "
            f"{finding.key} — {finding.detail}"
        )
    repairs: list[dict] = []
    if repair and findings:
        from bodywork_tpu_torch.audit.repair import execute_repairs

        repairs = execute_repairs(ctx, findings)
        for entry in repairs:
            _count(
                "bodywork_tpu_audit_repairs_total",
                "Integrity-scrub repairs by prefix, action, and outcome",
                prefix=entry["prefix"], action=entry["action"],
                outcome=entry["outcome"],
            )
    repaired = {
        (r["key"], r["problem"]) for r in repairs
        if r["outcome"] == "repaired"
    }
    residual = [
        f for f in findings
        if f.severity in ACTIONABLE and (f.key, f.problem) not in repaired
    ]
    by_severity: dict[str, int] = {}
    for f in findings:
        by_severity[f.severity] = by_severity.get(f.severity, 0) + 1
    return {
        "schema": FSCK_REPORT_SCHEMA,
        "prefixes": {
            p: {"keys": len(ctx.keys[p])} for p in ALL_PREFIXES
        },
        "keys_scanned": sum(len(v) for v in ctx.keys.values()),
        "findings": [f.to_dict() for f in findings],
        "by_severity": by_severity,
        "repairs": repairs,
        "residual": [f.to_dict() for f in residual],
        "clean": not findings,
        "ok": not residual,
    }
