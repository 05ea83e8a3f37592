"""The fsck repair planner: execute the SAFE subset, quarantine the rest
(the port's copy of ``bodywork_tpu.audit.repair``: the same actions, order
and report entries).

Given a scan's findings (:mod:`bodywork_tpu_torch.audit.fsck`), this module
applies every repair whose result can be trusted, in an order that
respects the store's dependency graph — restore the source-of-truth
classes first (dataset days from snapshot slices, replicas for
checkpoints/metrics/registry documents), then re-record derived
evidence (sidecars), then rebuild derived artefacts (snapshots — whose
re-compaction READS the freshly restored datasets), with
drop-and-rebuild classes (trainstate, journals) and alias demotions in
between. Three invariants:

1. **Corrupt bytes are never destroyed.** Before any overwrite or
   delete, the current bytes move to ``quarantine/<original key>`` with
   a metadata document — written through the CAS primitive, never
   deleted by the framework (retention is an operator decision).
2. **Restores are digest-verified.** A dataset rebuilt from a snapshot
   slice or a replica inflated from a sidecar is hashed against the
   recorded write-time digest BEFORE it lands; a mismatch fails the
   repair (outcome ``failed``) rather than writing unverified bytes.
3. **Data loss is reported, not repaired.** Findings with no surviving
   redundancy are quarantined (copy only — the damaged original stays
   in place, partially readable is better than gone) and surface in
   the report and metrics; nothing fabricates data.
"""
from __future__ import annotations

import json

from bodywork_tpu_torch.audit.manifest import (
    artefact_sha256,
    read_sidecar,
    replica_bytes,
    write_sidecar,
)
from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import (
    QUARANTINE_META_SUFFIX,
    REGISTRY_PREFIX,
    SNAPSHOTS_PREFIX,
    quarantine_key,
)
from bodywork_tpu_torch.utils.dates import date_from_key
from bodywork_tpu_torch.utils.integrity import stamp_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("audit.repair")

QUARANTINE_SCHEMA = "bodywork_tpu.quarantine/1"

#: execution order (module docstring): sources of truth first, derived
#: evidence next, derived artefacts last. ``None``-repair (data-loss)
#: findings are quarantine-only and run first of all.
REPAIR_ORDER = (
    "restore_dataset",
    "restore_replica",
    "rebuild_sidecar",
    "reregister_digest",
    "backfill_digest",
    "drop_orphan_sidecar",
    "drop_trainstate",
    "drop_journal",
    "drop_tuned_config",
    "clear_previous",
    "repair_canary",
    "rebuild_snapshot",
)

__all__ = ["REPAIR_ORDER", "QUARANTINE_SCHEMA", "execute_repairs", "quarantine"]


def _cas_put(store: ArtefactStore, key: str, data: bytes) -> None:
    """Create-or-overwrite through the CAS primitive (the discipline
    every mutable document class already rides): create-only first, and
    on conflict a conditional overwrite against the current token."""
    try:
        store.put_bytes_if_match(key, data, None)
    except CasConflict:
        store.put_bytes_if_match(key, data, store.version_token(key))


#: repeat-incident cap per key: each new quarantine of an already-
#: quarantined key takes the next free ``.N`` suffix instead of
#: overwriting prior evidence; past the cap the oldest contract wins
#: and the new incident is refused (a hot-looping repair must not grow
#: the store unboundedly)
_QUARANTINE_INCIDENT_CAP = 16


def quarantine(store: ArtefactStore, key: str, problem: str) -> bool:
    """Park ``key``'s current bytes at ``quarantine/<key>`` (or the
    next free ``.N``-suffixed slot for a repeat incident — quarantine
    entries are EVIDENCE and the framework never overwrites or deletes
    them) with a metadata document. Returns False when the key no
    longer exists (nothing to park). Never deletes the original —
    callers that replace or drop the primary do so themselves AFTER
    this returns."""
    try:
        data = store.get_bytes(key)
    except ArtefactNotFound:
        return False
    meta = stamp_doc({
        "schema": QUARANTINE_SCHEMA,
        "key": key,
        "problem": problem,
        "sha256": artefact_sha256(data),
        "size": len(data),
    })
    meta_bytes = json.dumps(meta, sort_keys=True, indent=1).encode("utf-8")
    base = quarantine_key(key)
    for n in range(_QUARANTINE_INCIDENT_CAP):
        slot = base if n == 0 else f"{base}.{n + 1}"
        try:
            store.put_bytes_if_match(slot, data, None)  # create-only
        except CasConflict:
            if store.get_bytes(slot) == data:
                return True  # same incident re-scrubbed: already parked
            continue  # a PRIOR incident holds the slot: next suffix
        _cas_put(store, slot + QUARANTINE_META_SUFFIX, meta_bytes)
        log.warning(
            f"quarantined {key} ({problem}, {len(data)} bytes) -> {slot}"
        )
        return True
    log.error(
        f"quarantine of {key} refused: {_QUARANTINE_INCIDENT_CAP} prior "
        "incidents already parked (evidence is never overwritten)"
    )
    return False


def _expected_digest(ctx, key: str) -> str | None:
    sources = ctx.evidence(key)
    return sources.get("sidecar") or next(iter(sources.values()), None)


def _snapshot_arrays(ctx, snap_key: str):
    """One full load per snapshot per scrub, however many dataset days
    restore from it (a multi-day rot would otherwise re-download and
    re-decompress the same artefact once per finding)."""
    import io as _io

    import numpy as np

    cache = ctx.__dict__.setdefault("_snapshot_arrays", {})
    if snap_key not in cache:
        raw = ctx.store.get_bytes(snap_key)
        with np.load(_io.BytesIO(raw), allow_pickle=False) as npz:
            cache[snap_key] = (npz["X"], npz["y"])
    return cache[snap_key]


def _restore_dataset(ctx, finding) -> tuple[str, str]:
    """Rebuild one dataset day from the newest loadable snapshot slice
    covering it, digest-verified against the write-time record. The
    CSV writer is the same deterministic ``Dataset.to_dataframe``
    round-trip that produced the original, so a healthy slice
    reproduces the original bytes exactly."""
    import io as _io

    from bodywork_tpu_torch.data.io import Dataset

    expected = _expected_digest(ctx, finding.key)
    for snap_key, manifest in ctx.snapshots():
        entries = manifest["covered"]
        if not any(e["key"] == finding.key for e in entries):
            continue
        X, y = _snapshot_arrays(ctx, snap_key)
        offset = 0
        for entry in entries:
            if entry["key"] == finding.key:
                ds = Dataset(
                    X[offset:offset + entry["rows"]],
                    y[offset:offset + entry["rows"]],
                    date_from_key(finding.key),
                )
                data = ds.to_csv().encode("utf-8")
                if expected is not None and artefact_sha256(data) != expected:
                    continue  # stale slice: try an older snapshot
                quarantine(ctx.store, finding.key, finding.problem)
                ctx.store.put_bytes(finding.key, data)
                return "repaired", f"restored from {snap_key}"
            offset += entry["rows"]
    return "failed", "no snapshot slice reproduces the recorded digest"


def _registry_doc_valid(data: bytes) -> bool:
    from bodywork_tpu_torch.utils.integrity import verify_doc

    try:
        doc = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return False
    return isinstance(doc, dict) and verify_doc(doc) is not False


def _restore_replica(ctx, finding) -> tuple[str, str]:
    doc, status = read_sidecar(ctx.store, finding.key)
    if status != "ok":
        return "failed", "sidecar no longer readable"
    data = replica_bytes(doc)
    if data is None:
        return "failed", "sidecar replica missing or fails its digest"
    if finding.key.startswith(REGISTRY_PREFIX):
        # registry documents are mutated EXCLUSIVELY through the CAS
        # primitive, and a CONCURRENT writer (a promote, the SLO
        # watchdog) may have already replaced the corrupt bytes with a
        # fresh valid document between the scan and this repair: re-read
        # under a token, confirm the corruption still stands, and CAS
        # against exactly that token — losing the race fails cleanly
        # (re-run fsck) instead of overwriting a healthy newer write
        # with the stale replica
        token = ctx.store.version_token(finding.key)
        try:
            current = ctx.store.get_bytes(finding.key)
        except ArtefactNotFound:
            current = None
        if current is not None and _registry_doc_valid(current):
            return "repaired", (
                "no longer corrupt (a concurrent writer already "
                "replaced the document); nothing restored"
            )
        quarantine(ctx.store, finding.key, finding.problem)
        try:
            ctx.store.put_bytes_if_match(finding.key, data, token)
        except CasConflict:
            return "failed", "lost the alias/record race; re-run fsck"
    else:
        quarantine(ctx.store, finding.key, finding.problem)
        ctx.store.put_bytes(finding.key, data)
    return "repaired", f"restored {len(data)} bytes from sidecar replica"


def _rebuild_sidecar(ctx, finding) -> tuple[str, str]:
    from bodywork_tpu_torch.store.schema import audit_primary_key

    primary = audit_primary_key(finding.key)
    if primary is None:
        return "failed", "not a sidecar key"
    try:
        data = ctx.store.get_bytes(primary)
    except ArtefactNotFound:
        return "failed", f"primary {primary!r} vanished"
    journal_digest = ctx.journal_digests().get(primary)
    if journal_digest is not None and artefact_sha256(data) != journal_digest:
        return "failed", (
            "primary bytes fail the journal digest; re-recording would "
            "bless corruption"
        )
    if primary.startswith(REGISTRY_PREFIX) and not _registry_doc_valid(data):
        # registry primaries carry their own doc_digest: a sidecar must
        # never be re-recorded from a primary that fails it (both
        # halves rotted = data loss, not a refresh)
        return "failed", (
            "registry primary fails its own doc digest; re-recording "
            "would bless corruption"
        )
    quarantine(ctx.store, finding.key, finding.problem)
    write_sidecar(ctx.store, primary, data)
    detail = "re-recorded from primary bytes"
    if journal_digest is None:
        detail += " (no independent evidence; digest re-registered as-is)"
    return "repaired", detail


def _reregister_digest(ctx, finding) -> tuple[str, str]:
    from bodywork_tpu_torch.registry import records as rec

    try:
        data = ctx.store.get_bytes(finding.key)
    except ArtefactNotFound:
        return "failed", "checkpoint vanished"
    digest = artefact_sha256(data)

    def _mutate(record):
        if record is None:
            return None
        record["model_digest"] = digest
        record["history"].append(
            {"event": "digest_reregistered", "day": None,
             "reason": "fsck: record digest was stale for a verified "
                       "checkpoint"}
        )
        return record

    written = rec.update_record(ctx.store, finding.key, _mutate)
    if written is None:
        return "failed", "record unreadable"
    return "repaired", f"record digest re-registered as {digest[:15]}…"


def _backfill_digest(ctx, finding) -> tuple[str, str]:
    try:
        data = ctx.store.get_bytes(finding.key)
    except ArtefactNotFound:
        return "failed", "artefact vanished"
    write_sidecar(ctx.store, finding.key, data)
    return "repaired", "write-time digest recorded (future scrubs can " \
                       "now see corruption here)"


def _drop_orphan_sidecar(ctx, finding) -> tuple[str, str]:
    try:
        ctx.store.delete(finding.key)
    except ArtefactNotFound:
        pass
    return "repaired", "orphan sidecar removed"


def _drop_and_quarantine(ctx, finding) -> tuple[str, str]:
    quarantine(ctx.store, finding.key, finding.problem)
    try:
        ctx.store.delete(finding.key)
    except ArtefactNotFound:
        pass
    return "repaired", "quarantined and dropped (derived/operational " \
                       "state; rebuilt by its producer's next run)"


def _clear_previous(ctx, finding) -> tuple[str, str]:
    from bodywork_tpu_torch.registry import records as rec

    doc, token = rec.read_aliases(ctx.store, with_token=True)
    if doc is None or not doc.get("previous"):
        return "repaired", "slot already clear"
    new_doc = {
        **doc,
        "previous": None,
        "rev": doc.get("rev", 0) + 1,
        "last_op": "fsck_clear_previous",
    }
    try:
        rec.write_aliases(ctx.store, new_doc, token)
    except CasConflict:
        return "failed", "lost the alias race; re-run fsck"
    return "repaired", "dangling previous slot demoted (one CAS)"


def _repair_canary(ctx, finding) -> tuple[str, str]:
    from bodywork_tpu_torch.registry.manager import ModelRegistry

    doc = ModelRegistry(ctx.store).canary_repair(
        reason="fsck: canary slot points at a missing checkpoint"
    )
    return "repaired", (
        "dangling canary slot cleared" if doc is not None
        else "slot already clear"
    )


def execute_repairs(ctx, findings) -> list[dict]:
    """Apply the safe repair subset in :data:`REPAIR_ORDER`; quarantine
    (copy-only) every data-loss finding. Returns one outcome entry per
    finding handled: ``{key, prefix, problem, action, outcome, detail}``
    with outcome ``repaired`` / ``failed`` / ``quarantined``."""
    handlers = {
        "restore_dataset": _restore_dataset,
        "restore_replica": _restore_replica,
        "rebuild_sidecar": _rebuild_sidecar,
        "reregister_digest": _reregister_digest,
        "backfill_digest": _backfill_digest,
        "drop_orphan_sidecar": _drop_orphan_sidecar,
        "drop_trainstate": _drop_and_quarantine,
        "drop_journal": _drop_and_quarantine,
        # a replica-less corrupt tuned config: serving already degrades
        # to the built-in defaults on it, so dropping converges the
        # store to what serving sees (`cli tune` re-fits it)
        "drop_tuned_config": _drop_and_quarantine,
        "clear_previous": _clear_previous,
        "repair_canary": _repair_canary,
    }
    out: list[dict] = []

    def _entry(finding, action, outcome, detail):
        out.append({
            "key": finding.key, "prefix": finding.prefix,
            "problem": finding.problem, "action": action,
            "outcome": outcome, "detail": detail,
        })
        level = log.info if outcome == "repaired" else log.warning
        level(f"fsck repair {action} {finding.key}: {outcome} — {detail}")

    # data loss first: park the evidence, change nothing
    for finding in findings:
        if finding.repair is None and finding.severity == "data_loss":
            parked = quarantine(ctx.store, finding.key, finding.problem)
            _entry(
                finding, "quarantine", "quarantined",
                "corrupt bytes copied to quarantine/ (original left in "
                "place)" if parked else "key absent; nothing to park",
            )
    rebuild_snapshots = [
        f for f in findings if f.repair == "rebuild_snapshot"
    ]
    for action in REPAIR_ORDER:
        if action == "rebuild_snapshot":
            continue  # batched below
        for finding in findings:
            if finding.repair != action:
                continue
            try:
                outcome, detail = handlers[action](ctx, finding)
            except Exception as exc:  # noqa: BLE001 — a repair must
                # never abort the scrub; the finding stays residual
                outcome, detail = "failed", repr(exc)
            _entry(finding, action, outcome, detail)
    if rebuild_snapshots:
        # drop every corrupt snapshot, then ONE re-compaction over the
        # (now restored) datasets rebuilds coverage
        from bodywork_tpu_torch.data.snapshot import write_snapshot

        for finding in rebuild_snapshots:
            if finding.key.startswith(SNAPSHOTS_PREFIX):
                quarantine(ctx.store, finding.key, finding.problem)
                try:
                    ctx.store.delete(finding.key)
                except ArtefactNotFound:
                    pass
        try:
            written = write_snapshot(ctx.store)
            outcome = "repaired" if written else "failed"
            detail = (
                f"re-compacted to {written}" if written
                else "nothing consolidatable"
            )
        except Exception as exc:  # noqa: BLE001
            outcome, detail = "failed", repr(exc)
        for finding in rebuild_snapshots:
            _entry(finding, "rebuild_snapshot", outcome, detail)
    return out
