"""Consolidated-history snapshots: the cold-path data plane (the port of
``bodywork_tpu.data.snapshot``).

The per-day parse cache (``data.io``) helps only a process that lives
across days; every cold process (a per-day pod, ``cli train``) would
otherwise rebuild the training history with O(days) store reads and CSV
parses, the reference's re-download-everything pattern
(``stage_1_train_model.py:68-71``).

A snapshot is one binary artefact under ``snapshots/``
(``schema.snapshot_key``) holding the float32 ``X`` / ``y`` arrays of
every dataset day up to its embedded date, concatenated in history
order, and a JSON manifest of the covered day keys, their row counts and
their ``version_token``\\ s. A reader trusts a covered day only while its
recorded token equals the store's current one, so an overwritten or
deleted day degrades to a per-day fetch of that day, never to a wrong
training set: ``load_all_datasets`` is byte-identical with the snapshot
present, stale, corrupt or absent.

Format: ``numpy.savez`` with arrays ``X``, ``y`` and a 0-d unicode
``manifest``, the JAX package's, so each package reads the other's
snapshot (the filesystem tokens are the same ``(ino, size, mtime_ns)``
in both). Snapshots are derived: deleting the prefix is always safe.
The runner compacts on a background thread after each day; ``cli
compact`` does it on demand. Counters, the JAX package's:
``bodywork_tpu_snapshot_loads_total{outcome}`` (the history loader's
consultations: ``hit``, ``stale``, ``miss``, ``corrupt``; maintenance
reads, the compactor's and ``compact --dry-run``'s, are not counted),
``bodywork_tpu_snapshot_writes_total`` and the ``bodywork_tpu_snapshot_rows``
gauge.
"""
from __future__ import annotations

import dataclasses
import io
import json
import time

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, SNAPSHOTS_PREFIX, snapshot_key
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("data.snapshot")

SNAPSHOT_SCHEMA = "bodywork_tpu.history_snapshot/1"

#: snapshots kept per store, older ones pruned on each write: one valid
#: file suffices, the second is what a reader falls back to when the
#: newest is torn (or was pruned between its listing and its read)
SNAPSHOT_KEEP = 2


def canon_token(token) -> object:
    """A ``version_token`` in the form it round-trips through the JSON
    manifest (tuples become lists), so a recorded and a current token
    compare equal exactly when the backend would call them equal. A
    token JSON cannot hold compares by ``repr``: at worst a false
    mismatch (a per-day fetch), never a false match."""
    try:
        return json.loads(json.dumps(token))
    except (TypeError, ValueError):
        return repr(token)


@dataclasses.dataclass
class Snapshot:
    """A parsed snapshot: the concatenated arrays and the manifest's
    entries (``{"key", "rows", "token"}`` in history order)."""

    key: str
    X: np.ndarray
    y: np.ndarray
    entries: list[dict]

    def slices(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """Each covered day's ``(X, y)`` views into the arrays, by key."""
        out = {}
        offset = 0
        for entry in self.entries:
            rows = entry["rows"]
            out[entry["key"]] = (self.X[offset:offset + rows], self.y[offset:offset + rows])
            offset += rows
        return out


def record_load_outcome(outcome: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_snapshot_loads_total",
        "Snapshot consultations by the history loader, by outcome "
        "(hit: covered everything; stale: used, but some days needed "
        "per-day fetch; miss: no snapshot; corrupt: unreadable)",
    ).inc(outcome=outcome)


def load_latest_snapshot(store: ArtefactStore, hist: list | None = None,
                         record_outcome: bool = True) -> Snapshot | None:
    """The newest parseable snapshot, or None (none kept, or none
    readable: the caller falls back to per-day loads either way). One
    listing and one ``get_bytes``; a corrupt newest snapshot falls back to
    the older kept one at one more read, and flags ``repair_needed`` so
    the compactor rewrites it. ``hist``, a prior
    ``history(SNAPSHOTS_PREFIX)``, saves the listing;
    ``record_outcome=False`` keeps a maintenance read out of the
    load-outcome counter."""
    if hist is None:
        hist = store.history(SNAPSHOTS_PREFIX)
    if not hist:
        if record_outcome:
            record_load_outcome("miss")
        return None
    corrupt_seen = False
    found = None
    for key, _ in reversed(hist):
        try:
            raw = store.get_bytes(key)
            with np.load(io.BytesIO(raw), allow_pickle=False) as npz:
                manifest = json.loads(str(npz["manifest"][()]))
                X = npz["X"]
                y = npz["y"]
            if manifest.get("schema") != SNAPSHOT_SCHEMA:
                raise ValueError(f"unknown snapshot schema {manifest.get('schema')!r}")
            entries = manifest["covered"]
            n_rows = sum(e["rows"] for e in entries)
            if X.shape[0] != n_rows or y.shape[0] != n_rows:
                raise ValueError(f"manifest covers {n_rows} rows but arrays hold "
                                 f"{X.shape[0]}/{y.shape[0]}")
        except ArtefactNotFound:
            continue  # pruned between listing and read: try the older one
        except Exception as exc:  # noqa: BLE001 - a torn artefact degrades
            # to the older kept snapshot, then to the per-day path; it
            # never crashes training or yields a wrong dataset
            log.warning(f"snapshot {key} unreadable ({exc!r}); ignoring it")
            if record_outcome:
                record_load_outcome("corrupt")
            corrupt_seen = True
            continue
        found = Snapshot(key=key, X=X, y=y, entries=entries)
        break
    if corrupt_seen:
        store.mutable_cache("_snapshot_state")["repair_needed"] = True
    if found is None and not corrupt_seen and record_outcome:
        record_load_outcome("miss")  # every kept snapshot was pruned away
    return found


def write_snapshot(store: ArtefactStore, keep: int = SNAPSHOT_KEEP) -> str | None:
    """Consolidate every dataset day in the store into one snapshot and
    prune older ones past ``keep``; returns its key (None when nothing is
    consolidatable). Reads ride the parse cache and the latest snapshot,
    so a warm process parses nothing."""
    from bodywork_tpu_torch.data.io import load_history_parts

    t0 = time.perf_counter()
    hist = store.history(DATASETS_PREFIX)
    if not hist:
        return None
    tokens = store.version_tokens([k for k, _ in hist])
    # filter before fetching: readers trust only entries whose token still
    # matches, so a token-less day would be dead weight, and a backend
    # with no tokens must bail here, not after O(days) reads
    consolidatable = []
    for key, d in hist:
        if tokens.get(key) is None:
            log.warning(f"snapshot skips {key}: backend reports no version token")
        else:
            consolidatable.append((key, d))
    if not consolidatable:
        return None
    # a maintenance read: the compactor finding yesterday's snapshot stale
    # is the expected case, not a loader outcome to count
    parts = load_history_parts(store, consolidatable, tokens, record_outcome=False)
    covered = [{"key": key, "rows": len(parts[key]), "token": canon_token(tokens[key])}
               for key, _ in consolidatable]
    X = np.concatenate([parts[e["key"]].X for e in covered])
    y = np.concatenate([parts[e["key"]].y for e in covered])
    most_recent = consolidatable[-1][1]
    manifest = {
        "schema": SNAPSHOT_SCHEMA,
        "covered": covered,
        "n_rows": int(X.shape[0]),
        "most_recent": str(most_recent),
    }
    buf = io.BytesIO()
    np.savez(buf, X=X, y=y, manifest=np.array(json.dumps(manifest)))
    key = snapshot_key(most_recent)
    store.put_bytes(key, buf.getvalue())
    _prune_snapshots(store, keep)
    # the snapshot just written matches the current tokens by construction
    store.mutable_cache("_snapshot_state")["repair_needed"] = False
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "bodywork_tpu_snapshot_writes_total", "Snapshot compactions written"
    ).inc()
    reg.gauge(
        "bodywork_tpu_snapshot_rows",
        "Rows covered by the most recently written snapshot",
    ).set(X.shape[0])
    log.info(f"wrote snapshot {key}: {len(covered)} day(s), {X.shape[0]} rows "
             f"in {time.perf_counter() - t0:.3f}s")
    return key


def _prune_snapshots(store: ArtefactStore, keep: int) -> None:
    hist = store.history(SNAPSHOTS_PREFIX)
    for key, _ in hist[:-keep] if keep > 0 else hist:
        try:
            store.delete(key)
        except ArtefactNotFound:
            pass  # a concurrent compactor got there first


def refresh_due(store: ArtefactStore) -> bool:
    """True when the latest snapshot no longer covers the latest dataset
    day (or none exists), or when a reader flagged ``repair_needed`` (a
    torn snapshot, or a covered day overwritten with the same date, which
    the date comparison cannot see). A listing-only check: the runner's
    compactor polls it after each day."""
    try:
        _, latest_day = store.latest(DATASETS_PREFIX)
    except ArtefactNotFound:
        return False
    if store.mutable_cache("_snapshot_state").get("repair_needed"):
        return True
    snaps = store.history(SNAPSHOTS_PREFIX)
    return not snaps or snaps[-1][1] < latest_day


def plan_compaction(store: ArtefactStore) -> dict:
    """What :func:`write_snapshot` would consolidate, without writing:
    ``cli compact --dry-run``'s payload. Parses the uncovered days
    (through the caches) to count rows; the byte estimate is the
    uncompressed payload, 4 bytes per float32 cell."""
    hist = store.history(DATASETS_PREFIX)
    snaps = store.history(SNAPSHOTS_PREFIX)
    plan: dict = {
        "days": len(hist),
        "latest_snapshot": snaps[-1][0] if snaps else None,
        "snapshots_kept": len(snaps),
    }
    if not hist:
        plan.update(rows=0, estimated_bytes=0, covered_days=[], days_without_tokens=0,
                    would_write=None)
        return plan
    tokens = store.version_tokens([k for k, _ in hist])
    # write_snapshot's own filter: the plan must not promise token-less days
    consolidatable = [(k, d) for k, d in hist if tokens.get(k) is not None]
    plan["days_without_tokens"] = len(hist) - len(consolidatable)
    if not consolidatable:
        plan.update(rows=0, estimated_bytes=0, covered_days=[], would_write=None)
        return plan
    from bodywork_tpu_torch.data.io import load_history_parts

    parts = load_history_parts(store, consolidatable, tokens, record_outcome=False)
    rows = sum(len(parts[k]) for k, _ in consolidatable)
    n_features = next(iter(parts.values())).X.shape[1]
    plan.update(
        rows=rows,
        estimated_bytes=rows * 4 * (n_features + 1),
        covered_days=[str(d) for _, d in consolidatable],
        would_write=snapshot_key(consolidatable[-1][1]),
    )
    return plan
