"""Dataset I/O against the artefact store, with the csv module and numpy
(the port of ``bodywork_tpu.data.io``; no pandas on the card's machine).

The schema is the reference's (``stage_3:46-61``): a CSV with header
``date,y,X`` — extra feature columns as ``X2, X3, ...`` — under
``datasets/regression-dataset-<date>.csv``. Values are written as the
shortest decimal that reads back to the same float32 (what pandas writes
for a float32 column), so a day round-trips bit-exact through either
package. :func:`load_all_datasets` reads the whole history for the train
stage through :func:`load_history_parts`'s three tiers (the per-day parse
cache, the consolidated snapshot of ``data.snapshot``, a batched fetch)
and a one-entry concatenation cache, as the JAX package's does.
"""
from __future__ import annotations

import csv
import io
import math
from datetime import date

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, dataset_key
from bodywork_tpu_torch.utils.dates import date_from_key
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("data.io")


def csv_value(v) -> str:
    """One field of a metrics record as pandas' ``to_csv`` writes it: NaN
    as an empty field, floats as their shortest round-trip repr."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def csv_record(columns, record: dict) -> str:
    """A one-row CSV (header + row) of ``record``'s ``columns``, in the
    spelling pandas' ``to_csv(index=False)`` gives the JAX package."""
    return ",".join(columns) + "\n" + ",".join(csv_value(record[c]) for c in columns) + "\n"


class Dataset:
    """A (X, y) regression dataset with its artefact date."""

    def __init__(self, X: np.ndarray, y: np.ndarray, data_date: date | None = None):
        self.X = np.asarray(X, dtype=np.float32)
        self.y = np.asarray(y, dtype=np.float32)
        if self.X.ndim == 1:
            self.X = self.X[:, None]
        self.date = data_date

    def __len__(self) -> int:
        return self.X.shape[0]

    def to_csv(self) -> str:
        d = str(self.date) if self.date else ""
        header = ["date", "y", "X"] + [f"X{i + 1}" for i in range(1, self.X.shape[1])]
        buf = io.StringIO()
        buf.write(",".join(header) + "\n")
        for yv, row in zip(self.y, self.X):
            # str(np.float32) is the shortest float32 round-trip decimal
            buf.write(",".join([d, str(yv), *(str(v) for v in row)]) + "\n")
        return buf.getvalue()

    @classmethod
    def from_csv(cls, text: str, data_date: date | None = None) -> "Dataset":
        reader = csv.reader(io.StringIO(text))
        header = next(reader)
        x_cols = ["X"] + sorted(
            (c for c in header if c.startswith("X") and c[1:].isdigit()),
            key=lambda c: int(c[1:]),
        )
        x_idx = [header.index(c) for c in x_cols]
        y_idx = header.index("y")
        rows = [r for r in reader if r]
        try:
            X = np.array([[float(r[i]) for i in x_idx] for r in rows], dtype=np.float64)
            y = np.array([float(r[y_idx]) for r in rows], dtype=np.float64)
        except (IndexError, ValueError):
            # pandas' read_csv reads a missing or empty field as NaN (a
            # NaN-sabotaged day, ``tenancy.fleet.sabotage_dataset_nan``,
            # writes rows shorter than the header); other text still raises
            def field(r, i):
                return float(r[i]) if i < len(r) and r[i] != "" else float("nan")

            X = np.array([[field(r, i) for i in x_idx] for r in rows], dtype=np.float64)
            y = np.array([field(r, y_idx) for r in rows], dtype=np.float64)
        return cls(X.reshape(len(rows), len(x_cols)), y, data_date)


def persist_dataset(store: ArtefactStore, ds: Dataset) -> str:
    """Write a day's dataset as CSV under ``datasets/`` (``stage_3:46-61``)."""
    if ds.date is None:
        raise ValueError("dataset must carry its simulated date")
    key = dataset_key(ds.date)
    store.put_text(key, ds.to_csv())
    log.info(f"persisted {len(ds)} rows to {key}")
    return key


def _parse_dataset_csv(data: bytes, key: str) -> Dataset:
    return Dataset.from_csv(data.decode("utf-8"), date_from_key(key))


def load_dataset(store: ArtefactStore, key: str) -> Dataset:
    return _parse_dataset_csv(store.get_bytes(key), key)


def load_latest_dataset(store: ArtefactStore) -> Dataset:
    """Latest day's dataset (``stage_4:39-63``)."""
    key, _ = store.latest(DATASETS_PREFIX)
    return load_dataset(store, key)


def load_history_parts(store: ArtefactStore, hist: list, tokens: dict,
                       record_outcome: bool = True) -> dict[str, Dataset]:
    """The parsed dataset of every ``hist`` entry, through three tiers,
    cheapest first:

    1. the per-day parse cache on the store, keyed by ``version_token``;
    2. the latest valid consolidated snapshot (``data.snapshot``): a
       covered day is trusted only while its recorded token equals the
       store's current one, so an overwritten day degrades to tier 3
       alone;
    3. one ``store.get_many`` of the rest, parsed.

    Snapshot slices fill the parse cache, so a cold process's first load
    warms the cache a long-lived one builds day by day.
    ``record_outcome=False`` keeps a maintenance read (the compactor's)
    out of ``bodywork_tpu_snapshot_loads_total``."""
    from bodywork_tpu_torch.data import snapshot as snapshot_mod
    from bodywork_tpu_torch.store.schema import SNAPSHOTS_PREFIX

    cache: dict = store.mutable_cache("_parsed_dataset_cache")
    dates = dict(hist)
    parts: dict[str, Dataset] = {}
    missing: list[str] = []
    for key, _ in hist:
        token = tokens.get(key)
        hit = cache.get(key) if token is not None else None
        if hit is not None and hit[0] == token:
            parts[key] = hit[1]
        else:
            missing.append(key)
    n_from_snapshot = 0
    if missing:
        snaps = store.history(SNAPSHOTS_PREFIX)
        snap = None
        if not snaps:
            if record_outcome:
                snapshot_mod.record_load_outcome("miss")
        # the listing's embedded date bounds what the snapshot covers:
        # read its payload only when a missing day could be in it, or the
        # warm daily loop (whose one missing day is the newly generated
        # one) would re-read the ever-growing snapshot every day
        elif any(dates[key] <= snaps[-1][1] for key in missing):
            snap = snapshot_mod.load_latest_snapshot(store, hist=snaps,
                                                     record_outcome=record_outcome)
        if snap is not None:
            hist_keys = set(dates)
            slices = snap.slices()
            usable = {}
            for entry in snap.entries:
                key = entry["key"]
                token = tokens.get(key)
                if key in hist_keys and token is not None:
                    if snapshot_mod.canon_token(token) == entry["token"]:
                        usable[key] = token
                    else:
                        # a covered day was overwritten since the snapshot
                        # (same date, new token), which refresh_due's date
                        # check cannot see: flag it for the compactor
                        store.mutable_cache("_snapshot_state")["repair_needed"] = True
            still_missing = []
            for key in missing:
                token = usable.get(key)
                if token is None:
                    still_missing.append(key)
                    continue
                Xs, ys = slices[key]
                ds = Dataset(Xs, ys, dates[key])
                cache[key] = (token, ds)
                parts[key] = ds
                n_from_snapshot += 1
            if record_outcome:
                snapshot_mod.record_load_outcome("hit" if not still_missing else "stale")
            missing = still_missing
    if missing:
        blobs = store.get_many(missing)
        for key in missing:
            ds = _parse_dataset_csv(blobs[key], key)
            token = tokens.get(key)
            if token is not None:
                cache[key] = (token, ds)
            parts[key] = ds
    log.info(
        f"history parts: {len(hist)} day(s) — "
        f"{len(hist) - n_from_snapshot - len(missing)} cached, "
        f"{n_from_snapshot} from snapshot, {len(missing)} fetched+parsed"
    )
    return parts


def load_all_datasets(store: ArtefactStore) -> Dataset:
    """All available history, oldest first, concatenated, dated by the
    most recent day (``stage_1:39-76``): the same ``Dataset`` as the JAX
    package's ``load_all_datasets`` on the same store, whether the
    snapshot is present, stale, corrupt or absent. A cold process reads
    the latest snapshot and the tail days after it; a warm one re-parses
    only days whose ``version_token`` changed; a reload whose exact
    ``(key, token)`` list is unchanged skips the concatenation too."""
    hist = store.history(DATASETS_PREFIX)
    if not hist:
        raise ArtefactNotFound(f"no datasets under '{DATASETS_PREFIX}'")
    keys = [key for key, _ in hist]
    tokens = store.version_tokens(keys)
    most_recent = hist[-1][1]
    concat_cache: dict = store.mutable_cache("_concat_history_cache")
    concat_key = None
    if len(tokens) == len(keys):  # every key verifiable
        concat_key = tuple((k, repr(tokens[k])) for k in keys)
        cached = concat_cache.get(concat_key)
        if cached is not None:
            X, y = cached
            log.info(f"loaded {len(keys)} day(s) (concatenation cache hit), "
                     f"{len(y)} rows, most recent {most_recent}")
            return Dataset(X, y, most_recent)
    parts = load_history_parts(store, hist, tokens)
    X = np.concatenate([parts[k].X for k in keys])
    y = np.concatenate([parts[k].y for k in keys])
    if concat_key is not None:
        # one entry: histories only grow, so yesterday's concatenation can
        # never hit again, and keeping it would double the peak memory
        concat_cache.clear()
        concat_cache[concat_key] = (X, y)
    log.info(f"loaded {len(parts)} day(s), {len(y)} rows, most recent {most_recent}")
    return Dataset(X, y, most_recent)
