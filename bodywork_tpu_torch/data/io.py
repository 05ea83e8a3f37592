"""Dataset I/O against the artefact store, with the csv module and numpy
(the port of ``bodywork_tpu.data.io``; no pandas on the card's machine).

The schema is the reference's (``stage_3:46-61``): a CSV with header
``date,y,X`` — extra feature columns as ``X2, X3, ...`` — under
``datasets/regression-dataset-<date>.csv``. Values are written as the
shortest decimal that reads back to the same float32 (what pandas writes
for a float32 column), so a day round-trips bit-exact through either
package. :func:`load_all_datasets` reads the whole history for the train
stage: plain (list, parse, concatenate), without the JAX package's
snapshot and parse caches (ROADMAP).
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
        X = np.array([[float(r[i]) for i in x_idx] for r in rows], dtype=np.float64)
        y = np.array([float(r[y_idx]) for r in rows], dtype=np.float64)
        return cls(X.reshape(len(rows), len(x_cols)), y, data_date)


def persist_dataset(store: ArtefactStore, ds: Dataset) -> str:
    """Write a day's dataset as CSV under ``datasets/`` (``stage_3:46-61``)."""
    if ds.date is None:
        raise ValueError("dataset must carry its simulated date")
    key = dataset_key(ds.date)
    store.put_text(key, ds.to_csv())
    log.info(f"persisted {len(ds)} rows to {key}")
    return key


def load_dataset(store: ArtefactStore, key: str) -> Dataset:
    return Dataset.from_csv(store.get_text(key), date_from_key(key))


def load_latest_dataset(store: ArtefactStore) -> Dataset:
    """Latest day's dataset (``stage_4:39-63``)."""
    key, _ = store.latest(DATASETS_PREFIX)
    return load_dataset(store, key)


def load_all_datasets(store: ArtefactStore) -> Dataset:
    """All available history, oldest first, concatenated, dated by the
    most recent day (``stage_1:39-76``): the same ``Dataset`` as the JAX
    package's ``load_all_datasets`` on the same store."""
    hist = store.history(DATASETS_PREFIX)
    if not hist:
        raise ArtefactNotFound(f"no datasets under '{DATASETS_PREFIX}'")
    parts = [load_dataset(store, key) for key, _ in hist]
    X = np.concatenate([p.X for p in parts])
    y = np.concatenate([p.y for p in parts])
    most_recent = hist[-1][1]
    log.info(f"loaded {len(parts)} day(s), {len(y)} rows, most recent {most_recent}")
    return Dataset(X, y, most_recent)
