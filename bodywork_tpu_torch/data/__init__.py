"""Data generation, dataset I/O and the history snapshot. ``generate_day``
and ``alpha`` (torch) and the snapshot functions load on first use, so the
dataset I/O of a process that never generates (the test stage's pod)
imports no torch."""
import importlib

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.data.io import (
    Dataset,
    load_all_datasets,
    load_dataset,
    load_latest_dataset,
    persist_dataset,
)

__all__ = [
    "DriftConfig",
    "Dataset",
    "alpha",
    "generate_day",
    "load_all_datasets",
    "load_dataset",
    "load_latest_dataset",
    "persist_dataset",
    "load_latest_snapshot",
    "plan_compaction",
    "refresh_due",
    "write_snapshot",
]

#: lazily loaded name -> its module
_LAZY = {
    "alpha": "generator",
    "generate_day": "generator",
    "load_latest_snapshot": "snapshot",
    "plan_compaction": "snapshot",
    "refresh_due": "snapshot",
    "write_snapshot": "snapshot",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
