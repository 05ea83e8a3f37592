"""Data generation and dataset I/O. ``generate_day`` and ``alpha`` (torch)
load on first use, so the dataset I/O of a process that never generates
(the test stage's pod) imports no torch."""
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
]


def __getattr__(name: str):
    if name in ("alpha", "generate_day"):
        from bodywork_tpu_torch.data import generator

        return getattr(generator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
