from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.data.generator import alpha, generate_day
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
