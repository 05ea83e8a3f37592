from bodywork_tpu_torch.train.trainer import (
    TRAIN_MODES,
    TrainResult,
    make_model,
    persist_metrics,
    persist_train_result,
    train_on_history,
)

__all__ = [
    "TRAIN_MODES",
    "TrainResult",
    "make_model",
    "persist_metrics",
    "persist_train_result",
    "train_on_history",
]
