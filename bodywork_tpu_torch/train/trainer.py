"""Training orchestration over the artefact store (the port of
``bodywork_tpu.train.trainer``; reference ``stage_1_train_model.py:31-36``).

Flow, the reference's ``main()``: load all dataset history -> 80/20 split
(seed 42) -> fit the regressor on the device -> metrics on the held-out
split -> persist the date-keyed checkpoint and the metrics CSV, and
register the checkpoint as a model-registry candidate (with the
prediction-sanity band of its training labels), which the promotion
gate then adjudicates.

Not ported yet (ROADMAP): the incremental mode (``mode="incremental"``)
and the device mesh (``mesh_data`` / ``mesh_model``) raise; there is no
compile prewarm, which is XLA machinery.
"""
from __future__ import annotations

import dataclasses
from datetime import date

import numpy as np

from bodywork_tpu_torch.data.io import csv_record, load_all_datasets
from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.models import (
    LinearConfig,
    LinearRegressor,
    MLPConfig,
    MLPRegressor,
    Regressor,
    save_model,
    train_test_split,
)
from bodywork_tpu_torch.models.checkpoint import save_model_bytes
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import model_metrics_key
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("train")

#: the JAX package's training modes; only ``full`` is ported
TRAIN_MODES = ("full", "incremental")

#: the model-metrics record's columns (``stage_1:84-89``)
METRIC_COLUMNS = ("date", "MAPE", "r_squared", "max_residual")


@dataclasses.dataclass
class TrainResult:
    model: Regressor
    metrics: dict[str, float]
    data_date: date
    #: None until the artefacts are persisted (``persist_train_result``)
    model_artefact_key: str | None
    metrics_artefact_key: str | None
    n_rows: int
    #: serving-side sanity band from the training labels (``{"lo", "hi"}``)
    prediction_bounds: dict | None = None
    #: how the model was produced: always a ``full`` refit here
    mode: str = "full"
    #: dataset rows read to produce this result
    rows_touched: int | None = None


def _prediction_bounds(y) -> dict:
    """Sanity bounds for served predictions: the observed label range
    widened by half a range on each side (``trainer.py:84-98``)."""
    arr = np.asarray(y, dtype=np.float64)
    lo, hi = float(np.min(arr)), float(np.max(arr))
    span = max(hi - lo, 1e-6)  # degenerate label sets still get a band
    margin = 0.5 * span
    return {"lo": lo - margin, "hi": hi + margin}


def make_model(model_type: str, **kwargs) -> Regressor:
    """Build a model from a registry name plus either a ``config=`` object
    or flat config fields (``make_model("mlp", n_steps=300)``), the form
    a pipeline spec's stage args can express."""
    if model_type == "linear":
        cls, cfg_cls = LinearRegressor, LinearConfig
    elif model_type == "mlp":
        cls, cfg_cls = MLPRegressor, MLPConfig
    else:
        raise ValueError(f"unknown model type: {model_type!r}")
    if "config" in kwargs:
        return cls(**kwargs)
    if kwargs:
        if cfg_cls is MLPConfig and "hidden" in kwargs:
            kwargs["hidden"] = tuple(kwargs["hidden"])
        return cls(cfg_cls(**kwargs))
    return cls()


def persist_metrics(store: ArtefactStore, metrics: dict[str, float], data_date: date) -> str:
    """Write a one-row metrics CSV with the reference's exact column schema
    ``date,MAPE,r_squared,max_residual`` (``stage_1:84-89,128-142``)."""
    key = model_metrics_key(data_date)
    store.put_text(key, csv_record(METRIC_COLUMNS, {"date": data_date, **metrics}))
    log.info(f"persisted train metrics to {key}")
    return key


def _register_candidate(store: ArtefactStore, model_key_: str, metrics_key: str,
                        data_date: date, model_bytes: bytes,
                        prediction_bounds: dict | None = None) -> None:
    """Register the persisted checkpoint as a registry candidate: it takes
    traffic only once the promotion gate moves the ``production`` alias.
    ``model_bytes`` is the buffer just written, so the lineage digest
    costs no re-read. A failure is logged and not fatal: the artefacts
    are durable, and a registry-less store still serves the latest
    checkpoint."""
    try:
        from bodywork_tpu_torch.registry.records import register_candidate

        register_candidate(store, model_key_, metrics_key=metrics_key, day=data_date,
                           model_bytes=model_bytes, prediction_bounds=prediction_bounds)
    except Exception as exc:  # noqa: BLE001 - non-fatal by design
        log.warning(f"candidate registration failed (non-fatal): {exc!r}")


def persist_train_result(store: ArtefactStore, result: TrainResult) -> TrainResult:
    """Write a computed-but-unpersisted result's checkpoint and metrics,
    register the checkpoint as a registry candidate, and return the
    result with its keys filled in."""
    data = save_model_bytes(result.model)
    model_key_ = save_model(store, result.model, result.data_date, data=data)
    metrics_key = persist_metrics(store, result.metrics, result.data_date)
    _register_candidate(store, model_key_, metrics_key, result.data_date, data,
                        prediction_bounds=result.prediction_bounds)
    return dataclasses.replace(
        result, model_artefact_key=model_key_, metrics_artefact_key=metrics_key,
    )


def train_on_history(
    store: ArtefactStore,
    model_type: str = "linear",
    test_size: float = 0.2,
    split_seed: int = 42,
    fit_seed: int | None = None,
    model_kwargs: dict | None = None,
    persist: bool = True,
    mesh_data: int | None = None,
    mesh_model: int = 1,
    mode: str = "full",
    device=None,
) -> TrainResult:
    """Run the full train stage against an artefact store, fitting on
    ``device`` (the card unless asked for the CPU). ``persist=False``
    leaves the artefact writes to the caller (:func:`persist_train_result`)."""
    if mode not in TRAIN_MODES:
        raise ValueError(f"unknown train mode {mode!r}; expected one of {TRAIN_MODES}")
    if mode == "incremental":
        raise NotImplementedError(
            "incremental training is not ported yet (ROADMAP Queue 1 item 3, "
            "train/incremental.py); use mode='full'"
        )
    if (mesh_data or 0) > 1 or mesh_model > 1:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP Queue 1 item 19, "
            "the mesh on torch.distributed)"
        )
    dev = resolve_device(device)
    ds = load_all_datasets(store)
    split = train_test_split(ds.X, ds.y, test_size=test_size, seed=split_seed)
    model = make_model(model_type, **(model_kwargs or {}))
    fitted, metrics = model.fit_and_evaluate(
        split.X_train, split.y_train, split.X_test, split.y_test,
        seed=fit_seed, device=dev,
    )
    log.info(
        f"trained {fitted.info} on {len(ds)} rows to {ds.date} on {dev}: "
        f"MAPE={metrics['MAPE']:.4f} r2={metrics['r_squared']:.4f} "
        f"max_resid={metrics['max_residual']:.2f}"
    )
    result = TrainResult(
        fitted, metrics, ds.date, None, None, len(ds),
        prediction_bounds=_prediction_bounds(ds.y), rows_touched=len(ds),
    )
    return persist_train_result(store, result) if persist else result
