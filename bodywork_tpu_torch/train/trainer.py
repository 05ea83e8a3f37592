"""Training orchestration over the artefact store (the port of
``bodywork_tpu.train.trainer``; reference ``stage_1_train_model.py:31-36``).

Flow, the reference's ``main()``: load all dataset history -> 80/20 split
(seed 42) -> fit the regressor on the device -> metrics on the held-out
split -> persist the date-keyed checkpoint and the metrics CSV, and
register the checkpoint as a model-registry candidate (with the
prediction-sanity band of its training labels), which the promotion
gate then adjudicates.

``mode="incremental"`` retrains from persisted sufficient statistics
(linear) or by a warm-started fine-tune (MLP), degrading to this full
refit where it cannot run (:mod:`bodywork_tpu_torch.train.incremental`).
Each fit exports the JAX package's ``bodywork_tpu_train_*`` metrics
(:func:`_record_train_metrics`), its seconds read after a fence on the
fitted parameters (kernels launch asynchronously: without the fence the
clock would stop at the last launch, not at the end of the fit).
Not ported yet (ROADMAP): the device mesh (``mesh_data`` /
``mesh_model``) raises; there is no compile prewarm, which is XLA
machinery.
"""
from __future__ import annotations

import dataclasses
from datetime import date
from time import perf_counter

import numpy as np

from bodywork_tpu_torch.data.io import csv_record, load_all_datasets
from bodywork_tpu_torch.device import fence, resolve_device
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

#: the training modes: ``full`` refits on all history, ``incremental``
#: folds in only the new days (``train/incremental.py``)
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
    #: how the model was produced: ``full`` or ``incremental``; an
    #: incremental request that fell back reports ``full`` and a reason
    mode: str = "full"
    #: dataset rows read to produce this result
    rows_touched: int | None = None
    #: why an incremental request ran as a full refit: trainstate_absent,
    #: _corrupt or _stale, no_donor, donor_incompatible, unsupported_model,
    #: or gate_rejected (the runner's same-day fallback); None otherwise
    fallback_reason: str | None = None
    #: the ``trainstate/`` document the persisted result wrote
    trainstate_artefact_key: str | None = None
    #: the trainstate document still to write (incremental linear), which
    #: ``persist_train_result`` CAS-writes after the candidate
    pending_trainstate: dict | None = dataclasses.field(default=None, repr=False)


def _prediction_bounds(y) -> dict:
    """Sanity bounds for served predictions: the observed label range
    widened by half a range on each side (``trainer.py:84-98``)."""
    arr = np.asarray(y, dtype=np.float64)
    lo, hi = float(np.min(arr)), float(np.max(arr))
    span = max(hi - lo, 1e-6)  # degenerate label sets still get a band
    margin = 0.5 * span
    return {"lo": lo - margin, "hi": hi + margin}


def _record_train_metrics(fitted, metrics: dict[str, float], fit_s: float, n_rows: int,
                          mode: str = "full", rows_touched: int | None = None) -> None:
    """Export one fit's telemetry through the shared obs registry, under
    the JAX package's names: runs, rows touched by mode (default: all of
    history, the full refit's footprint), fit seconds, the history's rows,
    the held-out MAPE and r², the final loss and the seconds a step.
    ``fit_s`` must be read after a fence on the fitted parameters."""
    from bodywork_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "bodywork_tpu_train_runs_total", "Completed training runs"
    ).inc()
    reg.counter(
        "bodywork_tpu_train_rows_touched_total",
        "Dataset rows read to produce each training run's model, by "
        "train mode (full = O(history) per run, incremental = O(tail))",
    ).inc(n_rows if rows_touched is None else rows_touched, mode=mode)
    reg.histogram(
        "bodywork_tpu_train_fit_seconds",
        "Fit + held-out eval wall-clock per training run",
    ).observe(fit_s)
    reg.gauge(
        "bodywork_tpu_train_rows", "Rows in the latest training history"
    ).set(n_rows)
    reg.gauge(
        "bodywork_tpu_train_mape_ratio", "Held-out MAPE of the latest fit"
    ).set(metrics["MAPE"])
    reg.gauge(
        "bodywork_tpu_train_r2_ratio", "Held-out r_squared of the latest fit"
    ).set(metrics["r_squared"])
    final_loss = getattr(fitted, "final_loss", None)
    if final_loss is not None:
        reg.gauge(
            "bodywork_tpu_train_final_loss",
            "Training loss at the last optimisation step",
        ).set(final_loss)
    n_steps = getattr(getattr(fitted, "config", None), "n_steps", None)
    if n_steps:
        # the timed window is the whole fit + eval, so this is an UPPER
        # bound on the time a step takes
        reg.gauge(
            "bodywork_tpu_train_step_seconds",
            "Fit+eval wall-clock / optimisation steps of the latest fit "
            "(upper bound on per-step time)",
        ).set(fit_s / n_steps)


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
    register the checkpoint as a registry candidate, CAS-write its pending
    trainstate document, and return the result with its keys filled in."""
    data = save_model_bytes(result.model)
    model_key_ = save_model(store, result.model, result.data_date, data=data)
    metrics_key = persist_metrics(store, result.metrics, result.data_date)
    _register_candidate(store, model_key_, metrics_key, result.data_date, data,
                        prediction_bounds=result.prediction_bounds)
    trainstate_key_ = result.trainstate_artefact_key
    if result.pending_trainstate is not None:
        from bodywork_tpu_torch.train.incremental import persist_trainstate

        trainstate_key_ = persist_trainstate(store, result.model.model_type,
                                             result.pending_trainstate)
    return dataclasses.replace(
        result, model_artefact_key=model_key_, metrics_artefact_key=metrics_key,
        trainstate_artefact_key=trainstate_key_, pending_trainstate=None,
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
    """Run the train stage against an artefact store, fitting on
    ``device`` (the card unless asked for the CPU). ``mode="incremental"``
    routes to :func:`~bodywork_tpu_torch.train.incremental.train_incremental`,
    which degrades to this full refit (with ``fallback_reason`` set) where
    it cannot run. ``persist=False`` leaves the artefact writes to the
    caller (:func:`persist_train_result`)."""
    if mode not in TRAIN_MODES:
        raise ValueError(f"unknown train mode {mode!r}; expected one of {TRAIN_MODES}")
    if (mesh_data or 0) > 1 or mesh_model > 1:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP Queue 1 item 19, "
            "the mesh on torch.distributed)"
        )
    if mode == "incremental":
        from bodywork_tpu_torch.train.incremental import train_incremental

        return train_incremental(store, model_type, model_kwargs=model_kwargs,
                                 test_size=test_size, split_seed=split_seed,
                                 fit_seed=fit_seed, persist=persist, device=device)
    dev = resolve_device(device)
    ds = load_all_datasets(store)
    split = train_test_split(ds.X, ds.y, test_size=test_size, seed=split_seed)
    model = make_model(model_type, **(model_kwargs or {}))
    fit_t0 = perf_counter()
    fitted, metrics = model.fit_and_evaluate(
        split.X_train, split.y_train, split.X_test, split.y_test,
        seed=fit_seed, device=dev,
    )
    fence(fitted.params)
    _record_train_metrics(fitted, metrics, perf_counter() - fit_t0, len(ds))
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
