"""The four canonical stage callables (the port of
``bodywork_tpu.pipeline.stages``; reference C2-C5 entry points).

Each stage is a function ``stage(ctx, **args)`` over a shared
:class:`StageContext`. Batch stages return when done; the service stage
returns a started handle the runner owns for the rest of the day.

- ``train_stage``    <- ``stage_1_train_model.main``
- ``serve_stage``    <- ``stage_2_serve_model`` ``__main__``
- ``generate_stage`` <- ``stage_3_synthetic_data_generation.main``
- ``test_stage``     <- ``stage_4_test_model_scoring_service.main``

The device stages compute on ``ctx.device``, the runner's device (the
card unless the runner was asked for the CPU); a single stage run by
``cli run-stage`` carries the device it was asked for, and only the
stages that use one resolve it. The test stage uses none, and its whole
path (this module, ``monitor.tester``, ``data.io``) imports no torch, so
its pod needs no accelerator runtime.
"""
from __future__ import annotations

import dataclasses
from datetime import date, timedelta

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline.stages")


@dataclasses.dataclass
class StageContext:
    """Everything a stage needs from the runner."""

    store: ArtefactStore
    #: the simulated "today" (the reference uses ``date.today()``;
    #: parameterising it lets a simulation run faster than real time)
    today: date
    #: where the device stages compute: a ``torch.device``, or for a single
    #: stage of ``cli run-stage`` the device asked for ("cuda", "cpu"),
    #: which :func:`_device` resolves only in a stage that uses one
    device: object
    drift: DriftConfig = dataclasses.field(default_factory=DriftConfig)
    #: service handles started earlier in the DAG, keyed by stage name
    services: dict = dataclasses.field(default_factory=dict)
    #: URL of the scoring service to test over HTTP; None tests the
    #: running service stage's app in-process
    scoring_url: str | None = None
    #: completed stages' return values this day, keyed by stage name
    stage_results: dict = dataclasses.field(default_factory=dict)
    #: failures of stages run on concurrent-step threads, keyed by stage
    #: name (the step barrier re-raises the first one)
    failures: dict = dataclasses.field(default_factory=dict)
    #: dataset prefetch boxes of the runner: target date -> {"ready":
    #: Event, "X", "y"}, filled on a background worker (the generator is a
    #: pure function of the date and the drift config); the generate stage
    #: waits on ``ready`` and only persists
    prefetched_datasets: dict = dataclasses.field(default_factory=dict)
    #: the lookahead train of this day, started by the previous day once
    #: its generate stage persisted this day's data: {"thread": Thread,
    #: "result": TrainResult} or {"thread", "exc"}
    prefetched_train: dict | None = None
    #: True in a lookahead context: compute but write no artefact (the
    #: collecting day's train stage persists them at its DAG position)
    defer_artefacts: bool = False


def _device(ctx: StageContext):
    """The context's device, resolved (a CUDA request without a card
    raises here, in the stage that needs the device)."""
    from bodywork_tpu_torch.device import resolve_device

    return resolve_device(ctx.device)


def stage_artefact_keys(stage_spec, result, ctx: StageContext) -> list[str]:
    """The artefact keys a just-completed stage produced: what the run
    journal records, with their digests, so a resumed run can verify and
    skip the stage. Unknown stages give ``[]``, which the journal records
    as complete with nothing verifiable: a resumed run re-runs them."""
    executable = stage_spec.executable
    if executable.endswith(":generate_stage"):
        return [result] if isinstance(result, str) else []
    if executable.endswith(":train_stage"):
        keys = [
            getattr(result, "model_artefact_key", None),
            getattr(result, "metrics_artefact_key", None),
            # an incremental train's trainstate document is journalled
            # too: a mismatch on resume re-runs the stage, which rebuilds
            # or re-folds it
            getattr(result, "trainstate_artefact_key", None),
        ]
        return [k for k in keys if k]
    if executable.endswith(":test_stage"):
        # the test stage's metrics are keyed by the latest dataset day,
        # the one generate just wrote
        from bodywork_tpu_torch.store.base import ArtefactNotFound
        from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, test_metrics_key

        try:
            _key, d = ctx.store.latest(DATASETS_PREFIX)
        except ArtefactNotFound:
            return []
        return [test_metrics_key(d)]
    return []


def generate_stage(ctx: StageContext, offset_days: int = 1) -> str:
    """Generate the NEXT simulated day's drifting data (reference stage 3:
    tomorrow's dataset appears today); returns its key. Where the runner
    prefetched the date's draws, only the persist is left (at this
    stage's DAG position either way, so the train stage never sees
    tomorrow's file early); a failed prefetch generates inline."""
    from bodywork_tpu_torch.data.generator import generate_day
    from bodywork_tpu_torch.data.io import Dataset, persist_dataset

    target = ctx.today + timedelta(days=offset_days)
    box = ctx.prefetched_datasets.pop(target, None)
    if box is not None:
        box["ready"].wait()
    if box is not None and "X" in box:
        X, y = box["X"], box["y"]
    else:
        X, y = generate_day(target, ctx.drift, device=_device(ctx))
    return persist_dataset(ctx.store, Dataset(X, y, target))


def _env_choice(name: str, choices: tuple, default: str) -> str:
    """A deployed enum knob from the environment: a value outside
    ``choices`` is ignored with a warning (a typo must not crash the
    pod) and the default applies."""
    import os

    raw = os.environ.get(name, "").strip()
    if raw and raw not in choices:
        log.warning(f"ignoring {name}={raw!r} (expected one of {choices})")
        raw = ""
    return raw or default


def _train_env_mode() -> str:
    """The deployed train mode (``BODYWORK_TPU_TRAIN_MODE``): ``full`` or
    ``incremental``, ``full`` when unset or malformed."""
    from bodywork_tpu_torch.train.trainer import TRAIN_MODES

    return _env_choice("BODYWORK_TPU_TRAIN_MODE", TRAIN_MODES, "full")


def _serve_env_dtype() -> str:
    """The deployed serving precision (``BODYWORK_TPU_SERVE_DTYPE``), one
    of ``SERVE_DTYPES``; ``float32`` when unset or malformed."""
    from bodywork_tpu_torch.serve.predictor import SERVE_DTYPES

    return _env_choice("BODYWORK_TPU_SERVE_DTYPE", SERVE_DTYPES, "float32")


def _serve_env_knobs() -> tuple[str, int | None, float | None, str, int | None, int]:
    """The deployed serving knobs ``(server_engine, max_pending,
    retry_after_max_s, dtype, mesh_data, mesh_model)`` from the pod
    environment (``BODYWORK_TPU_SERVER_ENGINE``, ``BODYWORK_TPU_MAX_PENDING``,
    ``BODYWORK_TPU_RETRY_AFTER_MAX_S``, ``BODYWORK_TPU_SERVE_DTYPE``,
    ``BODYWORK_TPU_MESH_DATA``, ``BODYWORK_TPU_MESH_MODEL``): the JAX
    stage's. A malformed value is ignored with a warning and the default
    applies (no mesh axis: None and 1), never a crashed pod."""
    from bodywork_tpu_torch.serve.server import SERVER_ENGINES
    from bodywork_tpu_torch.utils.env import number_env

    return (
        _env_choice("BODYWORK_TPU_SERVER_ENGINE", SERVER_ENGINES, "thread"),
        number_env("BODYWORK_TPU_MAX_PENDING", int, 1),
        number_env("BODYWORK_TPU_RETRY_AFTER_MAX_S", float, 1.0),
        _serve_env_dtype(),
        number_env("BODYWORK_TPU_MESH_DATA", int, 1),
        number_env("BODYWORK_TPU_MESH_MODEL", int, 1) or 1,
    )


def _serve_tuned_env_knobs() -> tuple[float | None, int | None, tuple[int, ...] | None]:
    """The deployed coalescer and bucket knobs ``(batch_window_ms,
    batch_max_rows, buckets)`` (``BODYWORK_TPU_BATCH_WINDOW_MS``, ``0``
    meaning coalescing off; ``BODYWORK_TPU_BATCH_MAX_ROWS``;
    ``BODYWORK_TPU_BUCKETS``, comma-separated positive ints), with the
    same malformed-is-ignored rule. The JAX stage returns the tuned-config
    reference as a fourth value; here :func:`_serve_tuned_config_ref`
    reads it."""
    import os

    from bodywork_tpu_torch.utils.env import bucket_list, number_env

    buckets: tuple[int, ...] | None = None
    raw = os.environ.get("BODYWORK_TPU_BUCKETS", "").strip()
    if raw:
        try:
            buckets = bucket_list(raw)
        except ValueError as exc:
            log.warning(f"ignoring BODYWORK_TPU_BUCKETS: {exc}")
    return (number_env("BODYWORK_TPU_BATCH_WINDOW_MS", float, 0.0),
            number_env("BODYWORK_TPU_BATCH_MAX_ROWS", int, 1), buckets)


def _serve_tuned_config_ref() -> str | None:
    """The deployed tuned-config reference (``BODYWORK_TPU_TUNED_CONFIG``:
    a ``tuning/`` key or ``latest``; unset or blank is None), the JAX
    stage's fourth tuned env knob."""
    import os

    from bodywork_tpu_torch.tune.config import TUNED_CONFIG_ENV

    return os.environ.get(TUNED_CONFIG_ENV, "").strip() or None


def _serve_fleet_env_knobs() -> int | None:
    """The deployed process-fleet topology knob (``BODYWORK_TPU_FRONTENDS``:
    N parse/admission front ends feeding one device-owning dispatcher)
    from the pod environment, the JAX stage's. ``cli serve`` builds the
    fleet from it; the IN-PROCESS serve stage cannot (one process by
    construction), so it surfaces and warns. A malformed value is a
    warning, never a crash-looping pod."""
    import os

    raw = os.environ.get("BODYWORK_TPU_FRONTENDS", "").strip()
    if not raw:
        return None
    try:
        frontends = int(raw)
        if frontends < 1:
            raise ValueError(raw)
    except ValueError:
        log.warning(f"ignoring BODYWORK_TPU_FRONTENDS={raw!r} (need an int >= 1)")
        return None
    return frontends


def _serve_transport_env_knobs() -> tuple[str, str | None, str, bool]:
    """The deployed cross-host-split knobs ``(transport, dispatcher_addr,
    role, standby)`` (``BODYWORK_TPU_SERVE_TRANSPORT``,
    ``BODYWORK_TPU_DISPATCHER_ADDR``, ``BODYWORK_TPU_SERVE_ROLE``,
    ``BODYWORK_TPU_SERVE_STANDBY``) from the pod environment, the JAX
    stage's, consumed like :func:`_serve_fleet_env_knobs`. The choice sets
    are pinned == ``serve.netqueue.SERVE_TRANSPORTS`` / ``SERVE_ROLES`` ==
    the ``cli serve`` choices by tests/test_torch_netqueue.py; a malformed
    value is a warning and the default."""
    import os

    # hardcoded to keep this import-light, as the cli parser's are
    transports = ("shm", "tcp", "unix")
    roles = ("auto", "frontend", "dispatcher")
    transport = os.environ.get("BODYWORK_TPU_SERVE_TRANSPORT", "").strip()
    if transport and transport not in transports:
        log.warning(f"ignoring BODYWORK_TPU_SERVE_TRANSPORT={transport!r} "
                    f"(expected one of {transports})")
        transport = ""
    role = os.environ.get("BODYWORK_TPU_SERVE_ROLE", "").strip()
    if role and role not in roles:
        log.warning(f"ignoring BODYWORK_TPU_SERVE_ROLE={role!r} "
                    f"(expected one of {roles})")
        role = ""
    addr = os.environ.get("BODYWORK_TPU_DISPATCHER_ADDR", "").strip() or None
    raw_standby = os.environ.get("BODYWORK_TPU_SERVE_STANDBY", "").strip().lower()
    standby = raw_standby in ("1", "true", "yes", "on")
    if raw_standby and not standby and raw_standby not in ("0", "false", "no", "off"):
        log.warning(f"ignoring BODYWORK_TPU_SERVE_STANDBY={raw_standby!r} "
                    "(expected a boolean like 1/0/true/false)")
    return transport or "shm", addr, role or "auto", standby


def train_stage(ctx: StageContext, model_type: str = "linear", mode: str | None = None,
                mesh_data: int | None = None, mesh_model: int = 1, **model_kwargs):
    """Train on the data to date and persist the checkpoint and its
    metrics (reference stage 1); returns the ``TrainResult``. ``mode``
    picks the full refit or the incremental path (None: the
    ``BODYWORK_TPU_TRAIN_MODE`` knob). The flat ``model_kwargs`` are the
    model's config fields.

    Where the runner already ran this day's train as a lookahead (the
    day's training set is complete once the previous day's generate
    stage persisted it), the stage collects that result and persists it
    here; a failed lookahead trains inline."""
    box = ctx.prefetched_train
    if box is not None:
        box["thread"].join()
        if "result" in box:
            result = box["result"]
            if result.model_artefact_key is None:
                from bodywork_tpu_torch.train.trainer import persist_train_result

                result = persist_train_result(ctx.store, result)
            return result
        log.warning(f"lookahead train failed ({box.get('exc')!r}); retraining inline")
    from bodywork_tpu_torch.train import train_on_history

    return train_on_history(
        ctx.store, model_type, model_kwargs=model_kwargs or None,
        persist=not ctx.defer_artefacts, mesh_data=mesh_data, mesh_model=mesh_model,
        mode=mode if mode is not None else _train_env_mode(), device=_device(ctx),
    )


def serve_stage(ctx: StageContext, host: str = "127.0.0.1", port: int = 0,
                buckets: tuple[int, ...] | None = None, replicas: int = 1,
                engine: str = "auto", tuned_config: str | None = None,
                mesh_data: int | None = None, mesh_model: int | None = None):
    """Load the checkpoint to serve (the registry's ``production`` alias
    where the store has one) onto the device and start the scoring
    service on a background thread (reference stage 2); returns the
    handle. ``replicas > 1`` serves through N apps sharing one predictor
    behind a round-robin front; ``buckets`` narrows the warmed shapes to
    the tester's request sizes. The checkpoint is read back from the
    store, which stays the source of truth, rather than reused from the
    train stage's memory.

    The front end, admission budget, serving precision, coalescer and
    buckets come from the pod environment as the JAX stage's do
    (:func:`_serve_env_knobs`, :func:`_serve_tuned_env_knobs`; the split
    topology's knobs, which one process cannot run, are warned of); an
    explicit ``buckets`` wins. ``tuned_config`` (default: the pod's
    ``BODYWORK_TPU_TUNED_CONFIG``, :func:`_serve_tuned_config_ref`) names
    a tuned serving-config document whose fitted values fill every knob
    left unset: spec args, then the per-knob env vars, then the tuned
    document, then the built-in defaults, and a malformed document
    degrades to the defaults (``tune.config``). A quantized dtype serves
    only if the shadow quality gate admits it. ``mesh_data`` /
    ``mesh_model`` (default: the pod's ``BODYWORK_TPU_MESH_DATA|_MODEL``)
    shard the forward over a ``data x model`` device mesh
    (``serve.server.build_predictor``)."""
    from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
    from bodywork_tpu_torch.serve.server import registry_bounds, serve_model

    (env_engine, env_max_pending, env_retry_max, env_dtype, env_mesh_data,
     env_mesh_model) = _serve_env_knobs()
    if mesh_data is None:
        mesh_data = env_mesh_data
    if mesh_model is None:
        mesh_model = env_mesh_model
    env_frontends = _serve_fleet_env_knobs()
    if env_frontends:
        log.warning(
            f"BODYWORK_TPU_FRONTENDS={env_frontends} selects the "
            "disaggregated process fleet (`cli serve --frontends`); "
            "the in-process serve stage runs one process and ignores it"
        )
    env_transport, _env_addr, env_role, _env_standby = _serve_transport_env_knobs()
    if env_transport != "shm" or env_role != "auto":
        log.warning(
            f"BODYWORK_TPU_SERVE_TRANSPORT={env_transport!r} / "
            f"BODYWORK_TPU_SERVE_ROLE={env_role!r} select the cross-host "
            "disaggregated split (`cli serve --transport/--role`); the "
            "in-process serve stage runs one process and ignores them"
        )
    env_window, env_max_rows, env_buckets = _serve_tuned_env_knobs()
    served_key, served_source = resolve_serving_key(ctx.store)
    model, model_date = load_model(ctx.store, served_key, device=_device(ctx))
    buckets = buckets or env_buckets
    if tuned_config is None:
        tuned_config = _serve_tuned_config_ref()
    return serve_model(
        model, model_date, host=host, port=port, block=False, engine=engine,
        buckets=tuple(buckets) if buckets else None, replicas=replicas,
        model_key=served_key, model_source=served_source,
        model_bounds=registry_bounds(ctx.store, served_key), dtype=env_dtype,
        store=ctx.store,
        batch_window_ms=env_window, batch_max_rows=env_max_rows, server_engine=env_engine,
        max_pending=env_max_pending, retry_after_max_s=env_retry_max,
        tuned_config=tuned_config, mesh_data=mesh_data, mesh_model=mesh_model,
    )


def test_stage(ctx: StageContext, mode: str = "batch",
               service_stage: str = "stage-2-serve-model",
               max_rows: int | None = None, batch_size: int = 512):
    """Score the latest dataset through the live service and persist the
    drift metrics (reference stage 4); returns the metrics record. Over
    HTTP when the context has a ``scoring_url``, else through the running
    service stage's app."""
    from bodywork_tpu_torch.monitor import (
        HttpScoringClient,
        InProcessScoringClient,
        run_service_test,
        scoring_endpoint,
    )

    if ctx.scoring_url is not None:
        client = HttpScoringClient(scoring_endpoint(ctx.scoring_url, mode))
    elif service_stage in ctx.services:
        client = InProcessScoringClient(ctx.services[service_stage].app)
    else:
        raise RuntimeError(
            f"test_stage needs a scoring_url or a running service "
            f"{service_stage!r} in the context"
        )
    return run_service_test(ctx.store, client, mode=mode, max_rows=max_rows,
                            batch_size=batch_size)
