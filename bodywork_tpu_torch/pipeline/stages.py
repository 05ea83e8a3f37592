"""The four canonical stage callables (the port of
``bodywork_tpu.pipeline.stages``; reference C2-C5 entry points).

Each stage is a function ``stage(ctx, **args)`` over a shared
:class:`StageContext`. Batch stages return when done; the service stage
returns a started handle the runner owns for the rest of the day.

- ``train_stage``    <- ``stage_1_train_model.main``
- ``serve_stage``    <- ``stage_2_serve_model`` ``__main__``
- ``generate_stage`` <- ``stage_3_synthetic_data_generation.main``
- ``test_stage``     <- ``stage_4_test_model_scoring_service.main``

Every stage computes on ``ctx.device``, the runner's device (the card
unless the runner was asked for the CPU).
"""
from __future__ import annotations

import dataclasses
from datetime import date, timedelta

import torch

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
    #: where the stages compute
    device: torch.device
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


def generate_stage(ctx: StageContext, offset_days: int = 1) -> str:
    """Generate the NEXT simulated day's drifting data (reference stage 3:
    tomorrow's dataset appears today); returns its key."""
    from bodywork_tpu_torch.data.generator import generate_day
    from bodywork_tpu_torch.data.io import Dataset, persist_dataset

    target = ctx.today + timedelta(days=offset_days)
    X, y = generate_day(target, ctx.drift, device=ctx.device)
    return persist_dataset(ctx.store, Dataset(X, y, target))


def train_stage(ctx: StageContext, model_type: str = "linear", mode: str | None = None,
                mesh_data: int | None = None, mesh_model: int = 1, **model_kwargs):
    """Train on all data to date and persist the checkpoint and its
    metrics (reference stage 1); returns the ``TrainResult``. The flat
    ``model_kwargs`` are the model's config fields."""
    from bodywork_tpu_torch.train import train_on_history

    return train_on_history(
        ctx.store, model_type, model_kwargs=model_kwargs or None,
        mesh_data=mesh_data, mesh_model=mesh_model, mode=mode or "full",
        device=ctx.device,
    )


def serve_stage(ctx: StageContext, host: str = "127.0.0.1", port: int = 0,
                buckets: tuple[int, ...] | None = None, replicas: int = 1,
                engine: str = "auto"):
    """Load the checkpoint to serve (the registry's ``production`` alias
    where the store has one) onto the device and start the scoring
    service on a background thread (reference stage 2); returns the
    handle. ``replicas > 1`` serves through N apps sharing one predictor
    behind a round-robin front; ``buckets`` narrows the warmed shapes to
    the tester's request sizes. The checkpoint is read back from the
    store, which stays the source of truth, rather than reused from the
    train stage's memory."""
    from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
    from bodywork_tpu_torch.serve.server import registry_bounds, serve_model

    served_key, served_source = resolve_serving_key(ctx.store)
    model, model_date = load_model(ctx.store, served_key, device=ctx.device)
    return serve_model(
        model, model_date, host=host, port=port, block=False, engine=engine,
        buckets=tuple(buckets) if buckets else None, replicas=replicas,
        model_key=served_key, model_source=served_source,
        model_bounds=registry_bounds(ctx.store, served_key),
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
