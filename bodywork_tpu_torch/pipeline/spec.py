"""The pipeline specification (the port of ``bodywork_tpu.pipeline.spec``;
reference C1, ``bodywork.yaml``).

The reference declares its orchestration in one YAML file: a DAG string
(``stage-1 >> stage-2 >> stage-3 >> stage-4``, ``bodywork.yaml:5``) and
per-stage blocks with the executable, batch-vs-service kind, retries,
timeouts, replicas and port. The port keeps that model, built in Python:
the YAML round-trip, resources, secrets, images and the k8s manifests are
not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any


def parse_dag(dag: str) -> list[list[str]]:
    """``"a >> b,c >> d"`` -> ``[["a"], ["b", "c"], ["d"]]``: stages within
    a step may run concurrently, steps run in order (``bodywork.yaml:5``)."""
    steps = []
    for step in dag.split(">>"):
        names = [s.strip() for s in step.split(",") if s.strip()]
        if names:
            steps.append(names)
    return steps


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage (reference per-stage blocks, ``bodywork.yaml:8-82``)."""

    name: str
    kind: str  # "batch" (run to completion) | "service" (long-running)
    #: ``"module:function"`` of the stage callable, e.g.
    #: ``"bodywork_tpu_torch.pipeline.stages:train_stage"``
    executable: str
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    retries: int = 2                      # bodywork.yaml:21
    max_completion_time_s: float = 30.0   # bodywork.yaml:20 (batch)
    max_startup_time_s: float = 30.0      # bodywork.yaml:39 (service)
    replicas: int = 1                     # bodywork.yaml:40
    port: int | None = None               # bodywork.yaml:41

    def __post_init__(self):
        if self.kind not in ("batch", "service"):
            raise ValueError(f"stage {self.name!r}: kind must be batch|service")


@dataclasses.dataclass
class PipelineSpec:
    name: str
    dag: list[list[str]]
    stages: dict[str, StageSpec]
    log_level: str = "INFO"               # bodywork.yaml:83-84
    version: str = "0.1"

    def __post_init__(self):
        missing = {s for step in self.dag for s in step} - set(self.stages)
        if missing:
            raise ValueError(f"DAG references undeclared stages: {sorted(missing)}")


TRAIN_STAGE = "stage-1-train-model"
SERVE_STAGE = "stage-2-serve-model"
GENERATE_STAGE = "stage-3-generate-next-dataset"
TEST_STAGE = "stage-4-test-model-scoring-service"

_STAGES = "bodywork_tpu_torch.pipeline.stages"


def default_pipeline(model_type: str = "linear", scoring_mode: str = "batch",
                     port: int = 5000, overlap_generate: bool = False) -> PipelineSpec:
    """The canonical daily train -> serve -> generate -> test pipeline
    (``spec.py:261-353``, the reference's four stages), on the port's
    stage callables: the same args, retries, deadlines and replicas.

    ``overlap_generate`` moves generate into serve's DAG step
    (``s1 >> s2,s3 >> s4``): generation depends only on the date, not on
    the trained model, so it runs beside the service's start-up and test
    still runs after both. The reference's serial DAG
    (``bodywork.yaml:5``) stays the default."""
    stages = {
        TRAIN_STAGE: StageSpec(
            name=TRAIN_STAGE, kind="batch",
            executable=f"{_STAGES}:train_stage",
            args={"model_type": model_type},
        ),
        SERVE_STAGE: StageSpec(
            name=SERVE_STAGE, kind="service",
            executable=f"{_STAGES}:serve_stage",
            # warm only the buckets the tester's request sizes need
            args={"buckets": [2048] if scoring_mode == "batch" else [1]},
            replicas=2, port=port,
        ),
        GENERATE_STAGE: StageSpec(
            name=GENERATE_STAGE, kind="batch",
            executable=f"{_STAGES}:generate_stage",
        ),
        TEST_STAGE: StageSpec(
            name=TEST_STAGE, kind="batch",
            executable=f"{_STAGES}:test_stage",
            # one full simulated day (<= 1440 rows) is one batch request
            args=(
                {"mode": scoring_mode, "batch_size": 2048}
                if scoring_mode == "batch" else {"mode": scoring_mode}
            ),
        ),
    }
    if overlap_generate:
        dag = [[TRAIN_STAGE], [SERVE_STAGE, GENERATE_STAGE], [TEST_STAGE]]
    else:
        dag = [[TRAIN_STAGE], [SERVE_STAGE], [GENERATE_STAGE], [TEST_STAGE]]
    return PipelineSpec(name="bodywork-tpu-pipeline", dag=dag, stages=stages)
