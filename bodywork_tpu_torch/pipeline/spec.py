"""The pipeline specification (the port of ``bodywork_tpu.pipeline.spec``;
reference C1, ``bodywork.yaml``).

The reference declares its orchestration in one YAML file: a DAG string
(``stage-1 >> stage-2 >> stage-3 >> stage-4``, ``bodywork.yaml:5``) and
per-stage blocks with the executable, pip requirements, cpu/memory
requests, batch-vs-service kind, retries, timeouts, replicas, port,
ingress and secret env injection (``bodywork.yaml:8-82``). The port keeps
that model under the JAX package's names and YAML document, with the GPU
node pool in place of the TPU one: a stage that uses the card asks for
``gpu_count`` GPUs (``nvidia.com/gpu``) on nodes of the GKE accelerator
``gpu_accelerator``. The YAML goes through the port's own writer and
reader (:mod:`bodywork_tpu_torch.pipeline._yaml`), so every pod reads its
spec with the standard library alone. This module imports no torch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from bodywork_tpu_torch.pipeline import _yaml


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
class ResourceSpec:
    """Per-stage resource requests (reference ``bodywork.yaml:17-18,36-37``)
    plus the GPU node-pool dimension."""

    cpu_request: float = 0.5
    memory_mb: int = 256
    #: GKE accelerator node label for the nodeSelector, e.g.
    #: "nvidia-h100-80gb"
    gpu_accelerator: str | None = None
    #: GPUs requested per pod, as the ``nvidia.com/gpu`` resource
    gpu_count: int = 0
    #: hosts of a multi-host batch stage (the JAX spec's ``tpu_hosts``):
    #: > 1 emits an Indexed Job of one pod a host, joined by
    #: ``parallel.multihost_init`` into one process group
    gpu_hosts: int = 1


#: the JAX package's TPU resource fields: a pod asking for ``google.com/tpu``
#: never schedules on a GPU pool, so a document naming one is refused
_TPU_FIELDS = ("tpu_accelerator", "tpu_topology", "tpu_chips", "tpu_hosts")


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage (reference per-stage blocks, ``bodywork.yaml:8-82``)."""

    name: str
    kind: str  # "batch" (Job) | "service" (Deployment)
    #: ``"module:function"`` of the stage callable, e.g.
    #: ``"bodywork_tpu_torch.pipeline.stages:train_stage"``
    executable: str
    args: dict[str, Any] = dataclasses.field(default_factory=dict)
    retries: int = 2                      # bodywork.yaml:21
    max_completion_time_s: float = 30.0   # bodywork.yaml:20 (batch)
    max_startup_time_s: float = 30.0      # bodywork.yaml:39 (service)
    replicas: int = 1                     # bodywork.yaml:40
    port: int | None = None               # bodywork.yaml:41
    ingress: bool = False                 # bodywork.yaml:42
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    #: k8s secrets injected as env vars (bodywork.yaml:22-26); REQUIRED:
    #: a missing one fails the pod at admission
    secrets: list[str] = dataclasses.field(default_factory=list)
    #: secrets injected with ``optional: true``, for features that are
    #: no-ops when unconfigured (the sentry-integration DSN)
    optional_secrets: list[str] = dataclasses.field(default_factory=list)
    #: container image override for this stage's pods; None = the
    #: pipeline-wide image, or the tag derived from ``requirements``
    image: str | None = None
    #: this stage's pinned pip requirements (bodywork.yaml:10-16,29-35,
    #: 50-54,67-72); with no ``image``, the manifests derive a per-stage
    #: image tag from them and ``pipeline.images`` emits its build context
    requirements: list[str] = dataclasses.field(default_factory=list)
    resources: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)

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

    def service_dns(self, stage_name: str) -> str:
        """Cluster-internal service name, Bodywork's ``<project>--<stage>``
        (``stage_4:28``)."""
        return f"{self.name}--{stage_name}"

    # -- YAML round-trip ---------------------------------------------------
    def to_yaml(self) -> str:
        return _yaml.dump({
            "project": {
                "name": self.name,
                "version": self.version,
                "DAG": " >> ".join(",".join(step) for step in self.dag),
            },
            "stages": {name: _stage_to_doc(stage) for name, stage in self.stages.items()},
            "logging": {"log_level": self.log_level},
        })

    @classmethod
    def from_yaml(cls, text: str) -> "PipelineSpec":
        doc = _yaml.load(text)
        stages = {
            name: _stage_from_doc(name, block)
            for name, block in doc.get("stages", {}).items()
        }
        return cls(
            name=doc["project"]["name"],
            dag=parse_dag(doc["project"]["DAG"]),
            stages=stages,
            log_level=doc.get("logging", {}).get("log_level", "INFO"),
            version=str(doc["project"].get("version", "0.1")),
        )


def _stage_to_doc(stage: StageSpec) -> dict:
    doc: dict[str, Any] = {
        "kind": stage.kind,
        "executable": stage.executable,
        "args": dict(stage.args),
        "retries": stage.retries,
        "resources": dataclasses.asdict(stage.resources),
    }
    if stage.kind == "batch":
        doc["max_completion_time_seconds"] = stage.max_completion_time_s
    else:
        doc["max_startup_time_seconds"] = stage.max_startup_time_s
        doc["replicas"] = stage.replicas
        doc["port"] = stage.port
        doc["ingress"] = stage.ingress
    if stage.env:
        doc["env"] = dict(stage.env)
    if stage.secrets:
        doc["secrets"] = list(stage.secrets)
    if stage.optional_secrets:
        doc["optional_secrets"] = list(stage.optional_secrets)
    if stage.image:
        doc["image"] = stage.image
    if stage.requirements:
        doc["requirements"] = list(stage.requirements)
    return doc


#: secrets the framework declares optional by design; YAML written before
#: the required/optional split listed them under plain ``secrets``, and a
#: required ref would fail every pod on clusters that never created them
_KNOWN_OPTIONAL_SECRETS = ("sentry-integration",)


def _resources_from_doc(name: str, doc: dict) -> ResourceSpec:
    tpu = [f for f in _TPU_FIELDS if f in doc]
    if tpu:
        raise ValueError(
            f"stage {name!r}: resources name the TPU field(s) {tpu}; the port "
            "schedules on a GPU node pool (gpu_accelerator, gpu_count), and a pod "
            "asking for google.com/tpu never schedules there"
        )
    known = {f.name for f in dataclasses.fields(ResourceSpec)}
    unknown = sorted(set(doc) - known)
    if unknown:
        raise ValueError(f"stage {name!r}: unknown resource field(s) {unknown}")
    return ResourceSpec(**doc)


def _stage_from_doc(name: str, doc: dict) -> StageSpec:
    resources = _resources_from_doc(name, doc.get("resources", {}))
    secrets = list(doc.get("secrets", []))
    optional_secrets = list(doc.get("optional_secrets", []))
    for known in _KNOWN_OPTIONAL_SECRETS:
        if known in secrets:  # legacy-document migration
            secrets.remove(known)
            if known not in optional_secrets:
                optional_secrets.append(known)
    return StageSpec(
        name=name,
        kind=doc["kind"],
        executable=doc["executable"],
        args=doc.get("args", {}),
        retries=doc.get("retries", 2),
        max_completion_time_s=doc.get("max_completion_time_seconds", 30.0),
        max_startup_time_s=doc.get("max_startup_time_seconds", 30.0),
        replicas=doc.get("replicas", 1),
        port=doc.get("port"),
        ingress=doc.get("ingress", False),
        env=doc.get("env", {}),
        secrets=secrets,
        optional_secrets=optional_secrets,
        image=doc.get("image"),
        requirements=list(doc.get("requirements", [])),
        resources=resources,
    )


#: Per-stage pinned requirement sets (reference parity:
#: ``bodywork.yaml:10-16,29-35,50-54,67-72`` gives each stage its own pip
#: pins). One pin table, per-stage selections. The versions are the ones
#: the port runs with on the H100 (torch 2.11.0 built for CUDA 12.8,
#: numpy 2.3.5).
_PINS = {
    "torch": "torch==2.11.0",
    "numpy": "numpy==2.3.5",
}

#: Every stage pod runs ``python -m bodywork_tpu_torch.cli run-stage``.
#: The port needs no pandas, pyyaml, requests or werkzeug anywhere (its
#: own CSV, YAML, HTTP client and server), so the sets are measured, not
#: copied from the JAX package's: tests/test_torch_k8s.py runs each stage
#: with ``python -X importtime`` and asserts these sets cover what it
#: imports. The test stage runs with no accelerator runtime at all.
STAGE_REQUIREMENTS = {
    # train: device compute + history IO
    "stage-1-train-model": ["torch", "numpy"],
    # serve: device compute + the scoring service (stdlib HTTP)
    "stage-2-serve-model": ["torch", "numpy"],
    # generate: the threefry sampler on the device + CSV persistence
    "stage-3-generate-next-dataset": ["torch", "numpy"],
    # test: HTTP client (urllib) + metric records, deliberately torch-free
    "stage-4-test-model-scoring-service": ["numpy"],
}


def stage_requirements(stage_name: str) -> list[str]:
    """The pinned requirement lines for one canonical stage."""
    return [_PINS[p] for p in STAGE_REQUIREMENTS[stage_name]]


TRAIN_STAGE = "stage-1-train-model"
SERVE_STAGE = "stage-2-serve-model"
GENERATE_STAGE = "stage-3-generate-next-dataset"
TEST_STAGE = "stage-4-test-model-scoring-service"

_STAGES = "bodywork_tpu_torch.pipeline.stages"

#: the card each device stage's pod asks for
H100_ACCELERATOR = "nvidia-h100-80gb"


def default_pipeline(model_type: str = "linear", scoring_mode: str = "batch",
                     port: int = 5000, overlap_generate: bool = False) -> PipelineSpec:
    """The canonical daily train -> serve -> generate -> test pipeline
    (``spec.py:261-353``, the reference's four stages), on the port's
    stage callables: the same args, retries, deadlines, replicas, secrets
    and pinned requirements, each device stage on one H100 and the test
    stage on a CPU pod.

    ``overlap_generate`` moves generate into serve's DAG step
    (``s1 >> s2,s3 >> s4``): generation depends only on the date, not on
    the trained model, so it runs beside the service's start-up and test
    still runs after both. The reference's serial DAG
    (``bodywork.yaml:5``) stays the default."""
    h100 = ResourceSpec(cpu_request=0.5, memory_mb=512,
                        gpu_accelerator=H100_ACCELERATOR, gpu_count=1)
    # the reference injects its secrets into every stage (bodywork.yaml:
    # 22-26); here the error-monitoring DSN, optional (utils/errors.py)
    secrets = ["sentry-integration"]
    stages = {
        TRAIN_STAGE: StageSpec(
            name=TRAIN_STAGE, kind="batch",
            requirements=stage_requirements(TRAIN_STAGE),
            executable=f"{_STAGES}:train_stage",
            args={"model_type": model_type},
            optional_secrets=list(secrets), resources=h100,
        ),
        SERVE_STAGE: StageSpec(
            name=SERVE_STAGE, kind="service",
            requirements=stage_requirements(SERVE_STAGE),
            executable=f"{_STAGES}:serve_stage",
            # warm only the buckets the tester's request sizes need
            args={"buckets": [2048] if scoring_mode == "batch" else [1]},
            replicas=2, port=port, ingress=False,
            optional_secrets=list(secrets), resources=h100,
        ),
        GENERATE_STAGE: StageSpec(
            name=GENERATE_STAGE, kind="batch",
            requirements=stage_requirements(GENERATE_STAGE),
            executable=f"{_STAGES}:generate_stage",
            optional_secrets=list(secrets), resources=dataclasses.replace(h100),
        ),
        TEST_STAGE: StageSpec(
            name=TEST_STAGE, kind="batch",
            requirements=stage_requirements(TEST_STAGE),
            executable=f"{_STAGES}:test_stage",
            # one full simulated day (<= 1440 rows) is one batch request
            args=(
                {"mode": scoring_mode, "batch_size": 2048}
                if scoring_mode == "batch" else {"mode": scoring_mode}
            ),
            optional_secrets=list(secrets),
            resources=ResourceSpec(cpu_request=0.5, memory_mb=256),
        ),
    }
    if overlap_generate:
        dag = [[TRAIN_STAGE], [SERVE_STAGE, GENERATE_STAGE], [TEST_STAGE]]
    else:
        dag = [[TRAIN_STAGE], [SERVE_STAGE], [GENERATE_STAGE], [TEST_STAGE]]
    return PipelineSpec(name="bodywork-tpu-pipeline", dag=dag, stages=stages)
