"""GKE/Kubernetes manifest generation for a GPU node pool (the port of
``bodywork_tpu.pipeline.k8s``; reference C1's deployment half).

The reference delegates materialisation to the Bodywork controller: batch
stages become Jobs (retries/timeout, ``bodywork.yaml:19-21``), the service
stage a 2-replica Deployment + cluster Service on port 5000
(``bodywork.yaml:38-42``), secrets injected as env (``bodywork.yaml:22-26``).
The framework emits those manifests itself, under the JAX generator's
names, labels, DNS, gates, schedules, probes and serve knobs, with the
GPU node pool in place of the TPU one: a stage whose resources ask for
cards gets ``resources.limits`` ``{"nvidia.com/gpu": gpu_count}`` and
the nodeSelector ``cloud.google.com/gke-accelerator: <gpu_accelerator>``
(GKE's GPU scheduling model). Every command runs
``python -m bodywork_tpu_torch.cli``; the XLA compilation-cache env of
the JAX pods is not emitted (the port's kernels are built into the
stage image, ``pipeline.images``).

Artefacts flow through one of three store media (``store_volume=``), as
in the JAX generator: ``pvc`` (a ``ReadWriteMany`` claim mounted at the
store path in every pod; the default for filesystem paths), ``hostpath``
(single-node clusters only, an explicit opt-in) and ``gcs`` (no volume;
the default for ``gs://`` paths, ``store/gcs.py``).

Modes whose runtime the port lacks are refused by name rather than
emitted as pods that would run a command the port does not have: a
tenant namespace (``BODYWORK_TPU_TENANT``: ROADMAP Queue 1 item 14), the
split serving topology, the dispatcher standby pair and the front-end
fleet (``BODYWORK_TPU_SERVE_TRANSPORT``, ``BODYWORK_TPU_SERVE_STANDBY``,
``BODYWORK_TPU_FRONTENDS``, ``BODYWORK_TPU_DISPATCHER_ADDR``,
``BODYWORK_TPU_SERVE_ROLE``: ROADMAP Queue 1 item 15), the tuned config
and the online tuner (``BODYWORK_TPU_TUNED_CONFIG``,
``BODYWORK_TPU_TUNE_ONLINE``: item 17) and a serving mesh
(``BODYWORK_TPU_MESH_DATA`` / ``_MODEL`` > 1: item 19). So the split
topology's dispatcher Deployment and Service are never emitted and are
left out of the port until item 15. The serve Deployment's HPA is
emitted as the JAX generator emits it for every service stage; its
row-queue metrics come with item 15's fleet, and until then it holds the
Deployment at its replicas.

The daily loop is a CronJob running ``run-day`` (the reference re-runs the
whole deployment daily, README.md:5), with the history compaction, the
store scrub and the drift gate as CronJobs after it.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from bodywork_tpu_torch.pipeline import _yaml
from bodywork_tpu_torch.pipeline.images import stage_image_tag
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, ResourceSpec, StageSpec

_STORE_VOLUME = "artefact-store"
_SPEC_VOLUME = "pipeline-spec"
_SPEC_MOUNT = "/etc/bodywork"
_SPEC_FILE = "pipeline.yaml"
_DEFAULT_IMAGE = "bodywork-tpu/runtime:latest"
_CLI = ["python", "-m", "bodywork_tpu_torch.cli"]

STORE_VOLUME_MODES = ("auto", "pvc", "hostpath", "gcs")

DEFAULT_DAILY_SCHEDULE = "0 6 * * *"

#: stage env knobs that select a mode the port cannot run yet -> the
#: ROADMAP Queue 1 item that brings it
_UNPORTED_ENV = {
    "BODYWORK_TPU_TENANT": (14, "a tenant namespace"),
    "BODYWORK_TPU_SERVE_TRANSPORT": (15, "the split serving topology"),
    "BODYWORK_TPU_SERVE_STANDBY": (15, "the dispatcher standby pair"),
    "BODYWORK_TPU_FRONTENDS": (15, "the front-end fleet"),
    "BODYWORK_TPU_DISPATCHER_ADDR": (15, "the split serving topology"),
    "BODYWORK_TPU_SERVE_ROLE": (15, "the split serving topology"),
    "BODYWORK_TPU_TUNED_CONFIG": (17, "the tuned serving config"),
    "BODYWORK_TPU_TUNE_ONLINE": (17, "the online tuning controller"),
}
_MESH_ENV = ("BODYWORK_TPU_MESH_DATA", "BODYWORK_TPU_MESH_MODEL")


def _refuse_unported_modes(spec: PipelineSpec) -> None:
    for stage in spec.stages.values():
        for name, value in stage.env.items():
            value = str(value).strip()
            if name in _UNPORTED_ENV and value not in ("", "default"):
                item, what = _UNPORTED_ENV[name]
                raise ValueError(
                    f"stage {stage.name!r}: {name}={value!r} selects {what}, which "
                    f"the port does not run until ROADMAP Queue 1 item {item}"
                )
            if name in _MESH_ENV and value:
                try:
                    size = int(value)
                except ValueError:
                    size = 1
                if size > 1:
                    raise ValueError(
                        f"stage {stage.name!r}: {name}={value!r} selects a serving "
                        "mesh, which the port does not run until ROADMAP Queue 1 item 19"
                    )


def _offset_schedule(schedule: str, minutes: int) -> str:
    """Shift a simple 5-field cron line's minute field by ``minutes`` (mod
    60, bumping a numeric hour field when it wraps), used to run the
    drift gate after the day loop it audits. Non-numeric fields keep the
    hour untouched. When the hour wraps past midnight and the schedule
    pins a day-of-month, day-of-week or month, the shift is abandoned:
    cron has no carry into the day fields, so ``45 23 * * 1`` shifted to
    ``15 0 * * 1`` would fire ~23h45m early."""
    fields = schedule.split()
    if len(fields) != 5 or not fields[0].isdigit():
        return schedule  # macro or complex minute: run at the same time
    minute = int(fields[0]) + minutes
    if minute >= 60 and fields[1].isdigit():
        hour = int(fields[1]) + minute // 60
        if hour >= 24 and fields[2:5] != ["*", "*", "*"]:
            return schedule  # day would be wrong: keep the original time
        fields[1] = str(hour % 24)
    fields[0] = str(minute % 60)
    return " ".join(fields)


@dataclasses.dataclass(frozen=True)
class _StoreMedium:
    """How pods reach the shared artefact store (module docstring)."""

    store_path: str
    mode: str  # "pvc" | "hostpath" | "gcs"
    claim_name: str = ""
    storage_class: str | None = None
    size: str = "10Gi"

    def volume(self) -> dict | None:
        if self.mode == "gcs":
            return None
        if self.mode == "hostpath":
            source = {"hostPath": {"path": self.store_path, "type": "DirectoryOrCreate"}}
        else:
            source = {"persistentVolumeClaim": {"claimName": self.claim_name}}
        return {"name": _STORE_VOLUME, **source}

    def mount(self) -> dict | None:
        if self.mode == "gcs":
            return None
        return {"name": _STORE_VOLUME, "mountPath": self.store_path}

    def pvc_doc(self, namespace: str) -> dict:
        assert self.mode == "pvc"
        pvc_spec: dict = {
            # ReadWriteMany: the Jobs on the GPU node pool and the serve
            # Deployment mount it concurrently from different nodes
            "accessModes": ["ReadWriteMany"],
            "resources": {"requests": {"storage": self.size}},
        }
        if self.storage_class:
            pvc_spec["storageClassName"] = self.storage_class
        return {
            "apiVersion": "v1",
            "kind": "PersistentVolumeClaim",
            "metadata": {"name": self.claim_name, "namespace": namespace},
            "spec": pvc_spec,
        }


def _resolve_store_medium(spec: PipelineSpec, store_path: str, store_volume: str,
                          storage_class: str | None, pvc_size: str) -> _StoreMedium:
    if store_volume not in STORE_VOLUME_MODES:
        raise ValueError(
            f"store_volume must be one of {STORE_VOLUME_MODES}, got {store_volume!r}"
        )
    is_gcs_path = store_path.startswith("gs://")
    if store_volume == "auto":
        store_volume = "gcs" if is_gcs_path else "pvc"
    if is_gcs_path != (store_volume == "gcs"):
        raise ValueError(
            f"store_volume={store_volume!r} does not fit store_path={store_path!r}: "
            "use a gs:// path with 'gcs' and a filesystem path with 'pvc'/'hostpath'"
        )
    return _StoreMedium(store_path=store_path, mode=store_volume,
                        claim_name=f"{spec.name}--store", storage_class=storage_class,
                        size=pvc_size)


def _spec_volume(spec: PipelineSpec) -> tuple[dict, dict]:
    """The deploy-time pipeline spec rides into every pod as a ConfigMap,
    so in-cluster entry points run exactly the deployed configuration."""
    volume = {"name": _SPEC_VOLUME, "configMap": {"name": f"{spec.name}--spec"}}
    mount = {"name": _SPEC_VOLUME, "mountPath": _SPEC_MOUNT, "readOnly": True}
    return volume, mount


#: the serve Deployment's env knobs and their defaults (the JAX
#: generator's list; an operator flips one with `kubectl set env`)
_SERVE_ENV_DEFAULTS = (
    ("BODYWORK_TPU_SERVER_ENGINE", "thread"),
    ("BODYWORK_TPU_MAX_PENDING", ""),
    ("BODYWORK_TPU_RETRY_AFTER_MAX_S", ""),
    ("BODYWORK_TPU_SERVE_DTYPE", "float32"),
    ("BODYWORK_TPU_MESH_DATA", ""),
    ("BODYWORK_TPU_MESH_MODEL", ""),
    ("BODYWORK_TPU_FRONTENDS", ""),
    ("BODYWORK_TPU_SERVE_TRANSPORT", ""),
    ("BODYWORK_TPU_DISPATCHER_ADDR", ""),
    ("BODYWORK_TPU_SERVE_ROLE", ""),
    ("BODYWORK_TPU_SERVE_STANDBY", ""),
    ("BODYWORK_TPU_BATCH_WINDOW_MS", ""),
    ("BODYWORK_TPU_BATCH_MAX_ROWS", ""),
    ("BODYWORK_TPU_BUCKETS", ""),
    ("BODYWORK_TPU_TUNED_CONFIG", ""),
    ("BODYWORK_TPU_SLO_WINDOW_REQUESTS", ""),
    ("BODYWORK_TPU_SLO_MIN_REQUESTS", ""),
    ("BODYWORK_TPU_SLO_MAX_ERROR_RATE", ""),
    ("BODYWORK_TPU_SLO_MAX_P99_RATIO", ""),
    ("BODYWORK_TPU_SLO_MAX_SANITY_VIOLATIONS", ""),
    ("BODYWORK_TPU_SLO_PROMOTE_AFTER_REQUESTS", ""),
    ("BODYWORK_TPU_TUNE_ONLINE", ""),
    ("BODYWORK_TPU_TUNE_REQUEST_LOGS", ""),
    ("BODYWORK_TPU_TUNE_RESULTS_LOGS", ""),
    ("BODYWORK_TPU_TUNE_MIN_WINDOW_REQUESTS", ""),
    ("BODYWORK_TPU_TUNE_DRIFT_THRESHOLD", ""),
    ("BODYWORK_TPU_TUNE_COOLDOWN_POLLS", ""),
    ("BODYWORK_TPU_TUNE_VERDICT_POLLS", ""),
    ("BODYWORK_TPU_TUNE_MIN_VERDICT_REQUESTS", ""),
    ("BODYWORK_TPU_TUNE_REVERT_ERROR_RATE", ""),
    ("BODYWORK_TPU_TUNE_REVERT_P99_RATIO", ""),
    ("BODYWORK_TPU_COST_BUDGET_S", ""),
)


def _container(spec: PipelineSpec, stage: StageSpec, store: _StoreMedium, image: str,
               command: list[str]) -> dict:
    _, spec_mount = _spec_volume(spec)
    resources: dict = {
        "requests": {
            "cpu": str(stage.resources.cpu_request),
            "memory": f"{stage.resources.memory_mb}Mi",
        }
    }
    if stage.resources.gpu_count:
        resources["limits"] = {"nvidia.com/gpu": stage.resources.gpu_count}
    env = [{"name": k, "value": str(v)} for k, v in stage.env.items()]
    # required secrets fail fast at admission; optional ones back features
    # that are no-ops when unconfigured (utils/errors.py's DSN)
    env_from = [{"secretRef": {"name": s}} for s in stage.secrets]
    env_from += [{"secretRef": {"name": s, "optional": True}} for s in stage.optional_secrets]
    container = {
        "name": stage.name,
        "image": stage_image_tag(stage, image) or image,
        "command": command,
        "volumeMounts": [m for m in (store.mount(), spec_mount) if m],
        "resources": resources,
    }
    if env:
        container["env"] = env
    if env_from:
        container["envFrom"] = env_from
    if stage.kind == "service" and stage.port:
        declared = {e["name"] for e in env}
        env += [{"name": name, "value": value} for name, value in _SERVE_ENV_DEFAULTS
                if name not in declared]
        container["env"] = env
        # one named port serves scoring and GET /metrics; the scrape
        # annotations point at it
        container["ports"] = [{"containerPort": stage.port, "name": "http"}]
        container["readinessProbe"] = {
            "httpGet": {"path": "/healthz", "port": stage.port},
            "initialDelaySeconds": 2,
            "periodSeconds": 3,
            "failureThreshold": int(stage.max_startup_time_s // 3) or 1,
            # a replica at its pending budget keeps answering /healthz 200
            # (shedding is the service working); only one with no model
            # (503) leaves the rotation
            "timeoutSeconds": 2,
        }
    return container


def _pod_spec(spec: PipelineSpec, stage: StageSpec, store: _StoreMedium, image: str,
              command: list[str], restart_policy: str, gate_on_deps: bool = True) -> dict:
    spec_volume, _ = _spec_volume(spec)
    pod: dict = {
        "containers": [_container(spec, stage, store, image, command)],
        "volumes": [v for v in (store.volume(), spec_volume) if v],
        "restartPolicy": restart_policy,
    }
    if gate_on_deps:
        init_containers = _init_containers(spec, stage, store, image)
        if init_containers:
            pod["initContainers"] = init_containers
    if stage.resources.gpu_accelerator:
        pod["nodeSelector"] = {
            "cloud.google.com/gke-accelerator": stage.resources.gpu_accelerator,
        }
    return pod


def _init_containers(spec: PipelineSpec, stage: StageSpec, store: _StoreMedium,
                     image: str) -> list[dict]:
    """DAG-ordering gates as initContainers: ``kubectl apply -f`` creates
    every Job at once, so each pod gates itself on the observable effects
    of its DAG predecessors through ``cli wait-for``: a produced artefact
    for batch predecessors, a healthy endpoint for service predecessors.
    No controller or RBAC is needed."""
    conditions: list[str] = []
    # input precondition: training needs data to exist at all
    if stage.executable.endswith(":train_stage"):
        conditions += ["--dataset"]
    if stage.executable.endswith(":serve_stage"):
        conditions += ["--model"]
    # DAG predecessors, by the effect each one produces
    seen_self = False
    for step in reversed(spec.dag):
        if stage.name in step:
            seen_self = True
            continue
        if not seen_self:
            continue
        for pred_name in step:
            pred = spec.stages[pred_name]
            if pred.kind == "service" and pred.port:
                conditions += [
                    "--service-url",
                    f"http://{spec.service_dns(pred.name)}:{pred.port}/healthz",
                ]
            elif pred.executable.endswith(":generate_stage"):
                conditions += ["--dataset-newer-than-model"]
            elif pred.executable.endswith(":train_stage"):
                conditions += ["--model"]
        break  # only the immediately preceding step gates this stage
    if not conditions:
        return []
    _, spec_mount = _spec_volume(spec)
    return [{
        "name": "wait-for-deps",
        # the gate runs in the stage's own image and dependency set
        "image": stage_image_tag(stage, image) or image,
        "command": [*_CLI, "wait-for", "--store", store.store_path, *conditions],
        "volumeMounts": [m for m in (store.mount(), spec_mount) if m],
    }]


def _stage_command(spec: PipelineSpec, stage: StageSpec, store_path: str) -> list[str]:
    cmd = [*_CLI, "run-stage", "--stage", stage.name, "--store", store_path,
           "--spec", f"{_SPEC_MOUNT}/{_SPEC_FILE}"]
    service_stages = [s for s in spec.stages.values() if s.kind == "service"]
    if stage.kind == "batch" and service_stages:
        svc = service_stages[0]
        cmd += ["--scoring-url", f"http://{spec.service_dns(svc.name)}:{svc.port}/score/v1"]
    return cmd


def _cronjob(spec: PipelineSpec, name: str, namespace: str, labels: dict, schedule: str,
             job_spec: dict) -> dict:
    return {
        "apiVersion": "batch/v1",
        "kind": "CronJob",
        "metadata": {"name": f"{spec.name}--{name}", "namespace": namespace,
                     "labels": labels},
        "spec": {"schedule": schedule, "concurrencyPolicy": "Forbid",
                 "jobTemplate": {"spec": job_spec}},
    }


def _serve_docs(i: int, spec: PipelineSpec, stage: StageSpec, store: _StoreMedium,
                image: str, command: list[str], meta: dict, labels: dict) -> dict:
    """The service stage's Deployment, Service, HPA and (with
    ``ingress``) Ingress."""
    docs = {}
    docs[f"{i:02d}-{stage.name}-deployment.yaml"] = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta,
        "spec": {
            "replicas": stage.replicas,
            "selector": {"matchLabels": {"app": labels["app"]}},
            "template": {
                "metadata": {
                    "labels": labels,
                    # Prometheus pod discovery: every replica exposes GET
                    # /metrics on its serving port
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/port": str(stage.port),
                        "prometheus.io/path": "/metrics",
                    },
                },
                "spec": {
                    **_pod_spec(spec, stage, store, image, command, "Always"),
                    # k8s's grace window: SIGTERM, then SIGKILL after 30 s
                    "terminationGracePeriodSeconds": 30,
                },
            },
        },
    }
    docs[f"{i:02d}-{stage.name}-service.yaml"] = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta,
        "spec": {
            "selector": {"app": labels["app"]},
            "ports": [{"port": stage.port, "targetPort": stage.port, "name": "http"}],
            "type": "ClusterIP",
        },
    }
    # queue-pressure autoscaling on the row-queue's own saturation signals
    # (occupancy ratio, wait p90), the JAX generator's HPA: the metrics
    # come with the front-end fleet (ROADMAP Queue 1 item 15)
    docs[f"{i:02d}-{stage.name}-hpa.yaml"] = {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": meta,
        "spec": {
            "scaleTargetRef": {"apiVersion": "apps/v1", "kind": "Deployment",
                               "name": meta["name"]},
            "minReplicas": max(stage.replicas, 1),
            "maxReplicas": max(stage.replicas, 1) * 4,
            "metrics": [
                {"type": "Pods", "pods": {
                    "metric": {"name": "bodywork_tpu_rowqueue_occupancy_ratio"},
                    "target": {"type": "AverageValue", "averageValue": "750m"}}},
                {"type": "Pods", "pods": {
                    "metric": {"name": "bodywork_tpu_rowqueue_wait_seconds_p90"},
                    "target": {"type": "AverageValue", "averageValue": "50m"}}},
            ],
            "behavior": {
                "scaleUp": {"stabilizationWindowSeconds": 30, "policies": [
                    {"type": "Percent", "value": 100, "periodSeconds": 30}]},
                "scaleDown": {"stabilizationWindowSeconds": 300, "policies": [
                    {"type": "Pods", "value": 1, "periodSeconds": 60}]},
            },
        },
    }
    if stage.ingress:
        # the reference's per-service `ingress` knob (bodywork.yaml:42):
        # /<project>/<stage> behind an nginx ingress WITH a rewrite, so the
        # app still sees its own routes (/score/v1, /healthz)
        docs[f"{i:02d}-{stage.name}-ingress.yaml"] = {
            "apiVersion": "networking.k8s.io/v1",
            "kind": "Ingress",
            "metadata": {**meta, "annotations": {
                "nginx.ingress.kubernetes.io/rewrite-target": "/$2"}},
            "spec": {"rules": [{"http": {"paths": [{
                # capture group 2 is the app-relative path forwarded
                "path": f"/{spec.name}/{stage.name}(/|$)(.*)",
                "pathType": "ImplementationSpecific",
                "backend": {"service": {"name": spec.service_dns(stage.name),
                                        "port": {"number": stage.port}}},
            }]}}]},
        }
    return docs


def generate_manifests(spec: PipelineSpec, store_path: str = "/mnt/artefact-store",
                       image: str = _DEFAULT_IMAGE, namespace: str = "bodywork-tpu",
                       daily_schedule: str | None = DEFAULT_DAILY_SCHEDULE,
                       store_volume: str = "auto", storage_class: str | None = "standard-rwx",
                       pvc_size: str = "10Gi") -> dict[str, dict]:
    """Emit every k8s object of the pipeline, keyed by filename, and run
    both validator layers over them (``validate_manifests``).

    ``store_volume`` selects the shared-store medium (module docstring):
    ``"auto"`` picks ``"gcs"`` for ``gs://`` store paths and ``"pvc"``
    otherwise; ``"hostpath"`` is a single-node-cluster opt-in.
    ``storage_class`` defaults to GKE Filestore CSI's ``standard-rwx``: a
    ReadWriteMany claim cannot provision against the usual RWO-only
    default class. A stage env knob selecting a mode the port lacks
    raises ``ValueError`` naming the ROADMAP item."""
    _refuse_unported_modes(spec)
    store = _resolve_store_medium(spec, store_path, store_volume, storage_class, pvc_size)
    docs: dict[str, dict] = {
        "00-namespace.yaml": {
            "apiVersion": "v1", "kind": "Namespace", "metadata": {"name": namespace},
        },
        "00-pipeline-spec-configmap.yaml": {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": f"{spec.name}--spec", "namespace": namespace},
            "data": {_SPEC_FILE: spec.to_yaml()},
        },
    }
    if store.mode == "pvc":
        docs["00-store-pvc.yaml"] = store.pvc_doc(namespace)
    labels_base = {"app.kubernetes.io/part-of": spec.name}
    for i, step in enumerate(spec.dag, start=1):
        for stage_name in step:
            stage = spec.stages[stage_name]
            labels = {**labels_base, "app": spec.service_dns(stage.name)}
            command = _stage_command(spec, stage, store_path)
            meta = {"name": spec.service_dns(stage.name), "namespace": namespace,
                    "labels": labels}
            if stage.kind == "batch":
                docs[f"{i:02d}-{stage.name}-job.yaml"] = {
                    "apiVersion": "batch/v1",
                    "kind": "Job",
                    "metadata": meta,
                    "spec": {
                        "backoffLimit": stage.retries,
                        "activeDeadlineSeconds": int(stage.max_completion_time_s),
                        "template": {
                            "metadata": {"labels": labels},
                            "spec": _pod_spec(spec, stage, store, image, command, "Never"),
                        },
                    },
                }
            else:
                docs.update(_serve_docs(i, spec, stage, store, image, command, meta, labels))
    if daily_schedule:
        docs.update(_cron_docs(spec, store, image, namespace, daily_schedule, labels_base))
    # strict structural validation: a typo'd field name fails here, at
    # generation, not at `kubectl apply`
    from bodywork_tpu_torch.pipeline.k8s_validate import validate_manifests

    validate_manifests(docs)
    return docs


def _cron_docs(spec: PipelineSpec, store: _StoreMedium, image: str, namespace: str,
               daily_schedule: str, labels_base: dict) -> dict:
    """The daily loop, then history compaction (+15 min), the drift gate
    (+30) and the store scrub (+45), as the JAX generator emits them."""
    store_path = store.store_path
    first_stage = next(iter(spec.stages.values()))
    # run-day runs all four stages (and the registry gate) in-process, so
    # its pod needs every stage's closure: the pipeline-wide image, never
    # a per-stage one; it keeps stage-1's card (it trains on the device).
    # The train-mode knob is materialised for `kubectl set env`.
    run_day_stage = dataclasses.replace(
        first_stage, name="daily-loop", image=None, requirements=[],
        env={"BODYWORK_TPU_TRAIN_MODE": "full", **first_stage.env},
    )
    run_day_command = [*_CLI, "run-day", "--store", store_path,
                       "--spec", f"{_SPEC_MOUNT}/{_SPEC_FILE}"]
    if store.mode != "gcs":
        # per-day run report + Chrome trace on the store volume ({date}
        # substituted by run-day); a dotted directory, outside the store's
        # prefixes
        run_day_command += ["--trace-out", f"{store_path}/.traces/day-{{date}}.trace.json"]
    docs = {
        "99-daily-loop-cronjob.yaml": _cronjob(
            spec, "daily-loop", namespace, labels_base, daily_schedule, {
                # retries ride the journal: each resumes from the last
                # completed stage; exit 6 marks a retry that found the day
                # already complete
                "backoffLimit": 3,
                "template": {"spec": {
                    # run-day sequences and bootstraps internally: a dataset
                    # gate here would deadlock a fresh store
                    **_pod_spec(spec, run_day_stage, store, image, run_day_command,
                                "Never", gate_on_deps=False),
                    # beyond run-day's 20 s SIGTERM drain (journal marked
                    # interrupted, lease released), then SIGKILL
                    "terminationGracePeriodSeconds": 30,
                }},
            }),
    }
    # host-side jobs: a plain CPU pod and the pipeline-wide image
    for filename, name, minutes, memory_mb, command in (
        ("99-compact-history-cronjob.yaml", "compact-history", 15, 1024,
         [*_CLI, "compact", "--store", store_path]),
        ("99-store-scrub-cronjob.yaml", "store-scrub", 45, 1024,
         [*_CLI, "fsck", "--store", store_path, "--repair", "--json"]),
        ("99-drift-gate-cronjob.yaml", "drift-gate", 30, 512,
         [*_CLI, "report", "--store", store_path, "--fail-on-drift", "--window", "7"]),
    ):
        host_stage = dataclasses.replace(
            first_stage, name=name, image=None, requirements=[],
            resources=ResourceSpec(cpu_request=0.25, memory_mb=memory_mb),
        )
        docs[filename] = _cronjob(
            spec, name, namespace, labels_base, _offset_schedule(daily_schedule, minutes), {
                # an empty store is a no-op for each of them (exit 0)
                "template": {"spec": _pod_spec(spec, host_stage, store, image, command,
                                               "Never", gate_on_deps=False)},
            })
    return docs


def write_manifests(spec: PipelineSpec, out_dir: str | Path, **kwargs) -> list[Path]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for filename, doc in generate_manifests(spec, **kwargs).items():
        path = out / filename
        path.write_text(_yaml.dump(doc))
        written.append(path)
    return written
