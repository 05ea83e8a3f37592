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

A stage's ``BODYWORK_TPU_TENANT`` is emitted as the JAX generator emits
it: the pod's commands scope their store to that tenant. A service stage
that declares ``BODYWORK_TPU_SERVE_TRANSPORT=tcp`` splits, as the JAX
generator splits it, into two Deployments: torch-free front ends (``cli
serve --role frontend``, no GPU) and one device-owning dispatcher (``cli
serve --role dispatcher``, the stage's GPU) behind its own ``rowqueue``
Service; ``BODYWORK_TPU_SERVE_STANDBY`` scales the dispatcher to the
active/standby pair. The serve Deployment's HPA scales the front ends on
the row-queue's ``bodywork_tpu_rowqueue`` metrics. The serving mesh
knobs (``BODYWORK_TPU_MESH_DATA`` / ``_MODEL``) ride the serve container's
env. A batch stage with ``gpu_hosts`` > 1 is an Indexed Job of one pod a
host, as the JAX generator's ``tpu_hosts``: a headless Service makes pod
0 the coordinator that ``parallel.multihost_init`` joins
(``JAX_COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and the pod's
``JOB_COMPLETION_INDEX``).

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
from bodywork_tpu_torch.utils.compile_cache import ENV_VAR as COMPILE_CACHE_ENV
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline.k8s")

_STORE_VOLUME = "artefact-store"
_SPEC_VOLUME = "pipeline-spec"
_SPEC_MOUNT = "/etc/bodywork"
_SPEC_FILE = "pipeline.yaml"
_DEFAULT_IMAGE = "bodywork-tpu/runtime:latest"
_CLI = ["python", "-m", "bodywork_tpu_torch.cli"]

STORE_VOLUME_MODES = ("auto", "pvc", "hostpath", "gcs")

DEFAULT_DAILY_SCHEDULE = "0 6 * * *"

#: the coordinator port of a multi-host stage's headless Service
_COORDINATOR_PORT = 8476


def _refuse_multihost_services(spec: PipelineSpec) -> None:
    for stage in spec.stages.values():
        if stage.kind == "service" and stage.resources.gpu_hosts > 1:
            # a single-host Deployment would defer the misconfiguration to
            # runtime (a model sharded for N hosts cannot fit one host)
            raise ValueError(
                f"stage {stage.name!r}: gpu_hosts > 1 is only supported for batch "
                "stages (Indexed Jobs); multi-host serving Deployments are not "
                "materialisable"
            )


def _make_indexed(job_spec: dict, stage: StageSpec, meta: dict, labels: dict) -> dict:
    """Turn a batch stage's Job spec into the multi-host Indexed Job (one
    pod a host, pod 0 the coordinator) and return its headless Service."""
    n_hosts = stage.resources.gpu_hosts
    # one worker's failure takes down every pod of the group, so a logical
    # retry costs n pod failures: scale the budget
    job_spec["backoffLimit"] = stage.retries * n_hosts
    job_name = meta["name"]
    job_spec["completions"] = n_hosts
    job_spec["parallelism"] = n_hosts
    job_spec["completionMode"] = "Indexed"
    pod = job_spec["template"]["spec"]
    pod["subdomain"] = job_name
    pod["containers"][0].setdefault("env", []).extend([
        {"name": "JAX_COORDINATOR_ADDRESS",
         "value": f"{job_name}-0.{job_name}:{_COORDINATOR_PORT}"},
        # with the pod's JOB_COMPLETION_INDEX: the whole topology, explicit
        {"name": "NUM_PROCESSES", "value": str(n_hosts)},
    ])
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": meta,
        "spec": {
            "clusterIP": "None",
            # per-pod DNS before readiness, or workers racing ahead of pod
            # 0 fail to resolve the coordinator at start-up
            "publishNotReadyAddresses": True,
            "selector": {"app": labels["app"]},
            "ports": [{"port": _COORDINATOR_PORT, "name": "jax-coord"}],
        },
    }


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
    if store.mode != "gcs" and COMPILE_CACHE_ENV not in stage.env:
        # the kernel-library cache on the shared store volume: a one-shot
        # daily pod whose image lacks the prebuilt libraries (or whose
        # package directory is read-only) would run nvcc again otherwise.
        # Dotted dir: invisible to the store's prefix/date-key listings.
        # gcs mode is skipped: nvcc writes to a filesystem
        env.append({"name": COMPILE_CACHE_ENV, "value": f"{store.store_path}/.kernel-cache"})
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
                image: str, command: list[str], meta: dict, labels: dict,
                store_path: str) -> dict:
    """The service stage's Deployment, Service, HPA and (with
    ``ingress``) Ingress; a stage declaring the tcp row-queue transport
    splits into front ends and a dispatcher (:func:`_dispatcher_docs`)."""
    from bodywork_tpu_torch.serve.netqueue import DEFAULT_DISPATCHER_PORT

    # cross-host disaggregated serving (serve.netqueue): both halves run
    # `cli serve` with an explicit --role (the in-process run-stage
    # entrypoint cannot run either half of a process fleet); the front
    # ends keep the stage's name, so its Service/Ingress/HPA target them
    split = str(stage.env.get("BODYWORK_TPU_SERVE_TRANSPORT", "")).strip() == "tcp"
    dispatcher_dns = f"{meta['name']}--dispatcher"
    if split:
        command = [*_CLI, "serve", "--store", store_path, "--host", "0.0.0.0",
                   "--port", str(stage.port), "--role", "frontend", "--transport", "tcp",
                   "--dispatcher-addr", f"{dispatcher_dns}:{DEFAULT_DISPATCHER_PORT}"]
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
    if split:
        fe_pod = docs[f"{i:02d}-{stage.name}-deployment.yaml"]["spec"]["template"]["spec"]
        # the front ends are torch-free parse/admission processes: the
        # stage's card belongs to the dispatcher alone
        fe_pod["containers"][0]["resources"].pop("limits", None)
        fe_pod.pop("nodeSelector", None)
        docs.update(_dispatcher_docs(i, spec, stage, store, image, meta, labels,
                                     store_path, dispatcher_dns))
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
    # queue-pressure autoscaling on the row-queue's own saturation signals,
    # the JAX generator's HPA: occupancy ~1.0 means the slot pool (not
    # admission) is the backpressure boundary, and the wait p90 is the
    # whole front-end -> dispatcher rendezvous a request pays (Pods
    # metrics through the Prometheus adapter reading the per-pod scrape)
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


def _dispatcher_docs(i: int, spec: PipelineSpec, stage: StageSpec, store: _StoreMedium,
                     image: str, meta: dict, labels: dict, store_path: str,
                     dispatcher_dns: str) -> dict:
    """The split serve stage's dispatcher Deployment and its ``rowqueue``
    Service: ONE serving dispatcher (the row-queue contract is N front
    ends -> one scorer), or under ``BODYWORK_TPU_SERVE_STANDBY`` two pods
    of warm candidates arbitrated by the CAS lease, only the leader bound
    to the probed port (the one scaled shape ``k8s_validate`` accepts)."""
    from bodywork_tpu_torch.serve.netqueue import DEFAULT_DISPATCHER_PORT

    standby = str(stage.env.get("BODYWORK_TPU_SERVE_STANDBY", "")).strip().lower() in (
        "1", "true", "yes", "on")
    dlabels = {**{k: v for k, v in labels.items() if k != "app"}, "app": dispatcher_dns}
    dmeta = {"name": dispatcher_dns, "namespace": meta["namespace"], "labels": dlabels}
    dispatcher_cmd = [*_CLI, "serve", "--store", store_path, "--role", "dispatcher",
                      "--transport", "tcp", "--dispatcher-addr",
                      f"0.0.0.0:{DEFAULT_DISPATCHER_PORT}"]
    if standby:
        dispatcher_cmd.append("--standby")
    dpod = _pod_spec(spec, stage, store, image, dispatcher_cmd, "Always")
    dcontainer = dpod["containers"][0]
    dcontainer["name"] = f"{stage.name}-dispatcher"
    # the dispatcher serves the socket row-queue, not HTTP: readiness is
    # "the listener accepts" (it binds only once its model is loaded and
    # its graphs captured), probed at the TCP layer
    dcontainer["ports"] = [{"containerPort": DEFAULT_DISPATCHER_PORT, "name": "rowqueue"}]
    dcontainer["readinessProbe"] = {
        "tcpSocket": {"port": DEFAULT_DISPATCHER_PORT},
        "initialDelaySeconds": 2,
        "periodSeconds": 3,
        "failureThreshold": int(stage.max_startup_time_s // 3) or 1,
        "timeoutSeconds": 2,
    }
    return {
        f"{i:02d}-{stage.name}-dispatcher-deployment.yaml": {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": dmeta,
            "spec": {
                "replicas": 2 if standby else 1,
                "selector": {"matchLabels": {"app": dispatcher_dns}},
                "template": {
                    "metadata": {"labels": dlabels},
                    "spec": {**dpod, "terminationGracePeriodSeconds": 30},
                },
            },
        },
        f"{i:02d}-{stage.name}-dispatcher-service.yaml": {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": dmeta,
            "spec": {
                "selector": {"app": dispatcher_dns},
                "ports": [{"port": DEFAULT_DISPATCHER_PORT,
                           "targetPort": DEFAULT_DISPATCHER_PORT, "name": "rowqueue"}],
                "type": "ClusterIP",
            },
        },
    }


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
    default class. A service stage with ``gpu_hosts`` > 1 raises
    ``ValueError``; so does an explicit ``daily_schedule`` for a spec
    with a multi-host stage (one CronJob pod cannot drive the hosts), and
    the default one is left out with a warning."""
    _refuse_multihost_services(spec)
    multihost = any(s.resources.gpu_hosts > 1 for s in spec.stages.values())
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
                job_spec = {
                    "backoffLimit": stage.retries,
                    "activeDeadlineSeconds": int(stage.max_completion_time_s),
                    "template": {
                        "metadata": {"labels": labels},
                        "spec": _pod_spec(spec, stage, store, image, command, "Never"),
                    },
                }
                if stage.resources.gpu_hosts > 1:
                    docs[f"{i:02d}-{stage.name}-workers-headless.yaml"] = _make_indexed(
                        job_spec, stage, meta, labels)
                docs[f"{i:02d}-{stage.name}-job.yaml"] = {
                    "apiVersion": "batch/v1",
                    "kind": "Job",
                    "metadata": meta,
                    "spec": job_spec,
                }
            else:
                docs.update(_serve_docs(i, spec, stage, store, image, command, meta, labels,
                                        store_path))
    if daily_schedule and multihost:
        # run-day in ONE CronJob pod cannot drive a multi-host stage; the
        # daily loop of such a spec is re-applying the per-stage Jobs
        if daily_schedule is not DEFAULT_DAILY_SCHEDULE:
            raise ValueError(
                "daily_schedule is not materialisable for a spec with multi-host "
                "stages (gpu_hosts > 1): a single CronJob pod cannot drive them; pass "
                "daily_schedule=None and schedule re-application of the per-stage "
                "Jobs instead"
            )
        log.warning("daily-loop CronJob omitted: spec has multi-host stages "
                    "(gpu_hosts > 1); schedule re-application of the per-stage Jobs "
                    "instead")
    elif daily_schedule:
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
