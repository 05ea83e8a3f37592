"""Strict structural validation of the emitted k8s manifests (the port's
copy of ``bodywork_tpu.pipeline.k8s_validate``).

The manifest generator (:mod:`bodywork_tpu_torch.pipeline.k8s`) is tested for
structure, but a structure test cannot catch a typo'd *field name* — k8s
object schemas treat unknown fields as errors only at ``kubectl apply``
(server-side validation), which is exactly the wrong time to find out.
This module is the CI-time stand-in for that server-side check: a strict
per-kind whitelist validator. Every mapping level the generator emits is
checked against the set of field names the k8s OpenAPI schema defines
there (the subset this framework can emit, plus common optional siblings),
and required fields are enforced. An unknown key — i.e. any misspelling —
fails validation.

This is deliberately NOT a vendored OpenAPI schema: the whitelists cover
the object kinds the generator emits (Namespace, ConfigMap,
PersistentVolumeClaim, Job, Deployment, Service, Ingress, CronJob) and
fail loudly on anything outside them, which is the correct behaviour for
a generator whose output surface is closed.
"""
from __future__ import annotations

from typing import Any

#: apiVersion each kind must carry (a wrong group/version also only fails
#: at apply time otherwise)
EXPECTED_API_VERSION = {
    "Namespace": "v1",
    "ConfigMap": "v1",
    "PersistentVolumeClaim": "v1",
    "Service": "v1",
    "Job": "batch/v1",
    "CronJob": "batch/v1",
    "Deployment": "apps/v1",
    "Ingress": "networking.k8s.io/v1",
    "HorizontalPodAutoscaler": "autoscaling/v2",
}


class ManifestError(ValueError):
    """One or more emitted manifests are structurally invalid."""


def _check(
    obj: Any,
    allowed: dict[str, Any],
    required: tuple[str, ...],
    path: str,
    errors: list[str],
) -> None:
    """Validate one mapping level: required keys present, no unknown keys,
    and recurse where the whitelist provides a sub-validator."""
    if not isinstance(obj, dict):
        errors.append(f"{path}: expected a mapping, got {type(obj).__name__}")
        return
    for key in required:
        if key not in obj:
            errors.append(f"{path}: missing required field {key!r}")
    for key, value in obj.items():
        if key not in allowed:
            errors.append(
                f"{path}: unknown field {key!r} (allowed: {sorted(allowed)})"
            )
            continue
        sub = allowed[key]
        if callable(sub):
            sub(value, f"{path}.{key}", errors)


def _scalar(value: Any, path: str, errors: list[str]) -> None:
    if isinstance(value, (dict, list)):
        errors.append(f"{path}: expected a scalar")


def _str_map(value: Any, path: str, errors: list[str]) -> None:
    if not isinstance(value, dict):
        errors.append(f"{path}: expected a mapping")
        return
    for k, v in value.items():
        if not isinstance(k, str):
            errors.append(f"{path}: non-string key {k!r}")
        if isinstance(v, (dict, list)):
            errors.append(f"{path}.{k}: expected a scalar value")


def _each(item_validator):
    def validate(value: Any, path: str, errors: list[str]) -> None:
        if not isinstance(value, list):
            errors.append(f"{path}: expected a list")
            return
        for i, item in enumerate(value):
            item_validator(item, f"{path}[{i}]", errors)

    return validate


def _mapping(allowed: dict[str, Any], required: tuple[str, ...] = ()):
    def validate(value: Any, path: str, errors: list[str]) -> None:
        _check(value, allowed, required, path, errors)

    return validate


_metadata = _mapping(
    {
        "name": _scalar,
        "namespace": _scalar,
        "labels": _str_map,
        "annotations": _str_map,
    },
    required=("name",),
)

_env_var = _mapping(
    {"name": _scalar, "value": _scalar},
    required=("name",),
)

_env_from = _mapping(
    {
        "secretRef": _mapping(
            {"name": _scalar, "optional": _scalar}, required=("name",)
        ),
        "configMapRef": _mapping(
            {"name": _scalar, "optional": _scalar}, required=("name",)
        ),
    },
)

_volume_mount = _mapping(
    {"name": _scalar, "mountPath": _scalar, "readOnly": _scalar,
     "subPath": _scalar},
    required=("name", "mountPath"),
)

_probe = _mapping(
    {
        "httpGet": _mapping(
            {"path": _scalar, "port": _scalar, "scheme": _scalar},
            required=("port",),
        ),
        "tcpSocket": _mapping({"port": _scalar}, required=("port",)),
        "exec": _mapping({"command": _each(_scalar)}, required=("command",)),
        "initialDelaySeconds": _scalar,
        "periodSeconds": _scalar,
        "timeoutSeconds": _scalar,
        "failureThreshold": _scalar,
        "successThreshold": _scalar,
    },
)

_container = _mapping(
    {
        "name": _scalar,
        "image": _scalar,
        "command": _each(_scalar),
        "args": _each(_scalar),
        "env": _each(_env_var),
        "envFrom": _each(_env_from),
        "volumeMounts": _each(_volume_mount),
        "resources": _mapping(
            {"requests": _str_map, "limits": _str_map},
        ),
        "ports": _each(
            _mapping(
                {"containerPort": _scalar, "name": _scalar, "protocol": _scalar},
                required=("containerPort",),
            )
        ),
        "readinessProbe": _probe,
        "livenessProbe": _probe,
        "workingDir": _scalar,
        "imagePullPolicy": _scalar,
    },
    required=("name", "image"),
)

_volume = _mapping(
    {
        "name": _scalar,
        "hostPath": _mapping(
            {"path": _scalar, "type": _scalar}, required=("path",)
        ),
        "persistentVolumeClaim": _mapping(
            {"claimName": _scalar, "readOnly": _scalar},
            required=("claimName",),
        ),
        "configMap": _mapping(
            {"name": _scalar, "items": _each(_mapping(
                {"key": _scalar, "path": _scalar}, required=("key", "path")
            ))},
            required=("name",),
        ),
        "emptyDir": _mapping({"medium": _scalar, "sizeLimit": _scalar}),
    },
    required=("name",),
)

_pod_spec = _mapping(
    {
        "containers": _each(_container),
        "initContainers": _each(_container),
        "volumes": _each(_volume),
        "restartPolicy": _scalar,
        "nodeSelector": _str_map,
        "subdomain": _scalar,
        "serviceAccountName": _scalar,
        "terminationGracePeriodSeconds": _scalar,
        "tolerations": _each(_mapping(
            {"key": _scalar, "operator": _scalar, "value": _scalar,
             "effect": _scalar},
        )),
    },
    required=("containers",),
)

_pod_template = _mapping(
    {
        "metadata": _mapping({"labels": _str_map, "annotations": _str_map}),
        "spec": _pod_spec,
    },
    required=("spec",),
)

_job_spec = _mapping(
    {
        "backoffLimit": _scalar,
        "activeDeadlineSeconds": _scalar,
        "completions": _scalar,
        "parallelism": _scalar,
        "completionMode": _scalar,
        "ttlSecondsAfterFinished": _scalar,
        "template": _pod_template,
    },
    required=("template",),
)

_hpa_metric_target = _mapping(
    {
        "type": _scalar,
        "value": _scalar,
        "averageValue": _scalar,
        "averageUtilization": _scalar,
    },
    required=("type",),
)

_hpa_scaling_rules = _mapping(
    {
        "stabilizationWindowSeconds": _scalar,
        "selectPolicy": _scalar,
        "policies": _each(_mapping(
            {"type": _scalar, "value": _scalar, "periodSeconds": _scalar},
            required=("type", "value", "periodSeconds"),
        )),
    },
)

_KIND_SPEC_VALIDATORS: dict[str, Any] = {
    "Namespace": _mapping({"metadata": _metadata}, required=("metadata",)),
    "ConfigMap": _mapping(
        {
            "metadata": _metadata,
            "data": _str_map,
            "binaryData": _str_map,
            "immutable": _scalar,
        },
        required=("metadata",),
    ),
    "PersistentVolumeClaim": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "accessModes": _each(_scalar),
                    "resources": _mapping(
                        {"requests": _str_map, "limits": _str_map},
                        required=("requests",),
                    ),
                    "storageClassName": _scalar,
                    "volumeMode": _scalar,
                },
                required=("accessModes", "resources"),
            ),
        },
        required=("metadata", "spec"),
    ),
    "Job": _mapping(
        {"metadata": _metadata, "spec": _job_spec},
        required=("metadata", "spec"),
    ),
    "Deployment": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "replicas": _scalar,
                    "selector": _mapping(
                        {"matchLabels": _str_map}, required=("matchLabels",)
                    ),
                    "template": _pod_template,
                    "strategy": _mapping(
                        {"type": _scalar, "rollingUpdate": _str_map},
                    ),
                },
                required=("selector", "template"),
            ),
        },
        required=("metadata", "spec"),
    ),
    "Service": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "selector": _str_map,
                    "ports": _each(
                        _mapping(
                            {
                                "port": _scalar,
                                "targetPort": _scalar,
                                "name": _scalar,
                                "protocol": _scalar,
                                "nodePort": _scalar,
                            },
                            required=("port",),
                        )
                    ),
                    "type": _scalar,
                    "clusterIP": _scalar,
                    "publishNotReadyAddresses": _scalar,
                },
                required=("ports",),
            ),
        },
        required=("metadata", "spec"),
    ),
    "Ingress": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "ingressClassName": _scalar,
                    "defaultBackend": _mapping(
                        {
                            "service": _mapping(
                                {
                                    "name": _scalar,
                                    "port": _mapping(
                                        {"number": _scalar, "name": _scalar},
                                    ),
                                },
                                required=("name",),
                            )
                        },
                    ),
                    "rules": _each(
                        _mapping(
                            {
                                "host": _scalar,
                                "http": _mapping(
                                    {
                                        "paths": _each(
                                            _mapping(
                                                {
                                                    "path": _scalar,
                                                    "pathType": _scalar,
                                                    "backend": _mapping(
                                                        {
                                                            "service": _mapping(
                                                                {
                                                                    "name": _scalar,
                                                                    "port": _mapping(
                                                                        {
                                                                            "number": _scalar,
                                                                            "name": _scalar,
                                                                        },
                                                                    ),
                                                                },
                                                                required=("name",),
                                                            )
                                                        },
                                                        required=("service",),
                                                    ),
                                                },
                                                required=("pathType", "backend"),
                                            )
                                        )
                                    },
                                    required=("paths",),
                                ),
                            },
                        )
                    ),
                    "tls": _each(_mapping(
                        {"hosts": _each(_scalar), "secretName": _scalar},
                    )),
                },
            ),
        },
        required=("metadata", "spec"),
    ),
    "HorizontalPodAutoscaler": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "scaleTargetRef": _mapping(
                        {"apiVersion": _scalar, "kind": _scalar,
                         "name": _scalar},
                        required=("apiVersion", "kind", "name"),
                    ),
                    "minReplicas": _scalar,
                    "maxReplicas": _scalar,
                    "metrics": _each(_mapping(
                        {
                            "type": _scalar,
                            "pods": _mapping(
                                {
                                    "metric": _mapping(
                                        {"name": _scalar},
                                        required=("name",),
                                    ),
                                    "target": _hpa_metric_target,
                                },
                                required=("metric", "target"),
                            ),
                            "resource": _mapping(
                                {"name": _scalar,
                                 "target": _hpa_metric_target},
                                required=("name", "target"),
                            ),
                        },
                        required=("type",),
                    )),
                    "behavior": _mapping(
                        {"scaleUp": _hpa_scaling_rules,
                         "scaleDown": _hpa_scaling_rules},
                    ),
                },
                required=("scaleTargetRef", "maxReplicas"),
            ),
        },
        required=("metadata", "spec"),
    ),
    "CronJob": _mapping(
        {
            "metadata": _metadata,
            "spec": _mapping(
                {
                    "schedule": _scalar,
                    "concurrencyPolicy": _scalar,
                    "startingDeadlineSeconds": _scalar,
                    "suspend": _scalar,
                    "successfulJobsHistoryLimit": _scalar,
                    "failedJobsHistoryLimit": _scalar,
                    "jobTemplate": _mapping(
                        {
                            "metadata": _mapping(
                                {"labels": _str_map, "annotations": _str_map}
                            ),
                            "spec": _job_spec,
                        },
                        required=("spec",),
                    ),
                },
                required=("schedule", "jobTemplate"),
            ),
        },
        required=("metadata", "spec"),
    ),
}


def validate_manifest(doc: dict, origin: str = "<manifest>") -> list[str]:
    """Validate one emitted k8s object; returns error strings (empty = ok)."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return [f"{origin}: manifest must be a mapping"]
    kind = doc.get("kind")
    if kind not in _KIND_SPEC_VALIDATORS:
        return [
            f"{origin}: unknown or missing kind {kind!r} "
            f"(validatable: {sorted(_KIND_SPEC_VALIDATORS)})"
        ]
    expected_version = EXPECTED_API_VERSION[kind]
    if doc.get("apiVersion") != expected_version:
        errors.append(
            f"{origin}: {kind} apiVersion must be {expected_version!r}, "
            f"got {doc.get('apiVersion')!r}"
        )
    body = {k: v for k, v in doc.items() if k not in ("apiVersion", "kind")}
    _KIND_SPEC_VALIDATORS[kind](body, f"{origin}:{kind}", errors)
    return errors


def validate_split_serving(docs: dict[str, dict]) -> list[str]:
    """Semantic checks for the cross-host disaggregated serving split
    (``--dispatcher`` Deployments emitted when a service stage declares
    the tcp row-queue transport): the generic whitelist/schema layers
    cannot see that the two Deployments and the dispatcher Service must
    agree with each other. Checks, per dispatcher Deployment: exactly
    one replica (the row-queue contract is N front-ends -> ONE scorer),
    a tcpSocket readiness probe (the dispatcher serves no HTTP), a
    dispatcher Service targeting the same app label on the probed port,
    a paired front-end Deployment running ``--role frontend`` with a
    ``--dispatcher-addr`` naming that Service, the serve env knobs
    materialised on the front-end container, and every HPA targeting
    the FRONT-END Deployment — autoscaling the singleton dispatcher
    would violate the one-scorer contract. Returns error strings.

    Replica rule: WITHOUT standby mode the dispatcher must
    run exactly 1 replica (two unfenced dispatchers would both bind
    and split the coalescer's row union); WITH standby declared
    (``--standby`` in the command or a truthy
    ``BODYWORK_TPU_SERVE_STANDBY`` env) up to 2 replicas are accepted —
    warm candidates arbitrated by the CAS lease, only the leader binds
    the probed port. More than 2 is refused either way: extra standbys
    buy no additional fault tolerance for their device cost."""
    errors: list[str] = []
    deployments = {
        doc["metadata"]["name"]: (filename, doc)
        for filename, doc in docs.items()
        if isinstance(doc, dict) and doc.get("kind") == "Deployment"
    }
    services = {
        doc["metadata"]["name"]: doc
        for filename, doc in docs.items()
        if isinstance(doc, dict) and doc.get("kind") == "Service"
    }
    hpa_targets = [
        (filename, doc["spec"]["scaleTargetRef"]["name"])
        for filename, doc in docs.items()
        if isinstance(doc, dict)
        and doc.get("kind") == "HorizontalPodAutoscaler"
    ]
    for name, (filename, doc) in deployments.items():
        if not name.endswith("--dispatcher"):
            continue
        spec = doc["spec"]
        container = spec["template"]["spec"]["containers"][0]
        env_values = {
            e.get("name"): str(e.get("value", ""))
            for e in container.get("env", [])
        }
        standby = "--standby" in container.get("command", []) or (
            env_values.get("BODYWORK_TPU_SERVE_STANDBY", "")
            .strip().lower() in ("1", "true", "yes", "on")
        )
        replicas = spec.get("replicas")
        if standby:
            if replicas not in (1, 2):
                errors.append(
                    f"{filename}: standby dispatcher Deployment {name!r} "
                    f"may run 1 or 2 replicas (the active/standby pair), "
                    f"got {replicas!r}"
                )
        elif replicas != 1:
            errors.append(
                f"{filename}: dispatcher Deployment {name!r} must run "
                f"exactly 1 replica without standby mode (scale needs "
                f"--standby: lease-fenced leadership, one serving "
                f"leader), got {replicas!r}"
            )
        probe = container.get("readinessProbe", {})
        if "tcpSocket" not in probe:
            errors.append(
                f"{filename}: dispatcher Deployment {name!r} needs a "
                "tcpSocket readinessProbe (it serves no HTTP)"
            )
        port = probe.get("tcpSocket", {}).get("port")
        svc = services.get(name)
        if svc is None:
            errors.append(
                f"{filename}: dispatcher Deployment {name!r} has no "
                "matching Service (front-ends resolve the dispatcher "
                "through it)"
            )
        else:
            app = doc["metadata"]["labels"].get("app")
            if svc["spec"].get("selector", {}).get("app") != app:
                errors.append(
                    f"{filename}: dispatcher Service {name!r} selector "
                    f"does not target app={app!r}"
                )
            svc_ports = [p.get("port") for p in svc["spec"].get("ports", [])]
            if port is not None and port not in svc_ports:
                errors.append(
                    f"{filename}: dispatcher Service {name!r} ports "
                    f"{svc_ports} do not include the probed row-queue "
                    f"port {port}"
                )
        for target in ("--role", "dispatcher"):
            if target not in container.get("command", []):
                errors.append(
                    f"{filename}: dispatcher Deployment {name!r} command "
                    f"must run `cli serve --role dispatcher` "
                    f"(missing {target!r})"
                )
        # the paired front-end Deployment keeps the stage's standard
        # name (= this name minus the suffix) so Service/Ingress/HPA
        # keep targeting it
        fe_name = name[: -len("--dispatcher")]
        fe = deployments.get(fe_name)
        if fe is None:
            errors.append(
                f"{filename}: dispatcher {name!r} has no paired "
                f"front-end Deployment {fe_name!r}"
            )
        else:
            fe_filename, fe_doc = fe
            fe_container = (
                fe_doc["spec"]["template"]["spec"]["containers"][0]
            )
            fe_cmd = fe_container.get("command", [])
            if "frontend" not in fe_cmd or "--role" not in fe_cmd:
                errors.append(
                    f"{fe_filename}: front-end Deployment {fe_name!r} "
                    "command must run `cli serve --role frontend`"
                )
            addr = None
            for flag, value in zip(fe_cmd, fe_cmd[1:]):
                if flag == "--dispatcher-addr":
                    addr = value
            if addr is None or not addr.startswith(f"{name}:"):
                errors.append(
                    f"{fe_filename}: front-end Deployment {fe_name!r} "
                    f"--dispatcher-addr {addr!r} does not name the "
                    f"dispatcher Service {name!r}"
                )
            env_names = {
                e.get("name") for e in fe_container.get("env", [])
            }
            for knob in ("BODYWORK_TPU_SERVE_TRANSPORT",
                         "BODYWORK_TPU_SERVER_ENGINE",
                         "BODYWORK_TPU_FRONTENDS",
                         "BODYWORK_TPU_MAX_PENDING"):
                if knob not in env_names:
                    errors.append(
                        f"{fe_filename}: front-end Deployment "
                        f"{fe_name!r} must materialise the {knob} env "
                        "knob"
                    )
        for hpa_filename, target in hpa_targets:
            if target == name:
                errors.append(
                    f"{hpa_filename}: HPA must target the front-end "
                    f"Deployment, not the singleton dispatcher {name!r}"
                )
    return errors


def validate_manifests(docs: dict[str, dict]) -> None:
    """Validate every generated manifest; raise :class:`ManifestError`
    listing ALL problems (not just the first) on any failure.

    Two independent layers run on every emit: this module's fast
    whitelist (unknown-field typo class) AND the vendored upstream-API
    schemas (``pipeline.k8s_schema`` — types, required fields, enums,
    and the cross-field rules the API server enforces). The second layer
    exists because the whitelist shares its author's mental model with
    the generator; the schemas are transcribed from the Kubernetes API
    types instead."""
    from bodywork_tpu_torch.pipeline.k8s_schema import validate_against_k8s_schema

    errors: list[str] = []
    for filename, doc in docs.items():
        errors.extend(validate_manifest(doc, filename))
        if isinstance(doc, dict):
            errors.extend(validate_against_k8s_schema(doc, filename))
    errors.extend(validate_split_serving(docs))
    if errors:
        raise ManifestError(
            "invalid generated manifests:\n  " + "\n  ".join(errors)
        )
