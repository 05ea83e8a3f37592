"""Kubernetes API schemas for the emitted manifest kinds (the port's
copy of ``bodywork_tpu.pipeline.k8s_schema``).

``pipeline.k8s_validate`` is a fast hand-rolled whitelist, written by
the same author as the generator, so a shared misunderstanding of the
k8s API passes both. This module is the independent second opinion:
JSON Schemas transcribed from the upstream Kubernetes API types
(apps/v1, batch/v1, core/v1, networking.k8s.io/v1, autoscaling/v2: the
same structures kubeconform validates against), authored from the API
documentation rather than from the generator or the whitelist. No
cluster or network is needed. The JAX package checks them with
``jsonschema``; the port runs on the standard library, numpy and torch
alone, so it checks them with :func:`check_schema`, its own
Draft-7 validator for the keywords these schemas use (``type``,
``properties``, ``additionalProperties``, ``required``, ``items``,
``enum``, ``const``, ``oneOf``, ``pattern``, ``maxLength``,
``minItems``, ``minimum``, ``maximum``), with ``jsonschema``'s paths and
messages. A schema with any other keyword is refused.

Schemas are STRICT (``additionalProperties: false``) at every level, so
a field the real API does not define fails here even if the whitelist's
mental model agrees with the generator's. On top of the pure structural
schemas, :func:`validate_against_k8s_schema` enforces the cross-field
rules the real API server enforces but JSON Schema cannot express
per-kind locally:

- a Job/CronJob pod template's ``restartPolicy`` must be ``Never`` or
  ``OnFailure`` (``Always`` is only valid for controllers that restart
  pods in place);
- a Deployment's ``selector.matchLabels`` must be a subset of its
  template's labels (the API server rejects the mismatch);
- a CronJob ``schedule`` must parse as 5 cron fields or a ``@``-macro.
"""
from __future__ import annotations

import re

__all__ = ["K8S_KIND_SCHEMAS", "check_schema", "validate_against_k8s_schema"]

# --------------------------------------------------------------------------
# shared fragments (core/v1 types)
# --------------------------------------------------------------------------

_STR = {"type": "string"}
_BOOL = {"type": "boolean"}
_INT = {"type": "integer"}
_STR_MAP = {"type": "object", "additionalProperties": {"type": "string"}}
#: resource.Quantity: "500m", "100Mi", "8", 4, 0.5 ...
_QUANTITY = {
    "oneOf": [
        {"type": "string",
         "pattern": r"^[+-]?([0-9]+|[0-9]+\.[0-9]*|\.[0-9]+)"
                    r"(m|k|Ki|Mi|Gi|Ti|Pi|Ei|K|M|G|T|P|E|n|u)?$"},
        {"type": "number"},
    ]
}
#: IntOrString (ports, maxSurge, targetPort...)
_INT_OR_STR = {"oneOf": [{"type": "integer"}, {"type": "string"}]}
_DNS1123_SUBDOMAIN = (
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)

_OBJECT_META = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "name": {"type": "string", "maxLength": 253,
                 "pattern": _DNS1123_SUBDOMAIN},
        "generateName": _STR,
        "namespace": {"type": "string", "maxLength": 63},
        "labels": _STR_MAP,
        "annotations": _STR_MAP,
        "finalizers": {"type": "array", "items": _STR},
        "ownerReferences": {"type": "array", "items": {"type": "object"}},
        # server-populated fields, legal to submit
        "uid": _STR, "resourceVersion": _STR, "generation": _INT,
        "creationTimestamp": {}, "deletionTimestamp": {},
        "deletionGracePeriodSeconds": _INT, "managedFields": {},
    },
}

_ENV_VAR = {
    "type": "object",
    "additionalProperties": False,
    "required": ["name"],
    "properties": {
        "name": _STR,
        "value": _STR,
        "valueFrom": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "fieldRef": {
                    "type": "object", "additionalProperties": False,
                    "required": ["fieldPath"],
                    "properties": {"apiVersion": _STR, "fieldPath": _STR},
                },
                "resourceFieldRef": {
                    "type": "object", "additionalProperties": False,
                    "required": ["resource"],
                    "properties": {"containerName": _STR, "resource": _STR,
                                   "divisor": _QUANTITY},
                },
                "configMapKeyRef": {
                    "type": "object", "additionalProperties": False,
                    "required": ["key"],
                    "properties": {"name": _STR, "key": _STR,
                                   "optional": _BOOL},
                },
                "secretKeyRef": {
                    "type": "object", "additionalProperties": False,
                    "required": ["key"],
                    "properties": {"name": _STR, "key": _STR,
                                   "optional": _BOOL},
                },
            },
        },
    },
}

_ENV_FROM = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "prefix": _STR,
        "configMapRef": {
            "type": "object", "additionalProperties": False,
            "properties": {"name": _STR, "optional": _BOOL},
        },
        "secretRef": {
            "type": "object", "additionalProperties": False,
            "properties": {"name": _STR, "optional": _BOOL},
        },
    },
}

_PROBE = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "httpGet": {
            "type": "object", "additionalProperties": False,
            "required": ["port"],
            "properties": {
                "path": _STR,
                "port": _INT_OR_STR,
                "host": _STR,
                "scheme": {"enum": ["HTTP", "HTTPS"]},
                "httpHeaders": {
                    "type": "array",
                    "items": {
                        "type": "object", "additionalProperties": False,
                        "required": ["name", "value"],
                        "properties": {"name": _STR, "value": _STR},
                    },
                },
            },
        },
        "exec": {
            "type": "object", "additionalProperties": False,
            "properties": {"command": {"type": "array", "items": _STR}},
        },
        "tcpSocket": {
            "type": "object", "additionalProperties": False,
            "required": ["port"],
            "properties": {"port": _INT_OR_STR, "host": _STR},
        },
        "grpc": {
            "type": "object", "additionalProperties": False,
            "required": ["port"],
            "properties": {"port": _INT, "service": _STR},
        },
        "initialDelaySeconds": _INT,
        "periodSeconds": _INT,
        "timeoutSeconds": _INT,
        "successThreshold": _INT,
        "failureThreshold": _INT,
        "terminationGracePeriodSeconds": _INT,
    },
}

_RESOURCES = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "limits": {"type": "object", "additionalProperties": _QUANTITY},
        "requests": {"type": "object", "additionalProperties": _QUANTITY},
        "claims": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "required": ["name"],
                "properties": {"name": _STR, "request": _STR},
            },
        },
    },
}

_CONTAINER = {
    "type": "object",
    "additionalProperties": False,
    "required": ["name"],
    "properties": {
        "name": {"type": "string", "maxLength": 63,
                 "pattern": r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$"},
        "image": _STR,
        "command": {"type": "array", "items": _STR},
        "args": {"type": "array", "items": _STR},
        "workingDir": _STR,
        "ports": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "required": ["containerPort"],
                "properties": {
                    "containerPort": {"type": "integer",
                                      "minimum": 1, "maximum": 65535},
                    "name": {"type": "string", "maxLength": 15},
                    "protocol": {"enum": ["TCP", "UDP", "SCTP"]},
                    "hostPort": _INT,
                    "hostIP": _STR,
                },
            },
        },
        "env": {"type": "array", "items": _ENV_VAR},
        "envFrom": {"type": "array", "items": _ENV_FROM},
        "resources": _RESOURCES,
        "volumeMounts": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "required": ["name", "mountPath"],
                "properties": {
                    "name": _STR, "mountPath": _STR, "subPath": _STR,
                    "subPathExpr": _STR, "readOnly": _BOOL,
                    "mountPropagation": {
                        "enum": ["None", "HostToContainer", "Bidirectional"]
                    },
                    "recursiveReadOnly": _STR,
                },
            },
        },
        "volumeDevices": {"type": "array", "items": {"type": "object"}},
        "livenessProbe": _PROBE,
        "readinessProbe": _PROBE,
        "startupProbe": _PROBE,
        "lifecycle": {"type": "object"},
        "terminationMessagePath": _STR,
        "terminationMessagePolicy": {
            "enum": ["File", "FallbackToLogsOnError"]
        },
        "imagePullPolicy": {"enum": ["Always", "Never", "IfNotPresent"]},
        "securityContext": {"type": "object"},
        "stdin": _BOOL, "stdinOnce": _BOOL, "tty": _BOOL,
        "restartPolicy": {"enum": ["Always"]},  # sidecar initContainers
        "resizePolicy": {"type": "array", "items": {"type": "object"}},
    },
}

_VOLUME = {
    "type": "object",
    "additionalProperties": False,
    "required": ["name"],
    "properties": {
        "name": _STR,
        "configMap": {
            "type": "object", "additionalProperties": False,
            "properties": {
                "name": _STR, "optional": _BOOL, "defaultMode": _INT,
                "items": {
                    "type": "array",
                    "items": {
                        "type": "object", "additionalProperties": False,
                        "required": ["key", "path"],
                        "properties": {"key": _STR, "path": _STR,
                                       "mode": _INT},
                    },
                },
            },
        },
        "secret": {
            "type": "object", "additionalProperties": False,
            "properties": {"secretName": _STR, "optional": _BOOL,
                           "defaultMode": _INT,
                           "items": {"type": "array"}},
        },
        "emptyDir": {
            "type": "object", "additionalProperties": False,
            "properties": {"medium": {"enum": ["", "Memory"]},
                           "sizeLimit": _QUANTITY},
        },
        "hostPath": {
            "type": "object", "additionalProperties": False,
            "required": ["path"],
            "properties": {
                "path": _STR,
                "type": {
                    "enum": ["", "DirectoryOrCreate", "Directory",
                             "FileOrCreate", "File", "Socket",
                             "CharDevice", "BlockDevice"]
                },
            },
        },
        "persistentVolumeClaim": {
            "type": "object", "additionalProperties": False,
            "required": ["claimName"],
            "properties": {"claimName": _STR, "readOnly": _BOOL},
        },
        "csi": {
            "type": "object", "additionalProperties": False,
            "required": ["driver"],
            "properties": {
                "driver": _STR, "readOnly": _BOOL, "fsType": _STR,
                "volumeAttributes": _STR_MAP,
                "nodePublishSecretRef": {"type": "object"},
            },
        },
        "downwardAPI": {"type": "object"},
        "projected": {"type": "object"},
        "nfs": {"type": "object"},
    },
}

_POD_SPEC = {
    "type": "object",
    "additionalProperties": False,
    "required": ["containers"],
    "properties": {
        "containers": {"type": "array", "minItems": 1, "items": _CONTAINER},
        "initContainers": {"type": "array", "items": _CONTAINER},
        "ephemeralContainers": {"type": "array"},
        "volumes": {"type": "array", "items": _VOLUME},
        "restartPolicy": {"enum": ["Always", "OnFailure", "Never"]},
        "terminationGracePeriodSeconds": _INT,
        "activeDeadlineSeconds": _INT,
        "dnsPolicy": {
            "enum": ["ClusterFirst", "ClusterFirstWithHostNet",
                     "Default", "None"]
        },
        "nodeSelector": _STR_MAP,
        "serviceAccountName": _STR,
        "serviceAccount": _STR,
        "automountServiceAccountToken": _BOOL,
        "nodeName": _STR,
        "hostNetwork": _BOOL, "hostPID": _BOOL, "hostIPC": _BOOL,
        "shareProcessNamespace": _BOOL,
        "securityContext": {"type": "object"},
        "imagePullSecrets": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "properties": {"name": _STR},
            },
        },
        "hostname": _STR,
        "subdomain": _STR,
        "affinity": {"type": "object"},
        "schedulerName": _STR,
        "tolerations": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "properties": {
                    "key": _STR,
                    "operator": {"enum": ["Exists", "Equal"]},
                    "value": _STR,
                    "effect": {"enum": ["NoSchedule", "PreferNoSchedule",
                                        "NoExecute"]},
                    "tolerationSeconds": _INT,
                },
            },
        },
        "hostAliases": {"type": "array"},
        "priorityClassName": _STR,
        "priority": _INT,
        "dnsConfig": {"type": "object"},
        "readinessGates": {"type": "array"},
        "runtimeClassName": _STR,
        "enableServiceLinks": _BOOL,
        "preemptionPolicy": {
            "enum": ["PreemptLowerPriority", "Never"]
        },
        "overhead": {"type": "object"},
        "topologySpreadConstraints": {"type": "array"},
        "setHostnameAsFQDN": _BOOL,
        "os": {"type": "object"},
        "hostUsers": _BOOL,
        "schedulingGates": {"type": "array"},
        "resourceClaims": {"type": "array"},
    },
}

_POD_TEMPLATE = {
    "type": "object",
    "additionalProperties": False,
    "properties": {"metadata": _OBJECT_META, "spec": _POD_SPEC},
    "required": ["spec"],
}

_LABEL_SELECTOR = {
    "type": "object",
    "additionalProperties": False,
    "properties": {
        "matchLabels": _STR_MAP,
        "matchExpressions": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "required": ["key", "operator"],
                "properties": {
                    "key": _STR,
                    "operator": {"enum": ["In", "NotIn", "Exists",
                                          "DoesNotExist"]},
                    "values": {"type": "array", "items": _STR},
                },
            },
        },
    },
}

_JOB_SPEC = {
    "type": "object",
    "additionalProperties": False,
    "required": ["template"],
    "properties": {
        "template": _POD_TEMPLATE,
        "parallelism": _INT,
        "completions": _INT,
        "activeDeadlineSeconds": _INT,
        "backoffLimit": _INT,
        "backoffLimitPerIndex": _INT,
        "maxFailedIndexes": _INT,
        "selector": _LABEL_SELECTOR,
        "manualSelector": _BOOL,
        "ttlSecondsAfterFinished": _INT,
        "completionMode": {"enum": ["NonIndexed", "Indexed"]},
        "suspend": _BOOL,
        "podFailurePolicy": {"type": "object"},
        "podReplacementPolicy": {
            "enum": ["TerminatingOrFailed", "Failed"]
        },
        "successPolicy": {"type": "object"},
    },
}


#: autoscaling/v2 MetricTarget: exactly one value form per target type
_HPA_METRIC_TARGET = {
    "type": "object", "additionalProperties": False,
    "required": ["type"],
    "properties": {
        "type": {"enum": ["Utilization", "Value", "AverageValue"]},
        "value": _QUANTITY,
        "averageValue": _QUANTITY,
        "averageUtilization": _INT,
    },
}

#: autoscaling/v2 HPAScalingRules (the behavior block's two arms)
_HPA_SCALING_RULES = {
    "type": "object", "additionalProperties": False,
    "properties": {
        "stabilizationWindowSeconds": _INT,
        "selectPolicy": {"enum": ["Max", "Min", "Disabled"]},
        "policies": {
            "type": "array",
            "items": {
                "type": "object", "additionalProperties": False,
                "required": ["type", "value", "periodSeconds"],
                "properties": {
                    "type": {"enum": ["Pods", "Percent"]},
                    "value": _INT,
                    "periodSeconds": _INT,
                },
            },
        },
        "tolerance": _QUANTITY,
    },
}


def _top(api_version: str, kind: str, spec, extra: dict | None = None,
         required: tuple = ("metadata",)) -> dict:
    props = {
        "apiVersion": {"const": api_version},
        "kind": {"const": kind},
        "metadata": _OBJECT_META,
    }
    if spec is not None:
        props["spec"] = spec
    props.update(extra or {})
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "type": "object",
        "additionalProperties": False,
        "required": ["apiVersion", "kind", *required],
        "properties": props,
    }


K8S_KIND_SCHEMAS: dict[str, dict] = {
    "Namespace": _top(
        "v1", "Namespace",
        {"type": "object", "additionalProperties": False,
         "properties": {"finalizers": {"type": "array", "items": _STR}}},
    ),
    "ConfigMap": _top(
        "v1", "ConfigMap", None,
        extra={
            "data": _STR_MAP,
            "binaryData": _STR_MAP,
            "immutable": _BOOL,
        },
    ),
    "PersistentVolumeClaim": _top(
        "v1", "PersistentVolumeClaim",
        {
            "type": "object", "additionalProperties": False,
            "properties": {
                "accessModes": {
                    "type": "array",
                    "items": {"enum": ["ReadWriteOnce", "ReadOnlyMany",
                                       "ReadWriteMany",
                                       "ReadWriteOncePod"]},
                },
                "selector": _LABEL_SELECTOR,
                "resources": {
                    "type": "object", "additionalProperties": False,
                    "properties": {
                        "requests": {"type": "object",
                                     "additionalProperties": _QUANTITY},
                        "limits": {"type": "object",
                                   "additionalProperties": _QUANTITY},
                    },
                },
                "volumeName": _STR,
                "storageClassName": _STR,
                "volumeMode": {"enum": ["Filesystem", "Block"]},
                "dataSource": {"type": "object"},
                "dataSourceRef": {"type": "object"},
                "volumeAttributesClassName": _STR,
            },
        },
    ),
    "Service": _top(
        "v1", "Service",
        {
            "type": "object", "additionalProperties": False,
            "properties": {
                "selector": _STR_MAP,
                "ports": {
                    "type": "array",
                    "items": {
                        "type": "object", "additionalProperties": False,
                        "required": ["port"],
                        "properties": {
                            "name": _STR,
                            "protocol": {"enum": ["TCP", "UDP", "SCTP"]},
                            "appProtocol": _STR,
                            "port": {"type": "integer",
                                     "minimum": 1, "maximum": 65535},
                            "targetPort": _INT_OR_STR,
                            "nodePort": _INT,
                        },
                    },
                },
                "clusterIP": _STR,
                "clusterIPs": {"type": "array", "items": _STR},
                "type": {"enum": ["ClusterIP", "NodePort", "LoadBalancer",
                                  "ExternalName"]},
                "externalIPs": {"type": "array", "items": _STR},
                "sessionAffinity": {"enum": ["None", "ClientIP"]},
                "loadBalancerIP": _STR,
                "loadBalancerSourceRanges": {"type": "array",
                                             "items": _STR},
                "externalName": _STR,
                "externalTrafficPolicy": {"enum": ["Cluster", "Local"]},
                "healthCheckNodePort": _INT,
                "publishNotReadyAddresses": _BOOL,
                "sessionAffinityConfig": {"type": "object"},
                "ipFamilies": {"type": "array",
                               "items": {"enum": ["IPv4", "IPv6"]}},
                "ipFamilyPolicy": {
                    "enum": ["SingleStack", "PreferDualStack",
                             "RequireDualStack"]
                },
                "allocateLoadBalancerNodePorts": _BOOL,
                "loadBalancerClass": _STR,
                "internalTrafficPolicy": {"enum": ["Cluster", "Local"]},
                "trafficDistribution": _STR,
            },
        },
    ),
    "Job": _top("batch/v1", "Job", _JOB_SPEC),
    "Deployment": _top(
        "apps/v1", "Deployment",
        {
            "type": "object", "additionalProperties": False,
            "required": ["selector", "template"],
            "properties": {
                "replicas": {"type": "integer", "minimum": 0},
                "selector": _LABEL_SELECTOR,
                "template": _POD_TEMPLATE,
                "strategy": {
                    "type": "object", "additionalProperties": False,
                    "properties": {
                        "type": {"enum": ["Recreate", "RollingUpdate"]},
                        "rollingUpdate": {
                            "type": "object",
                            "additionalProperties": False,
                            "properties": {"maxSurge": _INT_OR_STR,
                                           "maxUnavailable": _INT_OR_STR},
                        },
                    },
                },
                "minReadySeconds": _INT,
                "revisionHistoryLimit": _INT,
                "paused": _BOOL,
                "progressDeadlineSeconds": _INT,
            },
        },
    ),
    "Ingress": _top(
        "networking.k8s.io/v1", "Ingress",
        {
            "type": "object", "additionalProperties": False,
            "properties": {
                "ingressClassName": _STR,
                "defaultBackend": {"type": "object"},
                "tls": {"type": "array"},
                "rules": {
                    "type": "array",
                    "items": {
                        "type": "object", "additionalProperties": False,
                        "properties": {
                            "host": _STR,
                            "http": {
                                "type": "object",
                                "additionalProperties": False,
                                "required": ["paths"],
                                "properties": {
                                    "paths": {
                                        "type": "array",
                                        "minItems": 1,
                                        "items": {
                                            "type": "object",
                                            "additionalProperties": False,
                                            "required": ["pathType",
                                                         "backend"],
                                            "properties": {
                                                "path": _STR,
                                                "pathType": {
                                                    "enum": [
                                                        "Exact", "Prefix",
                                                        "ImplementationSpecific",
                                                    ]
                                                },
                                                "backend": {
                                                    "type": "object",
                                                    "additionalProperties": False,
                                                    "properties": {
                                                        "service": {
                                                            "type": "object",
                                                            "additionalProperties": False,
                                                            "required": ["name"],
                                                            "properties": {
                                                                "name": _STR,
                                                                "port": {
                                                                    "type": "object",
                                                                    "additionalProperties": False,
                                                                    "properties": {
                                                                        "name": _STR,
                                                                        "number": _INT,
                                                                    },
                                                                },
                                                            },
                                                        },
                                                        "resource": {
                                                            "type": "object"
                                                        },
                                                    },
                                                },
                                            },
                                        },
                                    }
                                },
                            },
                        },
                    },
                },
            },
        },
    ),
    "HorizontalPodAutoscaler": _top(
        "autoscaling/v2", "HorizontalPodAutoscaler",
        {
            "type": "object", "additionalProperties": False,
            "required": ["scaleTargetRef", "maxReplicas"],
            "properties": {
                "scaleTargetRef": {
                    "type": "object", "additionalProperties": False,
                    "required": ["apiVersion", "kind", "name"],
                    "properties": {
                        "apiVersion": _STR, "kind": _STR, "name": _STR,
                    },
                },
                "minReplicas": {"type": "integer", "minimum": 1},
                "maxReplicas": {"type": "integer", "minimum": 1},
                "metrics": {
                    "type": "array",
                    "items": {
                        "type": "object", "additionalProperties": False,
                        "required": ["type"],
                        "properties": {
                            "type": {"enum": ["Pods", "Resource", "Object",
                                              "External",
                                              "ContainerResource"]},
                            "pods": {
                                "type": "object",
                                "additionalProperties": False,
                                "required": ["metric", "target"],
                                "properties": {
                                    "metric": {
                                        "type": "object",
                                        "additionalProperties": False,
                                        "required": ["name"],
                                        "properties": {
                                            "name": _STR,
                                            "selector": _LABEL_SELECTOR,
                                        },
                                    },
                                    "target": _HPA_METRIC_TARGET,
                                },
                            },
                            "resource": {
                                "type": "object",
                                "additionalProperties": False,
                                "required": ["name", "target"],
                                "properties": {
                                    "name": _STR,
                                    "target": _HPA_METRIC_TARGET,
                                },
                            },
                            "object": {"type": "object"},
                            "external": {"type": "object"},
                            "containerResource": {"type": "object"},
                        },
                    },
                },
                "behavior": {
                    "type": "object", "additionalProperties": False,
                    "properties": {
                        "scaleUp": _HPA_SCALING_RULES,
                        "scaleDown": _HPA_SCALING_RULES,
                    },
                },
            },
        },
    ),
    "CronJob": _top(
        "batch/v1", "CronJob",
        {
            "type": "object", "additionalProperties": False,
            "required": ["schedule", "jobTemplate"],
            "properties": {
                "schedule": _STR,
                "timeZone": _STR,
                "startingDeadlineSeconds": _INT,
                "concurrencyPolicy": {"enum": ["Allow", "Forbid",
                                               "Replace"]},
                "suspend": _BOOL,
                "jobTemplate": {
                    "type": "object", "additionalProperties": False,
                    "properties": {"metadata": _OBJECT_META,
                                   "spec": _JOB_SPEC},
                },
                "successfulJobsHistoryLimit": _INT,
                "failedJobsHistoryLimit": _INT,
            },
        },
    ),
}

#: 5-field cron line or @-macro, the syntax batch/v1 accepts
# --------------------------------------------------------------------------
# the Draft-7 subset these schemas use
# --------------------------------------------------------------------------

_TYPES = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    "null": lambda v: v is None,
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: (isinstance(v, int) and not isinstance(v, bool))
    or (isinstance(v, float) and v.is_integer()),
}

#: keywords that carry no assertion
_ANNOTATIONS = {"$schema", "description", "title"}


def _equal(a, b) -> bool:
    """JSON equality: a bool never equals a number."""
    if isinstance(a, bool) or isinstance(b, bool):
        return type(a) is type(b) and a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _is_number(value) -> bool:
    return _TYPES["number"](value)


def check_schema(schema: dict, instance, path: tuple = ()):
    """Yield ``(path, message)`` for every way ``instance`` violates the
    Draft-7 ``schema``, in ``jsonschema.Draft7Validator.iter_errors``'s
    keyword order and with its messages. Raises ``ValueError`` on a
    keyword outside the subset, so a schema edit cannot be skipped
    silently."""
    for keyword, value in schema.items():
        if keyword in _ANNOTATIONS:
            continue
        if keyword == "type":
            types = value if isinstance(value, list) else [value]
            if not any(_TYPES[t](instance) for t in types):
                yield path, f"{instance!r} is not of type {', '.join(repr(t) for t in types)}"
        elif keyword == "properties":
            if isinstance(instance, dict):
                for name, sub in value.items():
                    if name in instance:
                        yield from check_schema(sub, instance[name], path + (name,))
        elif keyword == "additionalProperties":
            if isinstance(instance, dict):
                extras = [k for k in instance if k not in schema.get("properties", {})]
                if isinstance(value, dict):
                    for extra in extras:
                        yield from check_schema(value, instance[extra], path + (extra,))
                elif not value and extras:
                    extras = sorted(extras, key=str)
                    verb = "was" if len(extras) == 1 else "were"
                    yield path, ("Additional properties are not allowed "
                                 f"({', '.join(repr(e) for e in extras)} {verb} unexpected)")
        elif keyword == "required":
            if isinstance(instance, dict):
                for name in value:
                    if name not in instance:
                        yield path, f"{name!r} is a required property"
        elif keyword == "items":
            if isinstance(instance, list):
                for index, item in enumerate(instance):
                    yield from check_schema(value, item, path + (index,))
        elif keyword == "enum":
            if not any(_equal(instance, each) for each in value):
                yield path, f"{instance!r} is not one of {value!r}"
        elif keyword == "const":
            if not _equal(instance, value):
                yield path, f"{value!r} was expected"
        elif keyword == "oneOf":
            valid = [sub for sub in value if not any(True for _ in check_schema(sub, instance))]
            if not valid:
                yield path, f"{instance!r} is not valid under any of the given schemas"
            elif len(valid) > 1:
                reprs = ", ".join(repr(sub) for sub in [*valid[1:], valid[0]])
                yield path, f"{instance!r} is valid under each of {reprs}"
        elif keyword == "pattern":
            if isinstance(instance, str) and not re.search(value, instance):
                yield path, f"{instance!r} does not match {value!r}"
        elif keyword == "maxLength":
            if isinstance(instance, str) and len(instance) > value:
                yield path, (f"{instance!r} is expected to be empty" if value == 0
                             else f"{instance!r} is too long")
        elif keyword == "minItems":
            if isinstance(instance, list) and len(instance) < value:
                yield path, (f"{instance!r} should be non-empty" if value == 1
                             else f"{instance!r} is too short")
        elif keyword == "minimum":
            if _is_number(instance) and instance < value:
                yield path, f"{instance!r} is less than the minimum of {value!r}"
        elif keyword == "maximum":
            if _is_number(instance) and instance > value:
                yield path, f"{instance!r} is greater than the maximum of {value!r}"
        else:
            raise ValueError(f"schema keyword {keyword!r} is outside the validator's subset")


_CRON_RE = re.compile(
    r"^(@(annually|yearly|monthly|weekly|daily|midnight|hourly)"
    r"|(\S+\s+){4}\S+)$"
)


def _job_template_errors(job_spec: dict, where: str) -> list[str]:
    errors = []
    rp = (job_spec.get("template", {}).get("spec", {})
          .get("restartPolicy"))
    # the API server requires an explicit Never/OnFailure for Job pods
    if rp not in ("Never", "OnFailure"):
        errors.append(
            f"{where}.template.spec.restartPolicy must be 'Never' or "
            f"'OnFailure' for Job pods, got {rp!r}"
        )
    return errors


def validate_against_k8s_schema(doc: dict, origin: str = "<doc>") -> list[str]:
    """Validate one manifest against the vendored upstream-API schemas.
    Returns a list of error strings (empty = valid). Unknown kinds are an
    error: the generator must only emit kinds this layer can check."""
    kind = doc.get("kind")
    schema = K8S_KIND_SCHEMAS.get(kind)
    if schema is None:
        return [f"{origin}: kind {kind!r} has no vendored schema"]
    errors = [
        f"{origin}: {'.'.join(str(p) for p in path) or '<root>'}: {message}"
        for path, message in check_schema(schema, doc)
    ]

    # cross-field rules the API server enforces
    spec = doc.get("spec", {}) if isinstance(doc.get("spec"), dict) else {}
    if kind == "Job" and isinstance(spec, dict):
        errors += [f"{origin}: {m}"
                   for m in _job_template_errors(spec, "spec")]
    if kind == "CronJob" and isinstance(spec, dict):
        schedule = spec.get("schedule")
        if isinstance(schedule, str) and not _CRON_RE.match(schedule.strip()):
            errors.append(
                f"{origin}: spec.schedule {schedule!r} is not a 5-field "
                "cron line or @-macro"
            )
        jt = spec.get("jobTemplate", {}).get("spec")
        if isinstance(jt, dict):
            errors += [
                f"{origin}: {m}"
                for m in _job_template_errors(jt, "spec.jobTemplate.spec")
            ]
    if kind == "Deployment" and isinstance(spec, dict):
        match = (spec.get("selector") or {}).get("matchLabels") or {}
        tmpl_labels = ((spec.get("template") or {}).get("metadata") or {}
                       ).get("labels") or {}
        missing = {
            k: v for k, v in match.items() if tmpl_labels.get(k) != v
        }
        if missing:
            errors.append(
                f"{origin}: spec.selector.matchLabels {missing} not "
                "present in spec.template.metadata.labels — the API "
                "server rejects this Deployment"
            )
    return errors
