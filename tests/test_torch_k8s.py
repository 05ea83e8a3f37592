"""The port's k8s manifests (``bodywork_tpu_torch.pipeline.k8s``), its two
validator layers and the stage pods' measured import closures, against
the JAX package's generator and tests.

The parity mapping: the port's ``generate_manifests(spec)`` equals the
JAX package's for the same spec shape once exactly these differences are
mapped: ``bodywork_tpu.cli`` -> ``bodywork_tpu_torch.cli`` in commands,
the TPU limit and nodeSelectors -> the GPU ones, the two ``JAX_*`` env
entries dropped, and the ConfigMap text and derived image tags (which
follow the spec and the pins). Any other difference is a fault."""
from __future__ import annotations

import copy
import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from bodywork_tpu_torch.pipeline import (
    ManifestError,
    PipelineSpec,
    default_pipeline,
    generate_manifests,
    validate_manifest,
    validate_manifests,
    write_manifests,
)
from bodywork_tpu_torch.pipeline.k8s_schema import (
    K8S_KIND_SCHEMAS,
    check_schema,
    validate_against_k8s_schema,
)

ROOT = Path(__file__).resolve().parents[1]
_TAG = re.compile(r"-(stage-[1-4]-[a-z-]+):[0-9a-f]{12}$")
#: the JAX generator's XLA compile-cache pair -> the port's one kernel-cache
#: entry (the store path's dotted directory, under the port's variable)
_JAX_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"
_JAX_CACHE_FLOOR = "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"


def _containers(doc):
    """Every container and initContainer of a workload document."""
    spec = doc.get("spec", {})
    if doc["kind"] == "CronJob":
        spec = spec["jobTemplate"]["spec"]
    pod = spec.get("template", {}).get("spec")
    if not pod:
        return []
    return [*pod.get("initContainers", []), *pod["containers"]]


def _pod(doc):
    spec = doc["spec"]
    if doc["kind"] == "CronJob":
        spec = spec["jobTemplate"]["spec"]
    return spec["template"]["spec"]


def _map_jax(docs: dict) -> dict:
    """The JAX generator's output under the parity mapping."""
    docs = copy.deepcopy(docs)
    for doc in docs.values():
        if doc["kind"] == "ConfigMap":
            doc["data"]["pipeline.yaml"] = "<spec text>"
        for c in _containers(doc):
            c["command"] = [a.replace("bodywork_tpu.cli", "bodywork_tpu_torch.cli")
                            for a in c["command"]]
            c["image"] = _TAG.sub(r"-\1:<digest>", c["image"])
            limits = c.get("resources", {}).get("limits")
            if limits is not None:
                c["resources"]["limits"] = {"nvidia.com/gpu": limits.pop("google.com/tpu")}
                assert not limits
            if "env" in c:
                c["env"] = [
                    {"name": "BODYWORK_TPU_COMPILE_CACHE",
                     "value": e["value"].removesuffix("/.xla-cache") + "/.kernel-cache"}
                    if e["name"] == _JAX_CACHE_DIR else e
                    for e in c["env"] if e["name"] != _JAX_CACHE_FLOOR
                ]
        if doc["kind"] in ("Job", "Deployment", "CronJob") and "nodeSelector" in _pod(doc):
            _pod(doc)["nodeSelector"] = {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    return docs


def _mask_port(docs: dict) -> dict:
    docs = copy.deepcopy(docs)
    for doc in docs.values():
        if doc["kind"] == "ConfigMap":
            doc["data"]["pipeline.yaml"] = "<spec text>"
        for c in _containers(doc):
            c["image"] = _TAG.sub(r"-\1:<digest>", c["image"])
    return docs


def _dump_all(docs: dict) -> dict:
    return {name: yaml.safe_dump(doc, sort_keys=False) for name, doc in docs.items()}


_SHAPES = [
    dict(store_path="/mnt/artefact-store", store_volume="pvc"),
    dict(store_path="/mnt/artefact-store", store_volume="hostpath"),
    dict(store_path="gs://bucket/prefix", store_volume="gcs"),
    dict(store_path="/mnt/store", storage_class=None, pvc_size="50Gi"),
]


@pytest.mark.parametrize("shape", _SHAPES, ids=["pvc", "hostpath", "gcs", "pvc-default-class"])
@pytest.mark.parametrize("daily", [True, False], ids=["daily", "no-daily"])
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("model_mode", [("linear", "batch"), ("mlp", "single")],
                         ids=["linear-batch", "mlp-single"])
def test_manifests_equal_the_jax_generators_under_the_mapping(shape, daily, overlap,
                                                              model_mode):
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.pipeline import generate_manifests as jax_manifests

    kw = dict(shape, image="registry.example/bodywork:v3")
    if not daily:
        kw["daily_schedule"] = None
    spec = default_pipeline(*model_mode, overlap_generate=overlap)
    port = generate_manifests(spec, **kw)
    jax = jax_manifests(jax_pipeline(*model_mode, overlap_generate=overlap), **kw)
    assert list(port) == list(jax)
    mapped, masked = _map_jax(jax), _mask_port(port)
    assert masked == mapped
    # the same bytes on disk, key order and anchors included
    assert _dump_all(masked) == _dump_all(mapped)
    # what the mapping masked: the ConfigMap is the port's spec, and each
    # derived tag is the port's own
    from bodywork_tpu_torch.pipeline.images import stage_image_tag

    assert port["00-pipeline-spec-configmap.yaml"]["data"]["pipeline.yaml"] == spec.to_yaml()
    for name, stage in spec.stages.items():
        for doc in port.values():
            for c in _containers(doc):
                if c["name"] in (name, "wait-for-deps") and f"-{name}:" in c["image"]:
                    assert c["image"] == stage_image_tag(stage, kw["image"])


@functools.lru_cache(maxsize=1)
def _all_docs():
    docs = {}
    for mode, path in (("pvc", "/mnt/artefact-store"), ("hostpath", "/mnt/artefact-store"),
                       ("gcs", "gs://bucket/prefix")):
        docs.update({f"{mode}:{name}": doc for name, doc in generate_manifests(
            default_pipeline(), store_path=path, store_volume=mode).items()})
    return docs


def test_every_emitted_manifest_passes_both_layers():
    docs = _all_docs()
    assert {d["kind"] for d in docs.values()} <= set(K8S_KIND_SCHEMAS)
    for name, doc in docs.items():
        assert validate_manifest(doc, name) == []
        assert validate_against_k8s_schema(doc, name) == [], name


def _doc_of_kind(kind):
    for doc in _all_docs().values():
        if doc["kind"] == kind:
            return copy.deepcopy(doc)
    raise AssertionError(f"no emitted {kind}")


def _set_path(doc, path, value):
    node = doc
    for p in path[:-1]:
        node = node[p]
    if value is ...:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return doc


_MUTATIONS = [
    ("Deployment", ("spec", "selector"), ..., "Deployment.spec.selector is required"),
    ("Deployment", ("spec", "replicas"), "2", "replicas is an integer, not a string"),
    ("Deployment", ("spec", "selector", "matchLabels"), {"app": "other"},
     "selector must match template labels (API server rule)"),
    ("Deployment", ("spec", "template", "spec", "restartPolicy"), "Sometimes",
     "restartPolicy is an enum"),
    ("Deployment", ("spec", "template", "spec", "containers", 0, "imagePullPolicy"),
     "WhenAbsent", "imagePullPolicy enum is Always/Never/IfNotPresent"),
    ("Job", ("spec", "template", "spec", "restartPolicy"), "Always",
     "Job pods must be Never/OnFailure (API server rule)"),
    ("Job", ("spec", "backoffLimit"), 2.5, "backoffLimit is an integer"),
    ("Job", ("spec", "template"), ..., "Job.spec.template is required"),
    ("CronJob", ("spec", "schedule"), "soonish", "schedule must be 5 cron fields or an @-macro"),
    ("CronJob", ("spec", "concurrencyPolicy"), "Serialize",
     "concurrencyPolicy enum is Allow/Forbid/Replace"),
    ("Service", ("spec", "ports", 0, "port"), 70000, "port must be 1-65535"),
    ("Service", ("spec", "type"), "Cluster", "Service type enum"),
    ("PersistentVolumeClaim", ("spec", "accessModes"), ["ReadWrite"], "accessModes enum"),
    ("PersistentVolumeClaim", ("spec", "resources", "requests", "storage"), "10 gigs",
     "storage is a resource.Quantity"),
    ("ConfigMap", ("data",), {"k": 42}, "ConfigMap.data values are strings"),
    ("Namespace", ("metadata", "name"), "Bad_Name", "names are DNS-1123 subdomains"),
    ("Job", ("spec", "template", "spec", "containers", 0, "resources", "limits",
             "nvidia.com/gpu"), "one", "a GPU limit is a resource.Quantity"),
]


@pytest.mark.parametrize("kind,path,value,rule", _MUTATIONS, ids=[m[3] for m in _MUTATIONS])
def test_schema_layer_rejects_real_api_violations(kind, path, value, rule):
    doc = _set_path(_doc_of_kind(kind), path, value)
    errors = validate_against_k8s_schema(doc, "mutated")
    assert errors, f"schema layer missed: {rule}"


@pytest.mark.parametrize("kind,path,value,rule", _MUTATIONS, ids=[m[3] for m in _MUTATIONS])
def test_the_ports_schema_checker_reports_what_jsonschema_reports(kind, path, value, rule):
    """The port's Draft-7 subset validator (no jsonschema on the card's
    machine) against ``jsonschema.Draft7Validator`` on the same schema and
    document: the same paths and messages."""
    import jsonschema

    doc = _set_path(_doc_of_kind(kind), path, value)
    schema = K8S_KIND_SCHEMAS[kind]
    want = sorted((tuple(e.absolute_path), e.message)
                  for e in jsonschema.Draft7Validator(schema).iter_errors(doc))
    got = sorted(check_schema(schema, doc))
    assert got == want


def test_the_schemas_are_the_jax_packages():
    from bodywork_tpu.pipeline.k8s_schema import K8S_KIND_SCHEMAS as JAX_SCHEMAS

    assert K8S_KIND_SCHEMAS == JAX_SCHEMAS


def test_ingress_path_type_required():
    spec = default_pipeline()
    for s in spec.stages.values():
        if s.kind == "service":
            s.ingress = True
    docs = generate_manifests(spec, store_path="/mnt/store", store_volume="pvc")
    ing = next(d for d in docs.values() if d["kind"] == "Ingress")
    assert validate_against_k8s_schema(ing, "ingress") == []
    del ing["spec"]["rules"][0]["http"]["paths"][0]["pathType"]
    assert validate_against_k8s_schema(ing, "ingress")


def test_unknown_field_rejected_everywhere():
    for kind in ("Deployment", "Job", "Service"):
        doc = _doc_of_kind(kind)
        doc["spec"]["replicaCount"] = 2
        assert validate_against_k8s_schema(doc, kind)


def test_unknown_kind_is_an_error():
    assert validate_against_k8s_schema(
        {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "x"}})


def test_the_schema_checker_refuses_a_keyword_outside_its_subset():
    with pytest.raises(ValueError, match="anyOf"):
        list(check_schema({"anyOf": [{"type": "string"}]}, "x"))


def test_manifests_structure(tmp_path):
    spec = default_pipeline()
    docs = generate_manifests(spec, store_path="/mnt/store")
    kinds: dict = {}
    for doc in docs.values():
        kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
    assert kinds == {
        "Namespace": 1, "ConfigMap": 1, "PersistentVolumeClaim": 1,
        "Job": 3, "Deployment": 1, "Service": 1, "CronJob": 4,
        "HorizontalPodAutoscaler": 1,
    }
    cli = ["python", "-m", "bodywork_tpu_torch.cli"]
    for filename, tail, schedule in (
        ("99-drift-gate-cronjob.yaml",
         ["report", "--store", "/mnt/store", "--fail-on-drift", "--window", "7"], "30 6 * * *"),
        ("99-compact-history-cronjob.yaml", ["compact", "--store", "/mnt/store"], "15 6 * * *"),
        ("99-store-scrub-cronjob.yaml",
         ["fsck", "--store", "/mnt/store", "--repair", "--json"], "45 6 * * *"),
    ):
        cron = docs[filename]
        assert _pod(cron)["containers"][0]["command"] == [*cli, *tail]
        assert cron["spec"]["schedule"] == schedule
        assert cron["spec"]["concurrencyPolicy"] == "Forbid"
        assert "nodeSelector" not in _pod(cron)
        assert "limits" not in _pod(cron)["containers"][0]["resources"]
    day = docs["99-daily-loop-cronjob.yaml"]
    assert _pod(day)["containers"][0]["command"] == [
        *cli, "run-day", "--store", "/mnt/store", "--spec", "/etc/bodywork/pipeline.yaml",
        "--trace-out", "/mnt/store/.traces/day-{date}.trace.json"]
    hpa = docs["02-stage-2-serve-model-hpa.yaml"]
    assert hpa["spec"]["scaleTargetRef"]["name"] == hpa["metadata"]["name"]
    pvc = docs["00-store-pvc.yaml"]
    assert pvc["spec"]["accessModes"] == ["ReadWriteMany"]
    assert pvc["spec"]["storageClassName"] == "standard-rwx"
    cm = docs["00-pipeline-spec-configmap.yaml"]
    assert PipelineSpec.from_yaml(cm["data"]["pipeline.yaml"]) == spec
    for doc in docs.values():
        if doc["kind"] == "Job":
            cmd = _pod(doc)["containers"][0]["command"]
            assert cmd[:4] == [*cli, "run-stage"]
            assert "--spec" in cmd and "/etc/bodywork/pipeline.yaml" in cmd
    # GPU scheduling: the device stages' pods ask for one H100, the test
    # stage's for none
    for filename in ("01-stage-1-train-model-job.yaml", "02-stage-2-serve-model-deployment.yaml",
                     "03-stage-3-generate-next-dataset-job.yaml", "99-daily-loop-cronjob.yaml"):
        pod = _pod(docs[filename])
        assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        assert pod["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 1}
    test_pod = _pod(docs["04-stage-4-test-model-scoring-service-job.yaml"])
    assert "nodeSelector" not in test_pod
    assert "limits" not in test_pod["containers"][0]["resources"]
    for doc in docs.values():
        for c in _containers(doc) if doc["kind"] != "HorizontalPodAutoscaler" else []:
            assert not any(e["name"].startswith("JAX_") for e in c.get("env", []))
    job = docs["01-stage-1-train-model-job.yaml"]
    assert job["spec"]["backoffLimit"] == 2 and job["spec"]["activeDeadlineSeconds"] == 30
    dep = docs["02-stage-2-serve-model-deployment.yaml"]
    assert dep["spec"]["replicas"] == 2
    assert _pod(dep)["containers"][0]["readinessProbe"]["httpGet"]["path"] == "/healthz"
    written = write_manifests(spec, tmp_path / "k8s", store_path="/mnt/store")
    assert len(written) == len(docs)
    for path in written:
        assert yaml.safe_load(path.read_text()) == docs[path.name]


def test_offset_schedule_wraps_cleanly_and_never_across_a_pinned_day():
    from bodywork_tpu_torch.pipeline.k8s import _offset_schedule

    assert _offset_schedule("0 6 * * *", 30) == "30 6 * * *"
    assert _offset_schedule("45 6 * * *", 30) == "15 7 * * *"
    assert _offset_schedule("45 23 * * *", 30) == "15 0 * * *"
    assert _offset_schedule("@daily", 30) == "@daily"
    assert _offset_schedule("45 23 * * 1", 30) == "45 23 * * 1"
    assert _offset_schedule("0 6 * * 1", 30) == "30 6 * * 1"


def test_cron_pods_image_and_resources():
    from bodywork_tpu_torch.pipeline.images import stage_image_tag

    spec = default_pipeline()
    image = "registry.example.com/bodywork-tpu:v9"
    docs = generate_manifests(spec, store_path="/mnt/store", image=image)
    stage1_image = stage_image_tag(spec.stages["stage-1-train-model"], image)
    assert stage1_image and stage1_image != image
    day_pod = _pod(docs["99-daily-loop-cronjob.yaml"])
    assert day_pod["containers"][0]["image"] == image
    assert day_pod["containers"][0]["name"] == "daily-loop"
    assert day_pod["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert {"name": "BODYWORK_TPU_TRAIN_MODE", "value": "full"} in day_pod["containers"][0]["env"]
    for filename, name in (("99-drift-gate-cronjob.yaml", "drift-gate"),
                           ("99-compact-history-cronjob.yaml", "compact-history"),
                           ("99-store-scrub-cronjob.yaml", "store-scrub")):
        pod = _pod(docs[filename])
        assert pod["containers"][0]["image"] == image
        assert pod["containers"][0]["name"] == name
        assert "nodeSelector" not in pod and "limits" not in pod["containers"][0]["resources"]
    job = docs["01-stage-1-train-model-job.yaml"]
    assert _pod(job)["containers"][0]["image"] == stage1_image


def test_manifest_store_volume_modes():
    spec = default_pipeline()
    docs = generate_manifests(spec, store_path="/mnt/store", store_volume="hostpath")
    assert "00-store-pvc.yaml" not in docs
    vols = _pod(docs["01-stage-1-train-model-job.yaml"])["volumes"]
    assert any(v.get("hostPath", {}).get("path") == "/mnt/store" for v in vols)
    docs = generate_manifests(spec, store_path="gs://bucket/root")
    assert "00-store-pvc.yaml" not in docs
    for doc in docs.values():
        if doc["kind"] in ("Job", "Deployment", "CronJob"):
            assert all(v["name"] != "artefact-store" for v in _pod(doc)["volumes"])
    assert "gs://bucket/root" in _pod(docs["01-stage-1-train-model-job.yaml"])[
        "containers"][0]["command"]
    docs = generate_manifests(spec, store_path="/mnt/store", storage_class="standard-rwx",
                              pvc_size="50Gi")
    assert docs["00-store-pvc.yaml"]["spec"]["resources"]["requests"]["storage"] == "50Gi"
    with pytest.raises(ValueError, match="does not fit"):
        generate_manifests(spec, store_path="gs://bucket", store_volume="pvc")
    with pytest.raises(ValueError, match="does not fit"):
        generate_manifests(spec, store_path="/mnt/store", store_volume="gcs")
    with pytest.raises(ValueError, match="store_volume"):
        generate_manifests(spec, store_path="/mnt/store", store_volume="nfs")


def test_manifests_enforce_dag_order_via_init_containers():
    docs = generate_manifests(default_pipeline(), store_path="/mnt/store")

    def init_cmd(doc):
        pod = _pod(doc)
        return " ".join(pod["initContainers"][0]["command"]) if "initContainers" in pod else ""

    assert "--dataset" in init_cmd(docs["01-stage-1-train-model-job.yaml"])
    assert "--model" in init_cmd(docs["02-stage-2-serve-model-deployment.yaml"])
    assert "/healthz" in init_cmd(docs["03-stage-3-generate-next-dataset-job.yaml"])
    assert "--dataset-newer-than-model" in init_cmd(
        docs["04-stage-4-test-model-scoring-service-job.yaml"])
    for name in ("01-stage-1-train-model-job.yaml", "04-stage-4-test-model-scoring-service-job.yaml"):
        assert init_cmd(docs[name]).startswith("python -m bodywork_tpu_torch.cli wait-for")
    assert "initContainers" not in _pod(docs["99-daily-loop-cronjob.yaml"])


def test_manifests_validate_and_ingress_emitted():
    spec = default_pipeline()
    serve = spec.stages["stage-2-serve-model"]
    spec.stages["stage-2-serve-model"] = dataclasses.replace(serve, ingress=True)
    docs = generate_manifests(spec, store_path="/mnt/store")
    ingress = [d for d in docs.values() if d["kind"] == "Ingress"]
    assert len(ingress) == 1
    rule = ingress[0]["spec"]["rules"][0]["http"]["paths"][0]
    assert rule["path"] == f"/{spec.name}/stage-2-serve-model(/|$)(.*)"
    assert rule["pathType"] == "ImplementationSpecific"
    rewrite = ingress[0]["metadata"]["annotations"]["nginx.ingress.kubernetes.io/rewrite-target"]
    for route in ("/score/v1", "/score/v1/batch", "/healthz"):
        m = re.fullmatch(rule["path"], f"/{spec.name}/stage-2-serve-model{route}")
        assert m and rewrite.replace("$2", m.group(2)) == route
    assert rule["backend"]["service"]["port"]["number"] == serve.port
    validate_manifests(docs)
    assert not any(d["kind"] == "Ingress" for d in generate_manifests(
        default_pipeline(), store_path="/mnt/store").values())


def test_manifest_validator_catches_field_typos():
    docs = generate_manifests(default_pipeline(), store_path="/mnt/store")
    job = docs["01-stage-1-train-model-job.yaml"]
    bad = copy.deepcopy(job)
    bad["spec"]["activeDeadlineSecond"] = bad["spec"].pop("activeDeadlineSeconds")
    assert any("activeDeadlineSecond" in e for e in validate_manifest(bad, "job.yaml"))
    bad2 = copy.deepcopy(job)
    c = bad2["spec"]["template"]["spec"]["containers"][0]
    c["volumeMount"] = c.pop("volumeMounts")
    assert any("volumeMount" in e for e in validate_manifest(bad2, "j"))
    bad3 = copy.deepcopy(job)
    del bad3["spec"]["template"]
    assert any("template" in e for e in validate_manifest(bad3, "j"))
    bad4 = copy.deepcopy(job)
    bad4["apiVersion"] = "batch/v1beta1"
    assert any("apiVersion" in e for e in validate_manifest(bad4, "j"))
    with pytest.raises(ManifestError):
        validate_manifests({**docs, "bad.yaml": bad})


def test_every_default_manifest_kind_is_validatable():
    from bodywork_tpu_torch.pipeline.k8s_validate import _KIND_SPEC_VALIDATORS

    spec = default_pipeline()
    spec.stages["stage-2-serve-model"] = dataclasses.replace(
        spec.stages["stage-2-serve-model"], ingress=True)
    for kw in ({"store_path": "/mnt/store"},
               {"store_path": "/mnt/store", "store_volume": "hostpath"},
               {"store_path": "gs://bucket/root"}):
        kinds = {d["kind"] for d in generate_manifests(spec, **kw).values()}
        assert kinds <= set(_KIND_SPEC_VALIDATORS)


def test_manifest_validator_covers_service_ingress_cronjob_paths():
    spec = default_pipeline()
    spec.stages["stage-2-serve-model"] = dataclasses.replace(
        spec.stages["stage-2-serve-model"], ingress=True)
    docs = generate_manifests(spec, store_path="/mnt/store")
    svc = copy.deepcopy(next(d for d in docs.values() if d["kind"] == "Service"))
    del svc["spec"]["ports"]
    assert any("ports" in e for e in validate_manifest(svc, "svc"))
    ing = copy.deepcopy(next(d for d in docs.values() if d["kind"] == "Ingress"))
    path0 = ing["spec"]["rules"][0]["http"]["paths"][0]
    path0["backend"]["servce"] = path0["backend"].pop("service")
    errs = validate_manifest(ing, "ing")
    assert any("unknown field 'servce'" in e for e in errs)
    assert any("missing required field 'service'" in e for e in errs)
    cron = copy.deepcopy(next(d for d in docs.values() if d["kind"] == "CronJob"))
    cron["spec"]["schedle"] = cron["spec"].pop("schedule")
    errs = validate_manifest(cron, "cron")
    assert any("unknown field 'schedle'" in e for e in errs)
    assert any("missing required field 'schedule'" in e for e in errs)


@pytest.mark.parametrize("env", [
    {"BODYWORK_TPU_MESH_DATA": "2"},
    {"BODYWORK_TPU_MESH_MODEL": "4"},
    {"BODYWORK_TPU_MESH_DATA": "2", "BODYWORK_TPU_MESH_MODEL": "2"},
], ids=["data", "model", "data-model"])
def test_a_serving_mesh_knob_emits_the_jax_generators_manifests(env):
    """The mesh knobs ride the serve container's env, as the JAX
    generator emits them: the same documents under the parity mapping."""
    port, jax = _split_pair(env, model="mlp")
    assert list(port) == list(jax)
    assert _mask_port(port) == _map_jax(jax)
    serve = next(d for d in port.values() if d["kind"] == "Deployment"
                 and d["metadata"]["name"].endswith("serve-model"))
    got = {e["name"]: e.get("value") for e in _containers(serve)[-1]["env"]}
    assert all(got[k] == v for k, v in env.items())


def _multihost_pair(hosts: int, daily):
    """The port's manifests for a spec whose train stage runs on
    ``hosts`` GPU hosts, and the JAX generator's for ``tpu_hosts``."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.pipeline import generate_manifests as jax_manifests
    from bodywork_tpu.pipeline.k8s import DEFAULT_DAILY_SCHEDULE as JAX_DEFAULT
    from bodywork_tpu_torch.pipeline.k8s import DEFAULT_DAILY_SCHEDULE

    # each generator tells its own default schedule apart by identity
    port_daily, jax_daily = ((DEFAULT_DAILY_SCHEDULE, JAX_DEFAULT) if daily == "default"
                             else (daily, daily))
    spec, jax_spec = default_pipeline("mlp"), jax_pipeline("mlp")
    train = spec.stages["stage-1-train-model"]
    spec.stages["stage-1-train-model"] = dataclasses.replace(
        train, resources=dataclasses.replace(train.resources, gpu_hosts=hosts))
    jtrain = jax_spec.stages["stage-1-train-model"]
    jax_spec.stages["stage-1-train-model"] = dataclasses.replace(
        jtrain, resources=dataclasses.replace(jtrain.resources, tpu_hosts=hosts))
    return (generate_manifests(spec, store_path="/mnt/store", daily_schedule=port_daily),
            jax_manifests(jax_spec, store_path="/mnt/store", daily_schedule=jax_daily))


@pytest.mark.parametrize("hosts", [2, 4])
def test_gpu_hosts_emit_the_jax_generators_indexed_job(hosts):
    """``gpu_hosts`` > 1 is the JAX spec's ``tpu_hosts``: the Indexed Job
    (one pod a host, the scaled ``backoffLimit``, ``subdomain``, the
    coordinator env) and its headless Service, the same documents under
    the parity mapping; the daily-loop CronJob is left out of both."""
    port, jax = _multihost_pair(hosts, None)
    assert list(port) == list(jax)
    assert _mask_port(port) == _map_jax(jax)
    job = port["01-stage-1-train-model-job.yaml"]["spec"]
    assert (job["completions"], job["parallelism"], job["completionMode"]) == (
        hosts, hosts, "Indexed")
    assert job["backoffLimit"] == 2 * hosts
    env = {e["name"]: e["value"] for e in _containers(port["01-stage-1-train-model-job.yaml"])
           [-1]["env"]}
    assert env["NUM_PROCESSES"] == str(hosts)
    assert env["JAX_COORDINATOR_ADDRESS"].endswith(":8476")
    headless = port["01-stage-1-train-model-workers-headless.yaml"]
    assert headless["spec"]["clusterIP"] == "None"
    port_default, jax_default = _multihost_pair(hosts, "default")
    assert list(port_default) == list(jax_default)
    assert not any("daily-loop" in f for f in port_default)


def test_a_multihost_service_stage_and_an_explicit_schedule_are_refused():
    spec = default_pipeline()
    serve = spec.stages["stage-2-serve-model"]
    spec.stages["stage-2-serve-model"] = dataclasses.replace(
        serve, resources=dataclasses.replace(serve.resources, gpu_hosts=2))
    with pytest.raises(ValueError, match="gpu_hosts > 1 is only supported for batch"):
        generate_manifests(spec, store_path="/mnt/store")
    with pytest.raises(ValueError, match="daily_schedule is not materialisable"):
        _multihost_pair(2, "0 5 * * *")


def _split_pair(env: dict, model: str = "linear"):
    """The port's and the JAX generator's manifests for a serve stage
    with ``env``."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.pipeline import generate_manifests as jax_manifests

    spec, jax_spec = default_pipeline(model), jax_pipeline(model)
    for s in (spec, jax_spec):
        serve = s.stages["stage-2-serve-model"]
        s.stages["stage-2-serve-model"] = dataclasses.replace(serve, env=dict(env))
    return (generate_manifests(spec, store_path="/mnt/store"),
            jax_manifests(jax_spec, store_path="/mnt/store"))


@pytest.mark.parametrize("env", [
    {"BODYWORK_TPU_SERVE_TRANSPORT": "tcp"},
    {"BODYWORK_TPU_SERVE_TRANSPORT": "tcp", "BODYWORK_TPU_SERVE_STANDBY": "1"},
    {"BODYWORK_TPU_FRONTENDS": "2"},
    {"BODYWORK_TPU_DISPATCHER_ADDR": "x:9091"},
    {"BODYWORK_TPU_SERVE_ROLE": "frontend"},
    {"BODYWORK_TPU_SERVE_TRANSPORT": "unix", "BODYWORK_TPU_SERVE_STANDBY": "yes"},
], ids=["transport-tcp", "standby-pair", "frontends", "dispatcher-addr", "role",
        "unix-standby"])
def test_a_split_serving_knob_emits_the_jax_generators_manifests(env):
    """The five split-topology env knobs emit, under the parity mapping,
    the JAX generator's documents: on tcp the front-end Deployment (no
    GPU) plus the dispatcher Deployment (the stage's GPU, ``--standby``
    and two replicas with the pair) and its ``rowqueue`` Service; the
    other knobs ride the serve container's env. A deployment document's
    key order follows the declared knob, as the tuned knobs' does."""
    port, jax = _split_pair(env)
    assert list(port) == list(jax)
    mapped, masked = _map_jax(jax), _mask_port(port)
    assert masked == mapped
    dumped, jax_dumped = _dump_all(masked), _dump_all(mapped)
    for f, doc in port.items():
        if doc["kind"] == "Deployment":
            for c, jax_c in zip(_containers(doc), _containers(jax[f])):
                assert list(c) == list(jax_c)
        else:
            assert dumped[f] == jax_dumped[f], f
    split = env.get("BODYWORK_TPU_SERVE_TRANSPORT") == "tcp"
    assert any(f.endswith("-dispatcher-deployment.yaml") for f in port) == split
    for f, doc in port.items():
        if doc["kind"] != "Deployment" or doc["metadata"]["name"].startswith(
                "bodywork-ml-pipeline-project--daily"):
            continue
        gpu = _containers(doc)[-1]["resources"].get("limits", {}).get("nvidia.com/gpu")
        assert bool(gpu) == (not split or f.endswith("-dispatcher-deployment.yaml")), f


def test_the_split_validator_refuses_a_scaled_dispatcher():
    """Two unfenced dispatchers would split the coalescer's rows: the
    port's validator refuses a scaled singleton and an HPA aimed at it,
    with the JAX validator's errors for the same documents."""
    from bodywork_tpu.pipeline.k8s_validate import validate_split_serving as jax_validate
    from bodywork_tpu_torch.pipeline.k8s_validate import validate_split_serving

    port, jax = _split_pair({"BODYWORK_TPU_SERVE_TRANSPORT": "tcp"})
    assert validate_split_serving(port) == []
    for docs in (port, jax):
        disp = next(d for d in docs.values() if d["kind"] == "Deployment"
                    and d["metadata"]["name"].endswith("--dispatcher"))
        disp["spec"]["replicas"] = 3
    errors = validate_split_serving(port)
    assert errors == jax_validate(jax) and any("exactly 1 replica" in e for e in errors)
    for docs in (port, jax):
        disp = next(d for d in docs.values() if d["kind"] == "Deployment"
                    and d["metadata"]["name"].endswith("--dispatcher"))
        disp["spec"]["replicas"] = 1
        hpa = next(d for d in docs.values() if d["kind"] == "HorizontalPodAutoscaler")
        hpa["spec"]["scaleTargetRef"]["name"] = disp["metadata"]["name"]
    errors = validate_split_serving(port)
    assert errors == jax_validate(jax) and any("front-end" in e and "HPA" in e
                                               for e in errors)
    with pytest.raises(ManifestError):
        validate_manifests(port)


def test_the_standby_pair_round_trips_and_validates_both_ways(tmp_path):
    """The standby pair written to disk reads back to the same documents,
    passes every layer, and the replica rule holds both ways: 3 refused,
    1 accepted with standby; 2 refused without."""
    from bodywork_tpu_torch.pipeline.k8s_validate import validate_split_serving

    spec = default_pipeline()
    serve = spec.stages["stage-2-serve-model"]
    spec.stages["stage-2-serve-model"] = dataclasses.replace(serve, env={
        "BODYWORK_TPU_SERVE_TRANSPORT": "tcp", "BODYWORK_TPU_SERVE_STANDBY": "1"})
    paths = write_manifests(spec, tmp_path, store_path="/mnt/store")
    docs = {p.name: yaml.safe_load(p.read_text()) for p in paths}
    assert docs == generate_manifests(spec, store_path="/mnt/store")
    validate_manifests(docs)
    disp = next(d for d in docs.values() if d["kind"] == "Deployment"
                and d["metadata"]["name"].endswith("--dispatcher"))
    assert disp["spec"]["replicas"] == 2
    assert "--standby" in disp["spec"]["template"]["spec"]["containers"][0]["command"]
    disp["spec"]["replicas"] = 3
    assert any("1 or 2 replicas" in e for e in validate_split_serving(docs))
    disp["spec"]["replicas"] = 1
    assert validate_split_serving(docs) == []
    single, _ = _split_pair({"BODYWORK_TPU_SERVE_TRANSPORT": "tcp"})
    disp = next(d for d in single.values() if d["kind"] == "Deployment"
                and d["metadata"]["name"].endswith("--dispatcher"))
    disp["spec"]["replicas"] = 2
    assert any("exactly 1 replica" in e for e in validate_split_serving(single))


@pytest.mark.parametrize("name,value", [
    ("BODYWORK_TPU_TUNED_CONFIG", "latest"),
    ("BODYWORK_TPU_TUNE_ONLINE", "1"),
])
def test_a_tuned_serve_stage_emits_the_jax_generators_manifests(name, value):
    """The control plane's two serve-stage knobs (ROADMAP Queue 1 item 17)
    are emitted, not refused: the manifests equal the JAX generator's for
    the same spec under the mapping, the knob on the serve container."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.pipeline import generate_manifests as jax_manifests

    spec, jax_spec = default_pipeline("mlp"), jax_pipeline("mlp")
    for s in (spec, jax_spec):
        serve = s.stages["stage-2-serve-model"]
        s.stages["stage-2-serve-model"] = dataclasses.replace(serve, env={name: value})
    kw = dict(store_path="/mnt/artefact-store", image="registry.example/bodywork:v3")
    port = generate_manifests(spec, **kw)
    jax = jax_manifests(jax_spec, **kw)
    assert list(port) == list(jax)
    mapped, masked = _map_jax(jax), _mask_port(port)
    assert masked == mapped
    dumped, jax_dumped = _dump_all(masked), _dump_all(mapped)
    (serve_file,) = [f for f, doc in port.items() if doc["kind"] == "Deployment"]
    for f in port:
        if f != serve_file:
            assert dumped[f] == jax_dumped[f], f
    # the declared knob creates the serve container's env key ahead of
    # envFrom in both generators: the key order is the JAX generator's
    for c, jax_c in zip(_containers(port[serve_file]), _containers(jax[serve_file])):
        assert list(c) == list(jax_c)
    serve_env = [e for c in _containers(port[serve_file]) for e in c.get("env", [])]
    assert {"name": name, "value": value} in serve_env


@pytest.mark.parametrize("model,store_path", [
    ("linear", "/mnt/artefact-store"),
    ("mlp", "gs://bucket/prefix"),
])
def test_a_tenant_stage_emits_the_jax_generators_manifests(model, store_path):
    """A tenant's pipeline (``BODYWORK_TPU_TENANT`` on every stage, ROADMAP
    Queue 1 item 14) is emitted, not refused: the manifests equal the JAX
    generator's for the same spec under the mapping, the knob on every
    stage's container."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline
    from bodywork_tpu.pipeline import generate_manifests as jax_manifests

    spec, jax_spec = default_pipeline(model), jax_pipeline(model)
    for s in (spec, jax_spec):
        for name, stage in list(s.stages.items()):
            s.stages[name] = dataclasses.replace(
                stage, env={**stage.env, "BODYWORK_TPU_TENANT": "acme"})
    kw = dict(store_path=store_path, image="registry.example/bodywork:v3")
    port = generate_manifests(spec, **kw)
    jax = jax_manifests(jax_spec, **kw)
    assert list(port) == list(jax)
    assert _mask_port(port) == _map_jax(jax)
    envs = [e for doc in port.values() for c in _containers(doc) for e in c.get("env", [])]
    assert {"name": "BODYWORK_TPU_TENANT", "value": "acme"} in envs


# -- the stage pods' measured import closures -------------------------------

#: top-level module -> the distribution a stage image would have to pin
_MANAGED_DISTS = {"torch": "torch", "numpy": "numpy", "yaml": "pyyaml", "pandas": "pandas",
                  "requests": "requests", "werkzeug": "werkzeug", "jax": "jax",
                  "jsonschema": "jsonschema", "matplotlib": "matplotlib",
                  "sentry_sdk": "sentry-sdk"}


def _imported_modules(argv, expect_ok=True) -> set[str]:
    """Run ``python -X importtime -m bodywork_tpu_torch.cli ARGV`` in a
    clean interpreter and return every module it imported, lazy imports
    included: a stage pod's real execution closure."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "bodywork_tpu_torch.cli", *argv],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    if expect_ok:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
            if line.startswith("import time:")}


def _managed(modules: set[str]) -> set[str]:
    tops = {m.split(".")[0] for m in modules}
    return {pin for mod, pin in _MANAGED_DISTS.items() if mod in tops}


def test_stage_requirements_cover_each_stage_execution_closure(tmp_path):
    """The pin sets are measured, both ways: every managed distribution a
    stage pod imports while running must be pinned, and the test stage
    (its whole run-stage chain) imports no torch. The repair of ROADMAP
    Queue 3 entry 8 is held here."""
    spec = default_pipeline()
    pins = {name: {line.split("=")[0] for line in stage.requirements}
            for name, stage in spec.stages.items()}
    store = str(tmp_path / "store")
    run = ["run-stage", "--store", store, "--device", "cpu"]
    modules = {
        "stage-3-generate-next-dataset": _imported_modules(
            [*run, "--stage", "stage-3-generate-next-dataset", "--date", "2026-01-01"]),
        "stage-1-train-model": _imported_modules(
            [*run, "--stage", "stage-1-train-model", "--date", "2026-01-02"]),
        # scores through a black-hole URL: the connection is refused after
        # the stage's imports (rc != 0), the closure is still measured
        "stage-4-test-model-scoring-service": _imported_modules(
            ["run-stage", "--store", store, "--stage", "stage-4-test-model-scoring-service",
             "--date", "2026-01-02", "--scoring-url", "http://127.0.0.1:9"], expect_ok=False),
    }
    for name, mods in modules.items():
        missing = _managed(mods) - pins[name]
        assert not missing, f"{name}: pod imports {sorted(missing)} its pins omit"
    test_mods = modules["stage-4-test-model-scoring-service"]
    assert "bodywork_tpu_torch.monitor.tester" in test_mods  # the stage body ran
    assert not {m for m in test_mods if m.split(".")[0] == "torch"}
    # the generate stage needs no HTTP stack: neither a client library nor
    # the port's serving modules
    gen = modules["stage-3-generate-next-dataset"]
    assert not {"requests", "werkzeug"} & _managed(gen)
    assert not {m for m in gen if m.startswith(("bodywork_tpu_torch.serve",
                                                "bodywork_tpu_torch.monitor"))}


def test_deploy_and_wait_for_import_no_torch_yaml_or_jsonschema(tmp_path):
    """The deployment half runs on the standard library: ``deploy`` (both
    validator layers) and ``wait-for`` import no torch, pyyaml or
    jsonschema, and ``report`` no matplotlib without ``--plot``."""
    out = str(tmp_path / "k8s")
    for argv in (["deploy", "--out", out, "--emit-images", str(tmp_path / "img")],
                 ["wait-for", "--store", str(tmp_path / "s"), "--timeout", "0"],
                 ["report", "--store", str(tmp_path / "s")]):
        mods = _imported_modules(argv, expect_ok=argv[0] != "wait-for")
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"torch", "yaml", "jsonschema", "matplotlib", "pandas"}, argv
