"""The port's pipeline spec (``bodywork_tpu_torch.pipeline.spec``) against
the JAX package's: the YAML round-trip, resources, secrets, per-stage
requirements and images, the legacy secret migration, and the refusal of
a document naming a TPU resource field."""
from __future__ import annotations

import dataclasses

import pytest
import yaml

from bodywork_tpu_torch.pipeline import PipelineSpec, ResourceSpec, default_pipeline
from bodywork_tpu_torch.pipeline.spec import STAGE_REQUIREMENTS, stage_requirements


def _jax_doc_mapped(jax_spec) -> dict:
    """The JAX spec's YAML document with exactly the port's differences
    mapped: the stage callables' module, the GPU resources in place of
    the TPU ones, and the measured pins."""
    doc = yaml.safe_load(jax_spec.to_yaml())
    port = default_pipeline()
    for name, block in doc["stages"].items():
        block["executable"] = block["executable"].replace(
            "bodywork_tpu.pipeline.stages", "bodywork_tpu_torch.pipeline.stages")
        res = block["resources"]
        block["resources"] = {
            "cpu_request": res["cpu_request"], "memory_mb": res["memory_mb"],
            "gpu_accelerator": "nvidia-h100-80gb" if res["tpu_chips"] else None,
            "gpu_count": res["tpu_chips"], "gpu_hosts": res["tpu_hosts"],
        }
        block["requirements"] = port.stages[name].requirements
    return doc


@pytest.mark.parametrize("model", ["linear", "mlp"])
@pytest.mark.parametrize("mode", ["single", "batch"])
@pytest.mark.parametrize("overlap", [False, True])
def test_spec_document_is_the_jax_packages_under_the_gpu_mapping(model, mode, overlap):
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline

    port = default_pipeline(model, mode, overlap_generate=overlap)
    jax = jax_pipeline(model, mode, overlap_generate=overlap)
    assert yaml.safe_load(port.to_yaml()) == _jax_doc_mapped(jax)
    # and the port's text is pyyaml's bytes for that document
    assert port.to_yaml() == yaml.safe_dump(yaml.safe_load(port.to_yaml()), sort_keys=False)


def test_spec_yaml_roundtrip():
    spec = default_pipeline()
    clone = PipelineSpec.from_yaml(spec.to_yaml())
    assert clone == spec
    assert clone.name == spec.name and clone.dag == spec.dag
    s = clone.stages["stage-2-serve-model"]
    assert s.kind == "service" and s.replicas == 2 and s.port == 5000
    train = clone.stages["stage-1-train-model"].resources
    assert (train.gpu_accelerator, train.gpu_count) == ("nvidia-h100-80gb", 1)
    test = clone.stages["stage-4-test-model-scoring-service"].resources
    assert test == ResourceSpec(cpu_request=0.5, memory_mb=256)


def test_per_stage_requirements_isolation(tmp_path):
    """Each stage carries its own exact pins, overlapping pins agree, the
    manifests reference content-addressed per-stage tags that roll only
    with that stage's pins, and the emitted build contexts build exactly
    those tags (a CUDA-devel base with the kernels built in for a stage
    on the card; a slim base with no torch for the test stage)."""
    from bodywork_tpu_torch.pipeline.images import stage_image_tag, write_stage_images
    from bodywork_tpu_torch.pipeline.k8s import generate_manifests

    spec = default_pipeline()
    req = {n: set(s.requirements) for n, s in spec.stages.items()}
    assert all(req.values())
    pins_by_pkg: dict = {}
    for reqs in req.values():
        for line in reqs:
            assert "==" in line, f"unpinned requirement {line}"
            assert pins_by_pkg.setdefault(line.split("=")[0], line) == line
    assert not any("torch" in line for line in req["stage-4-test-model-scoring-service"])
    loaded = PipelineSpec.from_yaml(spec.to_yaml())
    assert {n: s.requirements for n, s in loaded.stages.items()} == {
        n: s.requirements for n, s in spec.stages.items()}

    image = "registry/bodywork-tpu:v1"
    docs = generate_manifests(spec, store_path="/mnt/s", store_volume="pvc", image=image)
    train = spec.stages["stage-1-train-model"]
    tag = stage_image_tag(train, image)
    assert tag and tag.startswith("registry/bodywork-tpu-stage-1-train-model:")
    job = docs["01-stage-1-train-model-job.yaml"]
    assert job["spec"]["template"]["spec"]["containers"][0]["image"] == tag
    bumped = dataclasses.replace(train, requirements=[*train.requirements, "x==1"])
    assert stage_image_tag(bumped, image) != tag
    assert stage_image_tag(dataclasses.replace(train, image="custom:1"), image) == "custom:1"

    out = tmp_path / "images"
    write_stage_images(spec, out, image=image)
    build = (out / "build.sh").read_text()
    for name, stage in spec.stages.items():
        ctx = out / name
        assert (ctx / "requirements.txt").read_text().splitlines() == stage.requirements
        dockerfile = (ctx / "Dockerfile").read_text()
        assert stage_image_tag(stage, image) in dockerfile
        assert stage_image_tag(stage, image) in build
        assert dockerfile.splitlines()[-1] == (
            'ENTRYPOINT ["python", "-m", "bodywork_tpu_torch.cli"]')
        if stage.resources.gpu_count:
            assert "FROM nvidia/cuda:" in dockerfile and "-devel-" in dockerfile
            assert "build_all()" in dockerfile
        else:
            assert "FROM python:3.12-slim" in dockerfile and "build_all" not in dockerfile


def test_stage_requirements_are_the_pin_table():
    for name in STAGE_REQUIREMENTS:
        assert default_pipeline().stages[name].requirements == stage_requirements(name)


def test_per_stage_image_override():
    """A per-stage image override round-trips the YAML and reaches the
    stage's container and its wait-for gate; a stage with neither an
    override nor pins falls back to the pipeline-wide image."""
    from bodywork_tpu_torch.pipeline.k8s import generate_manifests

    spec = default_pipeline()
    train = spec.stages["stage-1-train-model"]
    spec.stages["stage-1-train-model"] = dataclasses.replace(
        train, image="registry.example/train-stage:1.2.3")
    clone = PipelineSpec.from_yaml(spec.to_yaml())
    assert clone.stages["stage-1-train-model"].image == "registry.example/train-stage:1.2.3"
    assert clone.stages["stage-2-serve-model"].image is None

    docs = generate_manifests(spec, store_path="/mnt/store", image="global/runtime:latest")
    pod = docs["01-stage-1-train-model-job.yaml"]["spec"]["template"]["spec"]
    assert pod["containers"][0]["image"] == "registry.example/train-stage:1.2.3"
    for init in pod.get("initContainers", []):
        assert init["image"] == "registry.example/train-stage:1.2.3"
    serve = docs["02-stage-2-serve-model-deployment.yaml"]
    assert serve["spec"]["template"]["spec"]["containers"][0]["image"].startswith(
        "global/runtime-stage-2-serve-model:")
    spec.stages["stage-3-generate-next-dataset"] = dataclasses.replace(
        spec.stages["stage-3-generate-next-dataset"], requirements=[])
    docs = generate_manifests(spec, store_path="/mnt/store", image="global/runtime:latest")
    gen = docs["03-stage-3-generate-next-dataset-job.yaml"]
    assert gen["spec"]["template"]["spec"]["containers"][0]["image"] == "global/runtime:latest"


def test_required_secrets_not_marked_optional():
    from bodywork_tpu_torch.pipeline.k8s import generate_manifests

    spec = default_pipeline()
    spec.stages["stage-1-train-model"] = dataclasses.replace(
        spec.stages["stage-1-train-model"], secrets=["db-credentials"])
    container = generate_manifests(spec, store_path="/mnt/store")[
        "01-stage-1-train-model-job.yaml"]["spec"]["template"]["spec"]["containers"][0]
    refs = {e["secretRef"]["name"]: e["secretRef"].get("optional", False)
            for e in container["envFrom"]}
    assert refs == {"db-credentials": False, "sentry-integration": True}
    clone = PipelineSpec.from_yaml(spec.to_yaml())
    assert clone.stages["stage-1-train-model"].secrets == ["db-credentials"]
    assert clone.stages["stage-1-train-model"].optional_secrets == ["sentry-integration"]


@pytest.mark.parametrize("legacy_form", ["block", "flow"])
def test_legacy_yaml_sentry_secret_migrates_to_optional(legacy_form):
    replacement = ("secrets:\n    - sentry-integration" if legacy_form == "block"
                   else "secrets: [sentry-integration]")
    legacy = default_pipeline().to_yaml().replace(
        "optional_secrets:\n    - sentry-integration", replacement)
    assert "optional_secrets" not in legacy
    clone = PipelineSpec.from_yaml(legacy)
    for stage in clone.stages.values():
        assert stage.secrets == []
        assert stage.optional_secrets == ["sentry-integration"]


def test_the_jax_packages_legacy_document_migrates_in_the_port_too():
    """The JAX package's own legacy text (its stage blocks carry TPU
    resources, so they are mapped first) reads to the same stages."""
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline

    doc = _jax_doc_mapped(jax_pipeline())
    for block in doc["stages"].values():
        block["secrets"] = block.pop("optional_secrets")
    clone = PipelineSpec.from_yaml(yaml.safe_dump(doc, sort_keys=False))
    assert clone == default_pipeline()


@pytest.mark.parametrize("field", ["tpu_accelerator", "tpu_topology", "tpu_chips", "tpu_hosts"])
def test_a_document_naming_a_tpu_resource_field_is_refused(field):
    from bodywork_tpu.pipeline import default_pipeline as jax_pipeline

    doc = yaml.safe_load(default_pipeline().to_yaml())
    doc["stages"]["stage-1-train-model"]["resources"][field] = 1
    with pytest.raises(ValueError, match=field) as info:
        PipelineSpec.from_yaml(yaml.safe_dump(doc, sort_keys=False))
    assert "stage-1-train-model" in str(info.value)
    # the JAX package's own spec text is refused the same way
    with pytest.raises(ValueError, match="tpu_"):
        PipelineSpec.from_yaml(jax_pipeline().to_yaml())


def test_an_unknown_resource_field_is_refused():
    doc = yaml.safe_load(default_pipeline().to_yaml())
    doc["stages"]["stage-1-train-model"]["resources"]["gpus"] = 1
    with pytest.raises(ValueError, match="gpus"):
        PipelineSpec.from_yaml(yaml.safe_dump(doc, sort_keys=False))


def test_spec_rejects_undeclared_dag_stage_and_bad_kind():
    from bodywork_tpu_torch.pipeline import StageSpec

    with pytest.raises(ValueError, match="undeclared"):
        PipelineSpec(name="p", dag=[["ghost"]], stages={})
    with pytest.raises(ValueError, match="batch|service"):
        StageSpec(name="s", kind="cron", executable="m:f")


def test_service_dns_convention():
    assert (default_pipeline().service_dns("stage-2-serve-model")
            == "bodywork-tpu-pipeline--stage-2-serve-model")
