"""Per-stage image build contexts (the port of
``bodywork_tpu.pipeline.images``; reference ``bodywork.yaml:10-16,
29-35,50-54,67-72``).

Each stage with a ``requirements`` pin set gets its own image, derived
deterministically from those pins and its base image, and this module
emits the build context (Dockerfile + requirements.txt + build script)
that produces it. Tags are content-addressed:
``<repo>-<stage>:<12-hex digest of base image + sorted pins>``, so a
rebuild with unchanged pins reproduces the tag and any pin change rolls
it.

A stage that uses the card (``resources.gpu_count > 0``) builds on a
CUDA-devel base image, and its Dockerfile runs
``ops._build.build_all()`` once the package is installed: the
hand-written kernels are compiled into the image (``nvcc`` needs no card
to compile for ``sm_90a``), so a pod never meets a missing ``nvcc`` at
its first request, and the toolkit stays in the image for a rebuild. A
stage that uses no card (the test stage) builds on a slim Python image
with no accelerator runtime.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec

__all__ = ["stage_base_image", "stage_image_tag", "uses_derived_tag", "write_stage_images"]

_DEFAULT_BASE = "python:3.12-slim"
#: the CUDA 12.8 toolkit torch 2.11.0 is built for, with nvcc, on Ubuntu
#: 24.04's Python 3.12
_CUDA_BASE = "nvidia/cuda:12.8.1-devel-ubuntu24.04"


def uses_derived_tag(stage: StageSpec) -> bool:
    """True when the manifests for ``stage`` reference a derived
    content-addressed image tag, one that exists only after its build
    context is emitted and built (``cli deploy`` refuses without them).
    An explicit ``stage.image`` is the operator's own tag."""
    return bool(stage.requirements) and not stage.image


def stage_base_image(stage: StageSpec) -> str:
    """The base image of a stage's derived image: the CUDA-devel image for
    a stage that uses the card, the slim Python image otherwise."""
    return _CUDA_BASE if stage.resources.gpu_count else _DEFAULT_BASE


def stage_image_tag(stage: StageSpec, image: str,
                    base_image: str | None = None) -> str | None:
    """The per-stage image reference for the manifests: an explicit
    ``stage.image`` wins; a stage with ``requirements`` gets the derived
    content-addressed tag (over ``base_image``, default the stage's own
    :func:`stage_base_image`); otherwise ``None`` (the pipeline-wide
    image)."""
    if stage.image:
        return stage.image
    if not stage.requirements:
        return None
    # strip only a TAG (a ':' after the last '/'): "localhost:5000/app" is
    # an untagged registry:port reference whose ':' must survive
    head, sep, tail = image.rpartition(":")
    repo = head if sep and "/" not in tail else image
    base = base_image or stage_base_image(stage)
    digest = hashlib.sha256(
        "\n".join([base, *sorted(stage.requirements)]).encode()
    ).hexdigest()[:12]
    return f"{repo}-{stage.name}:{digest}"


def _dockerfile(name: str, tag: str, base: str, uses_card: bool) -> str:
    lines = [f"# stage {name} — pins: content-addressed tag {tag}", f"FROM {base}"]
    pip = "pip install --no-cache-dir"
    if uses_card:
        lines += [
            "RUN apt-get update && apt-get install -y --no-install-recommends "
            "python3 python3-pip python-is-python3 && rm -rf /var/lib/apt/lists/*",
            # the distribution's Python: pip installs beside it
            "ENV PIP_BREAK_SYSTEM_PACKAGES=1",
        ]
    lines += [
        "COPY requirements.txt /tmp/requirements.txt",
        f"RUN {pip} -r /tmp/requirements.txt",
        # the framework rides on top of the stage's pins; the build context
        # is the repo root (-f selects this Dockerfile)
        "COPY . /opt/bodywork-tpu",
        f"RUN {pip} --no-deps /opt/bodywork-tpu",
    ]
    if uses_card:
        # compile the hand-written kernels into the installed package's
        # build directory now: nvcc needs no card, and the pod's first
        # request then loads the library instead of building it
        lines.append('RUN python -c "from bodywork_tpu_torch.ops._build import build_all; '
                     'build_all()"')
    lines.append('ENTRYPOINT ["python", "-m", "bodywork_tpu_torch.cli"]')
    return "\n".join(lines) + "\n"


def write_stage_images(spec: PipelineSpec, out_dir: str | Path,
                       image: str = "bodywork-tpu/runtime:latest",
                       base_image: str | None = None) -> list[Path]:
    """Emit one build context per requirements-pinned stage, plus a
    ``build.sh`` driving all of them. Returns the written paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    build_lines = [
        "#!/bin/sh",
        "# build every per-stage image. The docker build CONTEXT must be",
        "# the framework repo root (the Dockerfiles COPY the package in):",
        "# pass it as $1 or set BODYWORK_TPU_ROOT; never assumed from the",
        "# emit directory's location.",
        "set -eu",
        'cd "$(dirname "$0")"',
        'ROOT="${1:-${BODYWORK_TPU_ROOT:-}}"',
        'if [ -z "$ROOT" ]; then',
        '  echo "usage: $0 <repo-root> (or set BODYWORK_TPU_ROOT)" >&2',
        "  exit 2",
        "fi",
    ]
    for name, stage in spec.stages.items():
        if not stage.requirements or stage.image:
            continue  # nothing to build: shared image or explicit override
        base = base_image or stage_base_image(stage)
        tag = stage_image_tag(stage, image, base)
        ctx = out / name
        ctx.mkdir(exist_ok=True)
        reqs = ctx / "requirements.txt"
        reqs.write_text("\n".join(stage.requirements) + "\n")
        dockerfile = ctx / "Dockerfile"
        dockerfile.write_text(_dockerfile(name, tag, base, bool(stage.resources.gpu_count)))
        build_lines.append(f'docker build -f {name}/Dockerfile -t {tag} "$ROOT"')
        written += [reqs, dockerfile]
    script = out / "build.sh"
    script.write_text("\n".join(build_lines) + "\n")
    script.chmod(0o755)
    written.append(script)
    return written
