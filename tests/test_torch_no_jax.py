"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package — neither at run time (a fresh subprocess) nor in its source
(a static scan)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "bodywork_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import sys
import bodywork_tpu_torch, bodywork_tpu_torch.cli, bodywork_tpu_torch.serve.server
import bodywork_tpu_torch.ops.mlp_kernel, bodywork_tpu_torch.ops._build
import bodywork_tpu_torch.monitor.tester, bodywork_tpu_torch.data.generator
import bodywork_tpu_torch.train.trainer, bodywork_tpu_torch.pipeline.runner
import bodywork_tpu_torch.models.linear
import bodywork_tpu_torch.registry, bodywork_tpu_torch.registry.manager
import bodywork_tpu_torch.registry.gates, bodywork_tpu_torch.registry.shadow
import bodywork_tpu_torch.data.prng, bodywork_tpu_torch.monitor.analytics
import bodywork_tpu_torch.utils.integrity
import bodywork_tpu_torch.train.incremental, bodywork_tpu_torch.models.fused
import bodywork_tpu_torch.serve.predictor, bodywork_tpu_torch.pipeline.stages
import bodywork_tpu_torch.chaos.kill, bodywork_tpu_torch.pipeline.journal
import bodywork_tpu_torch.data.snapshot, bodywork_tpu_torch.utils.shutdown
import bodywork_tpu_torch.obs, bodywork_tpu_torch.obs.registry
import bodywork_tpu_torch.serve.aio, bodywork_tpu_torch.serve.batcher
import bodywork_tpu_torch.serve.admission, bodywork_tpu_torch.serve.app
import bodywork_tpu_torch.obs.tracing, bodywork_tpu_torch.obs.spans
import bodywork_tpu_torch.utils.profiling
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bodywork_tpu"))
print(",".join(bad))
sys.exit(1 if bad else 0)
"""


def test_fresh_process_imports_the_port_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_pyproject_names_every_port_subpackage_and_its_cuda_sources():
    """An installed port must hold every subpackage and the .cu sources
    (and the headers they include) its kernels are built from."""
    import tomllib

    setuptools = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]
    on_disk = {"bodywork_tpu_torch"} | {
        f"bodywork_tpu_torch.{p.parent.name}"
        for p in (ROOT / "bodywork_tpu_torch").glob("*/__init__.py")
    }
    assert on_disk <= set(setuptools["packages"])
    ops = ROOT / "bodywork_tpu_torch" / "ops"
    shipped = {p for pattern in setuptools["package-data"]["bodywork_tpu_torch.ops"]
               for p in ops.glob(pattern)}
    assert list((ops / "csrc").glob("*.cu"))
    assert shipped == set((ops / "csrc").iterdir())  # every source and header


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax_or_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "optax", "bodywork_tpu"}, roots
    # nor the serving dependencies the card's machine does not have
    assert not roots & {"pandas", "werkzeug", "requests", "yaml", "flask"}, roots
