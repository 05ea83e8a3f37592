"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package — neither at run time (a fresh subprocess) nor in its source
(a static scan)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = (sorted((ROOT / "bodywork_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + EXAMPLES)

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
import bodywork_tpu_torch.traffic, bodywork_tpu_torch.serve.reload
import bodywork_tpu_torch.ops.slo, bodywork_tpu_torch.chaos.plan
import bodywork_tpu_torch.chaos.canary, bodywork_tpu_torch.pipeline.ab
import bodywork_tpu_torch.audit, bodywork_tpu_torch.audit.fsck, bodywork_tpu_torch.audit.repair
import bodywork_tpu_torch.audit.manifest, bodywork_tpu_torch.tenancy
import bodywork_tpu_torch.store.resilient, bodywork_tpu_torch.store.gcs
import bodywork_tpu_torch.chaos.store, bodywork_tpu_torch.chaos.http
import bodywork_tpu_torch.chaos.sim, bodywork_tpu_torch.chaos.bitrot
import bodywork_tpu_torch.pipeline._yaml, bodywork_tpu_torch.pipeline.spec
import bodywork_tpu_torch.pipeline.images, bodywork_tpu_torch.pipeline.k8s
import bodywork_tpu_torch.pipeline.k8s_schema, bodywork_tpu_torch.pipeline.k8s_validate
import bodywork_tpu_torch.utils.errors
import bodywork_tpu_torch.tune, bodywork_tpu_torch.tune.config, bodywork_tpu_torch.tune.collect
import bodywork_tpu_torch.tune.costmodel, bodywork_tpu_torch.tune.model
import bodywork_tpu_torch.tune.online, bodywork_tpu_torch.registry.configlog
import bodywork_tpu_torch.tenancy.namespace, bodywork_tpu_torch.tenancy.scenarios
import bodywork_tpu_torch.tenancy.scheduler, bodywork_tpu_torch.tenancy.stacked
import bodywork_tpu_torch.tenancy.fleet, bodywork_tpu_torch.utils.sync
import bodywork_tpu_torch.obs.multiproc, bodywork_tpu_torch.serve.multiproc
import bodywork_tpu_torch.serve.rowqueue, bodywork_tpu_torch.serve.netqueue
import bodywork_tpu_torch.serve.leadership, bodywork_tpu_torch.serve.frontend
import bodywork_tpu_torch.serve.dispatch, bodywork_tpu_torch.serve.httpcore
import bodywork_tpu_torch.parallel, bodywork_tpu_torch.parallel.mesh
import bodywork_tpu_torch.parallel.collectives, bodywork_tpu_torch.parallel.sharding
import bodywork_tpu_torch.parallel.train_step
import bodywork_tpu_torch.utils.compile_cache, bodywork_tpu_torch.utils.watchdog
import chip_smoke
# the port's examples, loaded as modules (their main() not run)
import importlib.util, pathlib
for path in sorted(pathlib.Path("examples_torch").glob("*.py")):
    spec = importlib.util.spec_from_file_location("example_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
# nor pyyaml, jsonschema, matplotlib, sentry_sdk, pandas or flask: the port
# runs on the standard library, numpy and torch alone
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bodywork_tpu", "yaml", "jsonschema",
                                    "matplotlib", "sentry_sdk", "pandas", "flask"))
print(",".join(bad))
sys.exit(1 if bad else 0)
"""


def test_the_port_has_its_eight_examples():
    assert [p.name[:3] for p in EXAMPLES] == [f"{i:02d}_" for i in range(1, 9)]


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
    assert not roots & {"pandas", "werkzeug", "requests", "yaml", "flask", "jsonschema"}, roots


def _module_level_roots(path: Path) -> set[str]:
    """Roots imported at module level (outside any function or class)."""
    roots = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_libraries_are_imported_only_where_used(path):
    """matplotlib (the dashboard) and sentry_sdk (error monitoring) load
    lazily, inside the function that needs them."""
    assert not _module_level_roots(path) & {"matplotlib", "sentry_sdk"}


#: the test stage's run-stage chain, which its pod runs with no torch
_TORCH_FREE = ["cli.py", "pipeline/__init__.py", "pipeline/runner.py", "pipeline/stages.py",
               "pipeline/spec.py", "pipeline/_yaml.py", "pipeline/images.py",
               "pipeline/k8s.py", "pipeline/k8s_schema.py", "pipeline/k8s_validate.py",
               "pipeline/ab.py", "pipeline/journal.py", "monitor/__init__.py",
               "monitor/tester.py", "monitor/analytics.py", "data/__init__.py", "data/io.py",
               "utils/errors.py",
               # the control plane the serve stage's boot, fsck and the cli
               # parser import: the probe loads torch inside its call
               "tune/__init__.py", "tune/config.py", "tune/collect.py",
               "tune/costmodel.py", "tune/model.py", "tune/online.py",
               "registry/configlog.py",
               # the journal's tenant field and the cli's store scoping reach
               # the tenancy's torch-free surface; the replica supervisor's
               # module loads torch only inside the spawned worker
               "tenancy/__init__.py", "tenancy/namespace.py", "tenancy/scenarios.py",
               "tenancy/scheduler.py", "utils/sync.py", "obs/multiproc.py",
               "serve/multiproc.py",
               # the disaggregated front end's stack (serve --frontends): the
               # dispatcher's module loads torch only inside the spawned
               # dispatcher
               "serve/__init__.py", "serve/wire.py", "serve/httpcore.py",
               "serve/admission.py", "serve/batcher.py", "serve/app.py", "serve/aio.py",
               "serve/rowqueue.py", "serve/netqueue.py", "serve/leadership.py",
               "serve/frontend.py", "serve/dispatch.py"]


@pytest.mark.parametrize("name", _TORCH_FREE)
def test_the_test_stage_chain_imports_no_torch_at_module_level(name):
    assert "torch" not in _module_level_roots(ROOT / "bodywork_tpu_torch" / name)


def test_the_control_plane_imports_neither_torch_nor_jax_in_a_fresh_process():
    """``tune.*`` and ``registry.configlog`` (ROADMAP Queue 1 item 17) load
    with the standard library alone: no torch, numpy only where a fit or
    an ingest runs, no jax and nothing of the JAX package."""
    probe = ("import sys\n"
             "import bodywork_tpu_torch.tune.config, bodywork_tpu_torch.tune.collect\n"
             "import bodywork_tpu_torch.tune.costmodel, bodywork_tpu_torch.tune.model\n"
             "import bodywork_tpu_torch.tune.online, bodywork_tpu_torch.registry.configlog\n"
             "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'bodywork_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_the_tenancy_surface_imports_neither_torch_nor_jax_in_a_fresh_process():
    """The tenancy package's re-exports (namespace, scenarios, scheduler),
    the device fence and the metrics aggregation load without torch, as the
    JAX package's tenancy surface loads without jax."""
    probe = ("import sys\n"
             "import bodywork_tpu_torch.tenancy, bodywork_tpu_torch.tenancy.namespace\n"
             "import bodywork_tpu_torch.tenancy.scenarios, bodywork_tpu_torch.tenancy.scheduler\n"
             "import bodywork_tpu_torch.utils.sync, bodywork_tpu_torch.obs.multiproc\n"
             "print(','.join(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'bodywork_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
