"""The port's public surface is the JAX package's, name for name.

Every ``bodywork_tpu/**/*.py`` is parsed with ``ast`` (nothing of it is
imported, so no JAX) and its public names are collected: the top-level
defs, classes and assignments (a module's logger, ``log =
get_logger(...)``, is not surface), each public class's public methods
and class attributes (dataclass fields included), the ``__all__``
entries, and in a package ``__init__`` the names it re-exports from the
package itself (third-party imports are left out). Each name must then
resolve in the port's module of the same dotted path (``getattr``, so a
re-export counts), or :data:`COUNTERPARTS` must name it: a dotted port
name that resolves (a class's entry covers its methods, looked up under
their own names on the port's class), or a reason, which is any value
that is not a port name. A JAX file with no port module needs a
file-level entry, ``(module, None)``.

A stale entry fails too: one whose JAX name is gone, or whose JAX
spelling now resolves in the port. The CLI case holds the two parsers
command by command: every JAX flag must be a port flag, and the port's
extra flags are the known few in :data:`PORT_ONLY_FLAGS`.

A failure names the JAX module and the names it could not place. Port
the name under the JAX spelling where the port has the capability, add a
``COUNTERPARTS`` entry where the port's name differs, or give the reason
it has no counterpart.
"""
import argparse
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "bodywork_tpu"
JAX_PREFIX, PORT_PREFIX = "bodywork_tpu", "bodywork_tpu_torch"

PANDAS = "pandas: the port uses no pandas (ROADMAP); its tables are numpy"
CPU_SWITCH = ("switches a live process to the CPU: the port's entry points never "
              "fall back to the CPU behind the caller's back")
XLA_PACKING = ("XLA's one-transfer packing of params and metrics into one vector: the "
               "port's fit leaves its params on the card and fetches only the metrics, "
               "as one stacked list (Regressor.evaluate)")
TPU_TOPOLOGY = ("a TPU slice's chip grid for GKE's gke-tpu-topology node label: a GPU "
                "node has no such label, and a pod asks for its cards by count "
                "(ResourceSpec.gpu_count)")
TPU_LANE = ("the TPU's 128-wide vector lane the Pallas kernel pads every width to: "
            "each CUDA kernel pads to its own tile (ops.mlp_kernel.padded_widths)")
PREWARM = ("XLA compile prewarm: the port compiles no program per row bucket, and "
           "on an H100 the first fit at a row bucket new to the process reads within "
           "the spread of fits at buckets it has met (PERF.md section 6)")

#: (JAX module, public name or None for the whole file) -> a dotted port
#: name, or the reason the port has no counterpart
COUNTERPARTS = {
    # TPU and XLA machinery whose counterpart has another name
    ("bodywork_tpu.serve", "EXECUTABLE_CACHE"): "bodywork_tpu_torch.serve.GRAPH_CACHE",
    ("bodywork_tpu.serve.predictor", "EXECUTABLE_CACHE"):
        "bodywork_tpu_torch.serve.predictor.GRAPH_CACHE",
    ("bodywork_tpu.serve.predictor", "ExecutableCache"):
        "bodywork_tpu_torch.serve.predictor.GraphCache",
    ("bodywork_tpu.serve.predictor", "PallasMLPPredictor"):
        "bodywork_tpu_torch.serve.predictor.KernelMLPPredictor",
    # the bf16 XLA apply: the MLP's apply with compute_dtype="bfloat16"
    ("bodywork_tpu.serve.predictor", "bf16_mlp_apply"): "bodywork_tpu_torch.models.mlp.mlp_apply",
    ("bodywork_tpu.serve.server", "PALLAS_AUTO_MIN_WIDTH"):
        "bodywork_tpu_torch.serve.server.KERNEL_AUTO_MIN_WIDTH",
    ("bodywork_tpu.ops", "make_pallas_mlp_apply"): "bodywork_tpu_torch.ops.make_kernel_mlp_apply",
    ("bodywork_tpu.ops.mlp_kernel", "make_pallas_mlp_apply"):
        "bodywork_tpu_torch.ops.mlp_kernel.make_kernel_mlp_apply",
    ("bodywork_tpu.pipeline.spec", "ResourceSpec.tpu_accelerator"):
        "bodywork_tpu_torch.pipeline.spec.ResourceSpec.gpu_accelerator",
    ("bodywork_tpu.pipeline.spec", "ResourceSpec.tpu_chips"):
        "bodywork_tpu_torch.pipeline.spec.ResourceSpec.gpu_count",
    ("bodywork_tpu.pipeline.spec", "ResourceSpec.tpu_hosts"):
        "bodywork_tpu_torch.pipeline.spec.ResourceSpec.gpu_hosts",
    ("bodywork_tpu.models.fused", "metrics_dict"): "bodywork_tpu_torch.models.metrics.metrics_dict",
    # TPU and XLA machinery with no counterpart on a GPU
    ("bodywork_tpu.models.fused", "pack_tree_with_tail"): XLA_PACKING,
    ("bodywork_tpu.models.fused", "unpack_tree_with_tail"): XLA_PACKING,
    ("bodywork_tpu.pipeline.spec", "ResourceSpec.tpu_topology"): TPU_TOPOLOGY,
    ("bodywork_tpu.ops.mlp_kernel", "LANE"): TPU_LANE,
    # no counterpart, by the port's own rules
    ("bodywork_tpu.data", "generate_dataframe"): PANDAS,
    ("bodywork_tpu.data.generator", "generate_dataframe"): PANDAS,
    ("bodywork_tpu.data.io", "Dataset.from_dataframe"): PANDAS,
    ("bodywork_tpu.data.io", "Dataset.to_dataframe"): PANDAS,
    ("bodywork_tpu.utils.watchdog", "force_cpu_platform"): CPU_SWITCH,
    ("bodywork_tpu.train.prewarm", None): PREWARM,
    ("bodywork_tpu.train", "prewarm_async"): PREWARM,
    ("bodywork_tpu.obs.spans", "CATEGORY_PREWARM"): PREWARM,
    ("bodywork_tpu.pipeline.stages", "StageContext.persistent_process"): PREWARM,
}

#: flags the port's CLI has and the JAX CLI lacks: where to run, the MLP's
#: fit settings, the standby's lease TTL, the test stage's row cap, the
#: generate-beside-serve DAG and ``generate --days``
PORT_ONLY_FLAGS = {"--device", "--mlp-hidden", "--mlp-lr", "--mlp-steps", "--leader-ttl",
                   "--max-rows", "--overlap-generate", "--days"}


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_FILES = {_module_name(p): p for p in sorted(JAX_ROOT.rglob("*.py"))}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _is_logger(value: ast.expr) -> bool:
    return (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id == "get_logger")


def _targets(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _all_entries(value: ast.expr, assigns: dict) -> list[str]:
    """``__all__ = [...]`` or ``sorted(NAME)`` of a top-level dict or list."""
    if isinstance(value, ast.Call) and value.args and isinstance(value.args[0], ast.Name):
        value = assigns[value.args[0].id]
    items = value.keys if isinstance(value, ast.Dict) else value.elts
    return [item.value for item in items]


def jax_names(path: Path) -> set[str]:
    """The public names of one JAX file (see the module docstring)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assigns = {name: node.value for node in tree.body if isinstance(node, ast.Assign)
               for name in _targets(node)}
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            names.add(node.name)
            for member in node.body:
                if isinstance(member, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members = [member.name]
                elif isinstance(member, (ast.Assign, ast.AnnAssign)):
                    members = _targets(member)
                else:
                    members = []
                names.update(f"{node.name}.{m}" for m in members if _public(m))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
            for name in _targets(node):
                if name == "__all__":
                    names.update(_all_entries(node.value, assigns))
                elif _public(name) and not _is_logger(node.value):
                    names.add(name)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level or (node.module or "").split(".")[0] == JAX_PREFIX)):
            names.update(a.asname or a.name for a in node.names if _public(a.asname or a.name))
    return names


def _attribute(obj, name: str):
    """``getattr``, or a dataclass or annotated field of a class."""
    try:
        return getattr(obj, name)
    except AttributeError:
        if isinstance(obj, type) and any(name in getattr(c, "__annotations__", {})
                                         for c in obj.__mro__):
            return None
        raise


def resolve(dotted: str):
    """The object a dotted port name names; raises if it names none."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for part in parts[i:]:
            obj = _attribute(obj, part)
        return obj
    raise ModuleNotFoundError(dotted)


def resolves(dotted: str) -> bool:
    try:
        resolve(dotted)
    except (AttributeError, ModuleNotFoundError):
        return False
    return True


def port_module(jax_module: str) -> str:
    return PORT_PREFIX + jax_module[len(JAX_PREFIX):]


def is_port_name(value: str) -> bool:
    return value.startswith(PORT_PREFIX + ".")


def _placed(module: str, name: str) -> str | None:
    """Why ``name`` of ``module`` is accounted for, or None."""
    if resolves(f"{port_module(module)}.{name}"):
        return "same name"
    entry = COUNTERPARTS.get((module, name))
    if entry is None and "." in name:  # a method of a class with a counterpart
        cls, member = name.split(".", 1)
        target = COUNTERPARTS.get((module, cls))
        if target is not None:
            entry = f"{target}.{member}" if is_port_name(target) else target
    if entry is None:
        return None
    if is_port_name(entry):
        return "counterpart" if resolves(entry) else None
    return "reason"


@pytest.mark.parametrize("module", sorted(JAX_FILES))
def test_every_public_name_has_a_counterpart(module):
    file_entry = COUNTERPARTS.get((module, None))
    if file_entry is not None and not is_port_name(file_entry):
        return  # the whole file has a reason
    if not resolves(port_module(module)):
        pytest.fail(f"{module} has no port module {port_module(module)} and no "
                    "file-level COUNTERPARTS entry")
    unplaced = sorted(n for n in jax_names(JAX_FILES[module]) if _placed(module, n) is None)
    assert not unplaced, (f"{module}: no counterpart in {port_module(module)} and no "
                          f"COUNTERPARTS entry for {unplaced}")


@pytest.mark.parametrize("key", sorted(COUNTERPARTS, key=lambda k: (k[0], k[1] or "")),
                         ids=lambda k: f"{k[0]}:{k[1] or '<file>'}")
def test_no_counterparts_entry_is_stale(key):
    module, name = key
    entry = COUNTERPARTS[key]
    assert module in JAX_FILES, f"{module} is gone from the JAX package"
    if name is None:
        assert not resolves(port_module(module)), (
            f"{port_module(module)} now exists: drop the file-level entry")
    else:
        assert name in jax_names(JAX_FILES[module]), f"{module}.{name} is gone"
        assert not resolves(f"{port_module(module)}.{name}"), (
            f"{port_module(module)}.{name} now exists under the JAX spelling")
    if is_port_name(entry):
        assert resolves(entry), f"the counterpart {entry} does not resolve"
    else:
        assert entry.strip(), "a reason must say something"


def test_the_collector_sees_each_kind_of_public_name():
    """The collector's rules on the JAX files they were written for."""
    serve = jax_names(JAX_FILES["bodywork_tpu.serve"])  # __all__ = sorted(_EXPORTS)
    assert {"create_app", "EXECUTABLE_CACHE"} <= serve
    utils = jax_names(JAX_FILES["bodywork_tpu.utils"])  # a package's re-exports
    assert {"StageError", "fence", "abort_if_backend_hangs"} <= utils
    app = jax_names(JAX_FILES["bodywork_tpu.serve.app"])  # methods and properties
    assert {"ScoringApp.test_client", "ScoringApp.served_bundle", "create_app"} <= app
    spec = jax_names(JAX_FILES["bodywork_tpu.pipeline.spec"])  # dataclass fields
    assert "ResourceSpec.tpu_chips" in spec
    cli = jax_names(JAX_FILES["bodywork_tpu.cli"])  # no logger, no private name
    assert "log" not in cli and "main" in cli and not any(n.startswith("_") for n in cli)
    assert _placed("bodywork_tpu.serve.predictor", "ExecutableCache.stats") == "counterpart"
    assert _placed("bodywork_tpu.serve.app", "ScoringApp.no_such_method") is None


def _flags(parser: argparse.ArgumentParser, path=()) -> dict:
    """Command path -> its option strings (positionals as ``<dest>``)."""
    out, flags = {}, set()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, child in action.choices.items():
                out.update(_flags(child, path + (name,)))
        elif action.option_strings:
            flags.update(action.option_strings)
        elif action.dest != "help":
            flags.add(f"<{action.dest}>")
    out[path] = flags
    return out


def _cli_flags():
    from bodywork_tpu import cli as jax_cli
    from bodywork_tpu_torch import cli as port_cli

    return _flags(jax_cli.build_parser()), _flags(port_cli.build_parser())


JAX_COMMANDS = sorted(_cli_flags()[0])


@pytest.mark.parametrize("command", JAX_COMMANDS, ids=lambda c: " ".join(c) or "<top>")
def test_every_jax_flag_is_a_port_flag(command):
    jax_flags, port_flags = _cli_flags()
    assert command in port_flags, f"the port's CLI has no command {' '.join(command)!r}"
    missing = jax_flags[command] - port_flags[command]
    assert not missing, f"{' '.join(command) or 'top level'}: port lacks {sorted(missing)}"
    extra = port_flags[command] - jax_flags[command] - PORT_ONLY_FLAGS
    assert not extra, f"{' '.join(command) or 'top level'}: unknown port-only {sorted(extra)}"


def test_the_port_has_no_command_the_jax_cli_lacks():
    jax_flags, port_flags = _cli_flags()
    assert sorted(port_flags) == sorted(jax_flags)
