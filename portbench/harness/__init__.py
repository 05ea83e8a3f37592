"""The harness: runs one cell through the driver its traffic mix names,
reads the per-layer metrics, and prints the result line.

The result is the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number that decided ``correct`` beside its limit. The
same checks are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import subprocess
import sys

from portbench.harness import spec

#: top-level module names that no run may hold once its window has
#: closed: JAX, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bodywork_tpu")


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its configuration and traffic
    mix (the files' contents), the run's arguments, the monotonic clock
    at the process's start, and the device (``cuda``; the CPU only in
    the CPU tests, which call :func:`run_cell` directly)."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    start: float
    device: str = "cuda"


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``checks`` maps a short name to ``{"value",
    "limit"}``; ``correct`` holds only where every value is at most its
    limit. ``layer`` is what the per-layer readers read."""

    e2e: dict
    layer: dict
    attempted: int
    failed: int
    checks: dict
    device: dict
    breakdown: dict | None = None
    notes: list = dataclasses.field(default_factory=list)
    #: a fault that makes the run not correct whatever its checks read
    fault: str | None = None

    @property
    def correct(self) -> bool:
        return self.fault is None and all(
            c["value"] <= c["limit"] for c in self.checks.values())


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, each
    module's name cut at its first dot and compared whole."""
    names = {m.split(".")[0] for m in list(sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def card_power_limit(index: int = 0) -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def clean_environment() -> None:
    """Settings the run and every process it starts inherit: none of the
    port's own ``BODYWORK_TPU_*`` variables (each cell states its
    settings), and the build caches of PyTorch and Triton at fixed
    directories inside the checkout (the port builds its kernels into the
    checkout's ``build/torch_kernels``); the port's log on standard
    error."""
    for key in [k for k in os.environ if k.startswith("BODYWORK_TPU_")]:
        del os.environ[key]
    # the port logs to stdout unless its logger already has a handler:
    # standard output carries the result line alone
    port_log = logging.getLogger("bodywork_tpu_torch")
    if not port_log.handlers:
        port_log.addHandler(logging.StreamHandler(sys.stderr))
    cache = spec.ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced run")
    return p


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, start: float,
             device: str = "cuda", config_overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> tuple[int, dict | None]:
    """Run cell ``name`` and print its result; returns ``(exit code,
    result)``. The overrides shrink a cell for the CPU tests."""
    cell = spec.cell(bench, name)
    cfg = {**spec.config(bench, cell["config"]), **(config_overrides or {})}
    trf = {**spec.traffic(cell["traffic"]), **(traffic_overrides or {})}
    # a seed of any sign and size, as the generators take it
    ctx = Context(cell, cfg, trf, seed % 2**64, seconds, bool(trace), start, device)
    out = spec.driver(trf).run(ctx)
    return report(bench, ctx, out)


def finite(value):
    """``value`` with every non-finite float (a tail past the answered
    requests) as null, so that the result line is strict JSON."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    return value


def report(bench: dict, ctx: Context, out: Outcome) -> tuple[int, dict | None]:
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"portbench: forbidden modules loaded: {forbidden}", file=sys.stderr)
        return 4, None
    name = ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for m in spec.cell_metrics(bench, name, "per_layer"):
            value = spec.reader(m["name"]).read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.cell_metrics(bench, name, "end_to_end"):
            if m["name"] not in out.e2e:
                print(f"portbench: the driver measured no {m['name']}", file=sys.stderr)
                return 5, None
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": out.device}
    if ctx.trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = out.checks
    for line in out.notes:
        print(line, file=sys.stderr)
    if out.fault is not None:
        print(f"fault: {out.fault}", file=sys.stderr)
    for key, c in out.checks.items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0, result


def main(argv, start: float) -> int:
    args = _parser().parse_args(argv)
    clean_environment()
    bench = spec.with_parked(spec.load_benchmark())
    cell = spec.cell(bench, args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    code, _result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             start)
    return code
