"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The configuration's entry names its file; a traffic mix is
``traffic/<name>.json`` and names the driver (``drivers/<driver>.py``)
that runs it; a per-layer metric is ``metrics/<name>.py``, a module with
``read(layer) -> float | None``.

``parked.json`` holds, in the same shape, cells that were measured and
left out of ``BENCHMARK.json`` (its ``left_out`` says why), with the
configurations and metrics only they use: :func:`with_parked` adds them,
so that a run can name a parked cell and the CPU tests keep its driver
and readers working until a later change brings it back.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

#: the checkout's root (``BENCHMARK.json``'s directory)
ROOT = Path(__file__).resolve().parents[2]
#: this benchmark's directory
HOME = ROOT / "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def with_parked(bench: dict, home: Path = HOME) -> dict:
    """``bench`` with the parked cells' entries after its own."""
    parked = json.loads((home / "parked.json").read_text())
    return {**bench, **{k: bench[k] + parked.get(k, [])
                        for k in ("configs", "workloads", "end_to_end", "per_layer")}}


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's entry joined with its file's contents."""
    entry = _named(bench["configs"], name, "configuration")
    return {**json.loads((root / entry["file"]).read_text()), "name": name}


def traffic(name: str, home: Path = HOME) -> dict:
    return {**json.loads((home / "traffic" / f"{name}.json").read_text()), "name": name}


def driver(traffic_doc: dict):
    """The driver module a traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{traffic_doc['driver']}")


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric is reported in a cell: every cell, unless the
    metric lists its cells under ``workloads``."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[kind] if applies(m, cell_name)]


def reader(name: str, home: Path = HOME):
    """A per-layer metric's reader, ``metrics/<name>.py``, loaded by its
    path (metric names hold dots, which a module name cannot)."""
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
