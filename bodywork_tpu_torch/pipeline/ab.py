"""Concurrent A/B pipelines sharing one device pool (the port of
``bodywork_tpu.pipeline.ab``; BASELINE.json config 5).

N variants (for example two model types) run their daily simulations
concurrently in one process, each on its own thread:

- **store isolation**: each variant writes under ``<root>/<name>/``, so
  the artefact schema never collides;
- **devices**: a pool that divides among the variants is split into
  equal contiguous groups (``parallel.split_devices``), and each
  variant's :class:`LocalRunner` computes on its group's first device,
  worker threads included. A pool that does not divide is shared: on one
  card both variants run on the same H100, their kernels interleaving.
  A serving mesh a variant's spec asks for (``BODYWORK_TPU_MESH_DATA``)
  is built over the process's devices, as in the JAX package.

The process-wide serving graph cache serves every variant. Variants of
one architecture share its weight slot, and a dispatch for the other
variant's checkpoint rebinds its weights first, so each variant's
answers stay its own checkpoint's.

:func:`compare_report` is the JAX function's table without pandas: one
row a (date, variant), sorted by (date, variant), built from
``monitor.analytics.drift_report``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from datetime import date
from pathlib import Path

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.pipeline.runner import DayResult, LocalRunner
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, default_pipeline
from bodywork_tpu_torch.store import ArtefactStore, FilesystemStore
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline.ab")

__all__ = ["PipelineVariant", "VariantResult", "compare_report", "format_compare_report",
           "run_ab_simulation", "variants_from_model_types"]


@dataclasses.dataclass
class PipelineVariant:
    """One arm of a concurrent comparison."""

    name: str
    spec: PipelineSpec
    drift: DriftConfig | None = None


@dataclasses.dataclass
class VariantResult:
    name: str
    results: list[DayResult]
    #: None when the arm failed before its store could be constructed
    store: ArtefactStore | None
    error: BaseException | None = None


def variants_from_model_types(model_types: list[str]) -> list[PipelineVariant]:
    """One variant per model type, e.g. ``["linear", "mlp"]`` -> ``a-linear``,
    ``b-mlp``."""
    return [
        PipelineVariant(
            name=f"{chr(ord('a') + i)}-{mt}",
            spec=default_pipeline(model_type=mt, scoring_mode="batch", overlap_generate=True),
        )
        for i, mt in enumerate(model_types)
    ]


def _device_groups(n_variants: int, devices) -> list:
    """Each variant's device: the first of its group where the pool
    divides evenly, else the pool's first device for every variant."""
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.parallel.mesh import split_devices

    pool = list(devices) if devices is not None else [resolve_device(None)]
    if not pool:
        raise ValueError("an empty device pool")
    if n_variants > 1 and len(pool) % n_variants == 0:
        return [group[0] for group in split_devices(n_variants, pool)]
    if n_variants > 1:
        log.warning(f"{len(pool)} device(s) not partitionable into {n_variants} groups; "
                    "variants share the pool")
    return [pool[0]] * n_variants


def run_ab_simulation(variants: list[PipelineVariant], root: str | Path, start: date,
                      days: int, devices=None) -> dict[str, VariantResult]:
    """Run every variant's ``days``-day simulation concurrently, each
    writing under ``<root>/<variant.name>/``. ``devices`` is a list of
    ``torch.device`` (default: the card alone, so both variants share
    it). Returns the per-variant results; a failed variant carries its
    error rather than stopping its siblings."""
    names = [v.name for v in variants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate variant names: {names}")
    groups = _device_groups(len(variants), devices)
    out: dict[str, VariantResult] = {}

    def _variant_store(name: str):
        from bodywork_tpu_torch.store import open_store

        if isinstance(root, str) and "://" in root:
            return open_store(root.rstrip("/") + "/" + name)
        return FilesystemStore(Path(root) / name)

    def _run(variant: PipelineVariant, device) -> None:
        # a failure anywhere, store construction included, is the
        # variant's error, never a silently missing arm
        store = None
        try:
            store = _variant_store(variant.name)
            runner = LocalRunner(variant.spec, store, drift=variant.drift, device=device)
            results = runner.run_simulation(start, days)
            out[variant.name] = VariantResult(variant.name, results, store)
        except BaseException as exc:
            log.error(f"variant {variant.name} failed: {exc!r}")
            out[variant.name] = VariantResult(variant.name, [], store, exc)

    threads = [threading.Thread(target=_run, args=(v, d), name=f"pipeline-{v.name}")
               for v, d in zip(variants, groups)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _column_order(store, columns: list) -> None:
    """Append the store's metric columns to ``columns`` in the JAX
    report's order: the train metrics' CSV columns, then the live ones,
    each suffixed."""
    from bodywork_tpu_torch.monitor.analytics import _load_history
    from bodywork_tpu_torch.store.schema import MODEL_METRICS_PREFIX, TEST_METRICS_PREFIX

    for prefix, suffix in ((MODEL_METRICS_PREFIX, "_train"), (TEST_METRICS_PREFIX, "_live")):
        for row in _load_history(store, prefix):
            for name in row:
                if name != "date" and name + suffix not in columns:
                    columns.append(name + suffix)


def compare_report(results: dict[str, VariantResult]) -> list[dict]:
    """Side by side drift report: one row a (date, variant), sorted by
    (date, variant), with ``variant``, ``date`` and every ``drift_report``
    column in the JAX DataFrame's order (None where a side has no value);
    failed variants are left out."""
    from bodywork_tpu_torch.monitor.analytics import drift_report

    rows, columns = [], []
    for name, vr in results.items():
        if vr.error is not None:
            continue
        rows.extend({"variant": name, **row} for row in drift_report(vr.store))
        _column_order(vr.store, columns)
    rows = [{"variant": r["variant"], "date": r["date"], **{c: r.get(c) for c in columns}}
            for r in rows]
    return sorted(rows, key=lambda r: (r["date"], r["variant"]))


def _cell(value) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return "NaN"
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def format_compare_report(rows: list[dict]) -> str:
    """The report as a fixed-width text table, right-aligned, a header
    line and one line a row (empty string for no rows)."""
    if not rows:
        return ""
    columns = list(rows[0])
    cells = [[_cell(row.get(c)) for c in columns] for row in rows]
    widths = [max(len(c), *(len(r[i]) for r in cells)) for i, c in enumerate(columns)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(r, widths)) for r in cells]
    return "\n".join(lines)
