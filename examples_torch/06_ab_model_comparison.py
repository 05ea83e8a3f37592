"""Concurrent A/B model comparison (beyond-reference capability), on the
PyTorch/CUDA port (``examples/06_ab_model_comparison.py`` is the JAX
version).

The reference can only compare models by deploying two separate Bodywork
projects. Here two full train->serve->generate->test pipelines — a linear
regressor vs an MLP — run concurrently in one process on one card, each
in its own store namespace. The output is a side-by-side drift report:
which model's live MAPE degrades slower under the same concept drift.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

from datetime import date

from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.pipeline import (
    compare_report,
    format_compare_report,
    run_ab_simulation,
    variants_from_model_types,
)
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_ROOT = "/tmp/bodywork-tpu-torch-ab-example"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=DEFAULT_ROOT,
                   help="parent dir; each variant gets a namespace inside")
    p.add_argument("--days", type=int, default=7)
    p.add_argument("--start", default="2026-01-01")
    p.add_argument("--models", default="linear,mlp")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args()

    configure_logger()
    variants = variants_from_model_types(args.models.split(","))
    results = run_ab_simulation(
        variants, args.root, date.fromisoformat(args.start), args.days,
        devices=[resolve_device(args.device)],
    )
    for name, vr in results.items():
        if vr.error is not None or not vr.results:
            continue  # reported after the table, like `cli run-ab`
        steady = [r.wall_clock_s for r in vr.results[1:]] or [
            vr.results[0].wall_clock_s
        ]
        print(f"{name}: {sum(steady) / len(steady):.3f}s/day steady-state")

    report = compare_report(results)
    if report:
        cols = ["variant", "date", "MAPE_train", "MAPE_live", "r_squared_live"]
        print(format_compare_report([{c: row[c] for c in cols if c in row} for row in report]))
    failed = [vr for vr in results.values() if vr.error is not None]
    for vr in failed:
        print(f"variant {vr.name} FAILED: {vr.error!r}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
