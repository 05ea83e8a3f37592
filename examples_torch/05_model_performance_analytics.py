"""Longitudinal model-performance analytics (reference
``notebooks/model-performance-analytics.ipynb``), on the PyTorch/CUDA port
(``examples/05_model_performance_analytics.py`` is the JAX version).

Joins the full ``model-metrics/`` (train-time) and ``test-metrics/``
(live-service) histories by date. The widening gap between ``MAPE_train``
and ``MAPE_live`` across simulated days is the concept-drift signal the
whole pipeline exists to surface: the deployed model was trained through
yesterday, the live data keeps drifting. The port's report is a list of
rows (no pandas), printed as the JAX script's fixed-width table.
``--device`` is accepted for symmetry with the other scripts: the report
is host arithmetic.
"""
import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run


from bodywork_tpu_torch.monitor import drift_report
from bodywork_tpu_torch.monitor.analytics import format_drift_report
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-example-store"


def _present(value) -> bool:
    return value is not None and not (isinstance(value, float) and math.isnan(value))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--plot", default=None, metavar="OUT.png",
                   help="also render the drift dashboard PNG (the visual "
                        "half of the reference notebook)")
    p.add_argument("--device", default="cuda", help="unused: the report runs on the host")
    args = p.parse_args()

    configure_logger()
    store = open_store(args.store)
    report = drift_report(store)
    if not report:
        print("no metric history yet - run the pipeline first")
        return
    cols = [c for c in report[0] if c == "date" or c.startswith(("MAPE", "r_squared", "mean_response"))]
    print(format_drift_report([{c: row[c] for c in cols} for row in report]))
    if {"MAPE_train", "MAPE_live"} <= set(report[0]):
        gap = [row["MAPE_live"] - row["MAPE_train"] for row in report
               if _present(row["MAPE_live"]) and _present(row["MAPE_train"])]
        if gap:
            print(f"\nmean live-vs-train MAPE gap over {len(gap)} day(s): {sum(gap) / len(gap):+.4f}")
    if args.plot:
        from bodywork_tpu_torch.monitor import render_drift_dashboard

        print(f"dashboard: {render_drift_dashboard(store, args.plot, report=report)}")


if __name__ == "__main__":
    main()
