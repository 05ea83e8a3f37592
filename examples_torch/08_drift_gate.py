"""The calibrated drift gate: catching a stale model automatically, on the
PyTorch/CUDA port (``examples/08_drift_gate.py`` is the JAX version).

The reference's drift story ends with an analyst eyeballing longitudinal
metric tables (``model-performance-analytics.ipynb``). This example runs
the failure the gate exists to catch — retraining stops while the
generator's concept drift keeps moving — and shows the verdict firing on
the bias channel, with the reference's own MAPE staying silent (per the
calibration in ``tests/test_monitor.py``, mean APE under this generative
model is near-zero-label tail noise: it cannot see the drift it was
meant to surface).

Timeline (all in one process, seconds on the card):

1. 30 days of history -> train once -> FREEZE the model (simulating a
   broken retrain pipeline) and serve it.
2. 45 more simulated days: each day's drifting data is generated and
   black-box scored through the live service, metrics persisted — the
   live half of the reference's stage 4, unchanged.
3. ``drift_report`` + ``detect_drift``: the baseline-relative bias rule
   (trailing week vs the first-14-days deployment yardstick, z=4) flags
   the days where the alpha swing pulled the frozen model's residual
   mean away from its deployment state.

Run: ``python examples_torch/08_drift_gate.py [--store DIR] [--device cpu]``
"""
import argparse
import sys
from datetime import date, timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
from bodywork_tpu_torch.models import load_model
from bodywork_tpu_torch.monitor import (
    InProcessScoringClient,
    detect_drift,
    drift_report,
    run_service_test,
)
from bodywork_tpu_torch.serve import create_app
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.train import train_on_history
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-drift-gate-example"
HISTORY_DAYS = 30
LIVE_DAYS = 45


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--store", default=DEFAULT_STORE)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args()
    configure_logger("WARNING")  # keep the story readable
    store = open_store(args.store)
    start = date(2026, 1, 1)

    # 1. history -> train -> freeze
    for k in range(HISTORY_DAYS):
        d = start + timedelta(days=k)
        X, y = generate_day(d, device=args.device)
        persist_dataset(store, Dataset(X, y, d))
    train_on_history(store, "linear", device=args.device)
    model, model_date = load_model(store, device=args.device)
    app = create_app(model, model_date, warmup=True)
    client = InProcessScoringClient(app)
    print(f"trained through {model_date}; retraining now STOPS "
          f"(the failure the gate exists to catch)")

    # 2. the world keeps drifting; the frozen service keeps answering
    for k in range(HISTORY_DAYS, HISTORY_DAYS + LIVE_DAYS):
        d = start + timedelta(days=k)
        X, y = generate_day(d, device=args.device)
        persist_dataset(store, Dataset(X, y, d))
        run_service_test(store, client, mode="batch")
    print(f"scored {LIVE_DAYS} live days against the frozen model")

    # 3. the verdict
    report = drift_report(store)
    verdict = detect_drift(report)
    assert verdict["drifted"], "calibrated gate failed to fire"
    first = verdict["first_flagged_date"]
    live_day = (
        date.fromisoformat(str(first))
        - (start + timedelta(days=HISTORY_DAYS))
    ).days + 1
    print(
        f"DRIFT detected: {len(verdict['flagged_dates'])}/"
        f"{verdict['n_days']} day(s) flagged, first {first} "
        f"(live day {live_day}) — the bias rule caught the alpha swing"
    )

    # the reference's own statistic stays silent on the same report: the
    # calibration that made the MAPE-ratio rule opt-in, demonstrated
    no_bias = detect_drift(report, bias_z=float("inf"))
    print(
        "without the bias channel the verdict would be: "
        f"drifted={no_bias['drifted']} — the reference's metrics cannot "
        "see the reference's drift"
    )
    # a CI/CronJob gates on CURRENT state, not all-time history:
    recent = detect_drift(report, window=7)
    print(
        f"gate over the last 7 days: drifted={recent['drifted']} "
        f"({len(recent['flagged_dates'])} flagged) -> exit 4 via "
        "`report --fail-on-drift --window 7`"
    )


if __name__ == "__main__":
    main()
