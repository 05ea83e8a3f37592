"""Black-box test the live scoring service with the latest labeled data
(reference ``notebooks/4-test-model-scoring-service.ipynb`` / ``stage_4``),
on the PyTorch/CUDA port (``examples/04_test_model_scoring_service.py`` is
the JAX version).

Scores the newest day's dataset through the service's HTTP API, computes the
live drift metrics (MAPE, score/label correlation, max APE, mean response
time) and persists them under ``test-metrics/``. Failed requests are
*counted* (``n_failures`` column) rather than averaged in as the reference's
``-1`` sentinel was (SURVEY.md known-bug list).

Single mode posts one row per request like the reference's per-row loop;
batch mode posts 512-row chunks that the service pads into captured row
buckets on the card. The metrics print as the JAX script's one-row table.
``--device`` is accepted for symmetry with the other scripts: this one
only talks HTTP and computes on the host.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run


from bodywork_tpu_torch.monitor import HttpScoringClient, run_service_test, scoring_endpoint
from bodywork_tpu_torch.monitor.analytics import format_drift_report
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-example-store"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--url", default="http://localhost:5000")
    p.add_argument("--mode", default="batch", choices=["single", "batch"])
    p.add_argument("--device", default="cuda", help="unused: the test runs on the host")
    args = p.parse_args()

    configure_logger()
    client = HttpScoringClient(scoring_endpoint(args.url, args.mode))
    metrics = run_service_test(open_store(args.store), client, mode=args.mode)
    print(format_drift_report([metrics]))


if __name__ == "__main__":
    main()
