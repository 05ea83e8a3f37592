from bodywork_tpu_torch.monitor.tester import (
    HttpScoringClient,
    InProcessScoringClient,
    compute_test_metrics,
    persist_test_metrics,
    run_service_test,
    score_dataset,
    scoring_endpoint,
)
from bodywork_tpu_torch.monitor.analytics import (
    detect_drift,
    drift_report,
    load_metric_history,
    render_drift_dashboard,
)

__all__ = [
    "detect_drift",
    "drift_report",
    "load_metric_history",
    "render_drift_dashboard",
    "HttpScoringClient",
    "InProcessScoringClient",
    "compute_test_metrics",
    "persist_test_metrics",
    "run_service_test",
    "score_dataset",
    "scoring_endpoint",
]
