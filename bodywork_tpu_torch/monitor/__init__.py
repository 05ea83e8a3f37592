from bodywork_tpu_torch.monitor.tester import (
    HttpScoringClient,
    InProcessScoringClient,
    compute_test_metrics,
    persist_test_metrics,
    run_service_test,
    score_dataset,
    scoring_endpoint,
)

__all__ = [
    "HttpScoringClient",
    "InProcessScoringClient",
    "compute_test_metrics",
    "persist_test_metrics",
    "run_service_test",
    "score_dataset",
    "scoring_endpoint",
]
