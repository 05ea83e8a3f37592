from bodywork_tpu_torch.traffic.generator import (
    ARRIVAL_PROCESSES,
    Request,
    TrafficConfig,
    generate_request_log,
    read_request_log,
    write_request_log,
)
from bodywork_tpu_torch.traffic.runner import LoadReport, run_open_loop

__all__ = [
    "ARRIVAL_PROCESSES",
    "LoadReport",
    "Request",
    "TrafficConfig",
    "generate_request_log",
    "read_request_log",
    "run_open_loop",
    "write_request_log",
]
