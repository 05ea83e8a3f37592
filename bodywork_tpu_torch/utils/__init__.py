from bodywork_tpu_torch.utils.logging import configure_logger
from bodywork_tpu_torch.utils.dates import (
    DATE_PATTERN,
    date_from_key,
    day_of_year,
    parse_date,
)
from bodywork_tpu_torch.utils.errors import StageError, init_error_monitoring
from bodywork_tpu_torch.utils.sync import fence
from bodywork_tpu_torch.utils.watchdog import abort_if_backend_hangs, backend_timeout_from_env

__all__ = [
    "abort_if_backend_hangs",
    "backend_timeout_from_env",
    "configure_logger",
    "DATE_PATTERN",
    "date_from_key",
    "day_of_year",
    "fence",
    "parse_date",
    "init_error_monitoring",
    "StageError",
]
