"""Environment-variable parsing for operational knobs (a copy of
``bodywork_tpu.utils.env``)."""
from __future__ import annotations

import math
import os

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("utils.env")

__all__ = ["positive_float_env"]


def positive_float_env(name: str, default: float) -> float:
    """A finite float > 0 from ``name``, or ``default``: garbage (and NaN,
    which every ``<= 0`` check passes) is ignored with a warning rather
    than crashing the entry point."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        value = None
    if value is None or not (value > 0) or not math.isfinite(value):
        log.warning(f"ignoring {name}={raw!r} (need a finite number > 0)")
        return default
    return value
