"""Environment-variable parsing for operational knobs (a copy of
``bodywork_tpu.utils.env``)."""
from __future__ import annotations

import math
import os

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("utils.env")

__all__ = ["bucket_list", "number_env", "positive_float_env"]


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


def number_env(name: str, cast, minimum, warn=None):
    """A deployed number knob ``cast(raw) >= minimum`` from ``name``, or
    None when it is unset, malformed or out of range; the last two are
    ignored with a warning (``warn``, the logger's by default), never a
    crashed entry point."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        value = cast(raw)
    except ValueError:
        value = None
    if value is None or value < minimum:
        (warn or log.warning)(f"ignoring {name}={raw!r} (need a number >= {minimum})")
        return None
    return value


def bucket_list(raw: str) -> tuple[int, ...]:
    """Serving buckets from comma-separated positive ints; ValueError
    otherwise."""
    try:
        buckets = tuple(int(b) for b in raw.split(",") if b.strip())
    except ValueError:
        raise ValueError(f"buckets must be comma-separated integers, got {raw!r}") from None
    if not buckets or any(b <= 0 for b in buckets):
        raise ValueError(f"buckets must be positive integers, got {raw!r}")
    return buckets
