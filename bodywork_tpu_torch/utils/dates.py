"""Date-key utilities for artefact versioning (a copy of
``bodywork_tpu.utils.dates``).

Every artefact is versioned by a date embedded in its key, the
reference's protocol (``stage_1_train_model.py:47``); both packages parse
keys with the same grammar, so each reads the other's store.
"""
from __future__ import annotations

import re
from datetime import date, datetime, timedelta
from functools import lru_cache

# Same date grammar as the reference's regex: years 2020-2099.
DATE_PATTERN = re.compile(r"20[2-9][0-9]-[0-1][0-9]-[0-3][0-9]")


def parse_date(date_string: str) -> date:
    return datetime.strptime(date_string, "%Y-%m-%d").date()


@lru_cache(maxsize=8192)
def date_from_key(key: str) -> date | None:
    """The (first) embedded date of an artefact key, or None when there
    is no date-shaped substring or it is not a real calendar date.
    Memoised: keys are immutable strings and ``history()`` re-parses its
    whole listing on every call."""
    match = DATE_PATTERN.search(key)
    if match is None:
        return None
    try:
        return parse_date(match.group(0))
    except ValueError:
        return None


def day_of_year(d: date) -> int:
    """1-based day-of-year, as used by the drift sinusoid (``stage_3:38``)."""
    return d.timetuple().tm_yday


def date_range(start: date, days: int) -> list[date]:
    """``days`` consecutive dates starting at ``start`` (simulated days)."""
    return [start + timedelta(days=i) for i in range(days)]
