"""Error monitoring hook (the port of ``bodywork_tpu.utils.errors``;
reference C9).

The reference initialises Sentry in every stage entry point
(``sentry_sdk.init(dsn, traces_sample_rate=1.0)`` + ``set_tag('stage',
...)``, ``stage_1_train_model.py:171-172`` and clones). Here error
monitoring is an optional hook: with ``sentry_sdk`` importable and
``SENTRY_DSN`` set it is enabled, otherwise it is a no-op (the reference
hard-fails when ``SENTRY_DSN`` is unset, ``stage_1:161-167``, and its
stage 4 tags itself ``'stage-4-generate-next-dataset'``, ``stage_4:164``).
``sentry_sdk`` is imported only when a DSN is set. :class:`StageError` is
the failure type of a stage, as in the JAX package.
"""
from __future__ import annotations

import os

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("errors")


class StageError(RuntimeError):
    """A pipeline stage failed; carries the stage name for the orchestrator."""

    def __init__(self, stage: str, message: str):
        super().__init__(f"stage '{stage}' failed: {message}")
        self.stage = stage


def init_error_monitoring(stage: str, traces_sample_rate: float = 1.0) -> bool:
    """Initialise the optional Sentry integration for a stage. Returns
    True if monitoring was enabled, False if running without it."""
    dsn = os.environ.get("SENTRY_DSN")
    if not dsn:
        return False
    try:
        import sentry_sdk  # type: ignore
    except ImportError:
        log.warning("SENTRY_DSN set but sentry_sdk not installed; continuing")
        return False
    sentry_sdk.init(dsn, traces_sample_rate=traces_sample_rate)
    sentry_sdk.set_tag("stage", stage)
    return True


def tag_stage(stage: str) -> None:
    """Re-tag the active error-monitoring scope with the actual stage name:
    the CLI initialises monitoring before the stage is known (the pod
    entry point tags ``cli-run-stage``), and ``run-stage`` then tags the
    stage it runs, so every stage pod reports under its own name. No-op
    when monitoring is disabled."""
    if not os.environ.get("SENTRY_DSN"):
        return
    try:
        import sentry_sdk  # type: ignore
    except ImportError:
        return
    sentry_sdk.set_tag("stage", stage)
