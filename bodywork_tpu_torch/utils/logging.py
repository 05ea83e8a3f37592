"""Shared logging (a copy of ``bodywork_tpu.utils.logging``).

The log format is the reference's, so operators see the same lines from
either package: ``asctime - levelname - module.funcName - message`` to
stdout. The port logs under its own root logger, so a process that
imports both packages (the parity tests) never stacks two handlers on
one logger.
"""
from __future__ import annotations

import logging
import sys

LOG_FORMAT = (
    "%(asctime)s - "
    "%(levelname)s - "
    "%(module)s.%(funcName)s - "
    "%(message)s"
)

_ROOT_NAME = "bodywork_tpu_torch"


def configure_logger(
    level: str | int = logging.INFO, stream=None
) -> logging.Logger:
    """Configure the port's root logger (stdout by default; pass
    ``stream=sys.stderr`` when stdout must stay machine-readable).

    Idempotent: repeated calls do not stack handlers; passing a different
    ``stream`` re-points the existing handler.
    """
    logger = logging.getLogger(_ROOT_NAME)
    # exact type check: FileHandler etc. subclass StreamHandler and must not
    # have their streams hijacked
    handlers = [h for h in logger.handlers if type(h) is logging.StreamHandler]
    if handlers:
        if stream is not None:  # only an explicit stream re-points
            for h in handlers:
                try:
                    h.setStream(stream)
                except ValueError:
                    # setStream flushes the OLD stream first; a dead one
                    # must not block re-pointing to a live one
                    h.acquire()
                    try:
                        h.stream = stream
                    finally:
                        h.release()
    else:
        handler = logging.StreamHandler(stream if stream is not None else sys.stdout)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        logger.addHandler(handler)
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)
    return logger


def get_logger(name: str) -> logging.Logger:
    """Return a child logger under the port's root (e.g. ``store``)."""
    configure_logger()
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
