"""Logging: one stdlib logger per component with one consistent format
(own copy of the reference's ``utils/logging.py``)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[dftpu][%(asctime)s][%(name)s][%(levelname)s] %(message)s"


def get_logger(name: str = "dftpu", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
