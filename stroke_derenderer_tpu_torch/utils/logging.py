"""The package's stderr logger, the counterpart of the JAX
``utils/logging.py`` (the CLI keeps its own prints)."""

from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "sdtpu",
               level: int = logging.INFO) -> logging.Logger:
    """A logger writing to stderr; its handler is added once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
