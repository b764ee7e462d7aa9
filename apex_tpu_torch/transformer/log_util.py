"""Logging helper (``apex_tpu/transformer/log_util.py``; reference
``apex/transformer/log_util.py``)."""

from __future__ import annotations

import logging
import os

__all__ = ["get_transformer_logger", "set_logging_level"]

_PREFIX = "apex_tpu_torch.transformer"


def get_transformer_logger(name: str) -> logging.Logger:
    """Namespaced logger; level from ``APEX_TPU_LOG_LEVEL`` if set."""
    logger = logging.getLogger(f"{_PREFIX}.{name}")
    env = os.environ.get("APEX_TPU_LOG_LEVEL")
    if env and logger.level == logging.NOTSET:
        logger.setLevel(env.upper())
    return logger


def set_logging_level(verbosity) -> None:
    """Set the package-wide transformer log level."""
    logging.getLogger(_PREFIX).setLevel(verbosity)
