"""Logging setup (reference uses tf_logging throughout)."""

import logging
import os

_LOGGER = None


def get_logger() -> logging.Logger:
  global _LOGGER
  if _LOGGER is None:
    logger = logging.getLogger("epl_tpu")
    if not logger.handlers:
      handler = logging.StreamHandler()
      handler.setFormatter(logging.Formatter(
          "[epl-tpu %(levelname)s %(asctime)s] %(message)s", "%H:%M:%S"))
      logger.addHandler(handler)
    logger.setLevel(os.environ.get("EPL_LOG_LEVEL", "INFO"))
    logger.propagate = False
    _LOGGER = logger
  return _LOGGER
