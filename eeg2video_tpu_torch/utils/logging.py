"""Logging to stderr in the JAX package's format (``utils/logging.py``
there), without its host-0 filter: the port runs in one process."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "eeg2video_tpu_torch", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(name)s - %(message)s",
            datefmt="%m/%d/%Y %H:%M:%S",
        ))
        logger.addHandler(h)
        logger.setLevel(level)
    return logger
