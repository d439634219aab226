"""Logging to stderr in the JAX package's format, with its host-0 filter
(``utils/logging.py`` there): under a process group, records below ERROR are
dropped on every rank but 0."""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist


class _Host0Filter(logging.Filter):
    """Decides at emit time, from ``dist.get_rank()`` where a group exists,
    so that a module may make its logger at import, before ``main`` joins
    the group (JAX's :11-32)."""

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.ERROR or not dist.is_initialized():
            return True
        return dist.get_rank() == 0


def get_logger(name: str = "eeg2video_tpu_torch", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s - %(levelname)s - %(name)s - %(message)s",
            datefmt="%m/%d/%Y %H:%M:%S",
        ))
        h.addFilter(_Host0Filter())
        logger.addHandler(h)
        logger.setLevel(level)
    return logger
