"""Master-only structured logging (loguru-equivalent, reference train.py:38-48).

Sinks are stdout plus ``logs.txt`` in the run dir, with the reference's
``[MM-DD HH:mm:ss] - message`` format.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOGGER_NAME = "sota_imagenet_tpu_torch"


class _Fmt(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.message = record.getMessage()
        ts = self.formatTime(record, "[%m-%d %H:%M:%S]")
        return f"{ts} - {record.message}"


def setup_logger(log_file: Optional[str] = None, is_master: bool = True) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    if not is_master:
        logger.addHandler(logging.NullHandler())
        return logger
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(_Fmt())
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_Fmt())
        logger.addHandler(fh)
    return logger


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        setup_logger()
    return logger
