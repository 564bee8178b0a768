"""Logging + progress reporting.

Parity: include/mitsuba/core/logger.h:11-28 (LogLevel Trace..Error), on
the stdlib logging module.
"""

from __future__ import annotations

import logging
import sys

Trace = 5
Debug = logging.DEBUG
Info = logging.INFO
Warn = logging.WARNING
Error = logging.ERROR

logging.addLevelName(Trace, "TRACE")

logger = logging.getLogger("mitsuba2_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def set_log_level(level):
    logger.setLevel(level)


def Log(level, msg, *args):
    logger.log(level, msg, *args)

