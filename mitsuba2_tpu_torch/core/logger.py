"""Logging + progress reporting.

Parity: include/mitsuba/core/logger.h:11-28 (LogLevel Trace..Error), on
the stdlib logging module, and progress.h:15 (ProgressReporter).
"""

from __future__ import annotations

import logging
import sys
import time

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



class ProgressReporter:
    """(progress.h:15) a text progress bar with an estimate of the time
    left, rewritten in place on ``stream``."""

    def __init__(self, label: str, total: int = 1, stream=sys.stderr):
        self.label = label
        self.total = max(int(total), 1)
        self.stream = stream
        self.start = time.time()

    def update(self, value):
        frac = min(max(value / self.total, 0.0), 1.0)
        elapsed = time.time() - self.start
        eta = elapsed * (1 - frac) / max(frac, 1e-9)
        bar_w = 30
        filled = int(bar_w * frac)
        self.stream.write(
            f"\r{self.label} [{'=' * filled}{' ' * (bar_w - filled)}] "
            f"{100 * frac:5.1f}% (ETA {eta:5.1f}s)")
        if frac >= 1.0:
            self.stream.write(f"  done in {elapsed:.1f}s\n")
        self.stream.flush()
