"""Wall-clock ``Timer`` (parity: src/pine/core/log.h:97-107, as in
pine_tpu/core/log.py).  The CLI is its one caller; the severity streams and
``CHECK*`` helpers of log.h come over with the first ported module that
calls them.
"""
from __future__ import annotations

import time


class Timer:
    """Wall-clock timer (log.h:97-107)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed_ms(self):
        return (time.perf_counter() - self.t0) * 1000.0
