"""Wall-clock ``Timer`` and the warning stream (parity: src/pine/core/log.h,
as in pine_tpu/core/log.py).  The CLI times with ``Timer``; ReSTIR warns
through ``WARNING``.  The other severity streams and the ``CHECK*`` helpers
of log.h come over with the first ported module that calls them.
"""
from __future__ import annotations

import sys
import time


def _default_stream(msg):
    print(msg, file=sys.stderr)


# swappable stream function pointers (log.h:11-14); tests may override
streams = {"warning": _default_stream}


def WARNING(*args):
    streams["warning"]("[warning] " + " ".join(str(a) for a in args))


class Timer:
    """Wall-clock timer (log.h:97-107)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed_ms(self):
        return (time.perf_counter() - self.t0) * 1000.0
