"""Global render-progress reporting.

Counterpart of pine_tpu/core/progress.py.  The reference keeps an
``Atomic<float> g_progress`` updated by worker threads (integrator.cpp:11-19)
and polled at 10 Hz by the CLI which reprints a ``\r``-line
(pine.cpp:36-40).  Here the wavefront renderer calls
``set_progress`` after each lane chunk; the CLI polls from a watcher thread.
"""
from __future__ import annotations

import threading

_lock = threading.Lock()
_progress = 0.0


def set_progress(x: float) -> None:
    global _progress
    with _lock:
        _progress = float(x)


def get_progress() -> float:
    with _lock:
        return _progress


def reset_progress() -> None:
    set_progress(0.0)


class ProgressReporter:
    """CLI-side 10 Hz poller printing a carriage-return progress line
    (pine.cpp:36-40)."""

    def __init__(self, stream=None, interval=0.1):
        import sys

        self.stream = stream or sys.stderr
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        reset_progress()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        import time

        last = -1.0
        changed_at = time.time()
        beat = 0.0
        while not self._stop.wait(self.interval):
            p = get_progress()
            if p != last:
                self.stream.write(f"\r{100.0 * p:6.1f}%" + " " * 40 + "\b" * 40)
                self.stream.flush()
                last = p
                changed_at = time.time()
            else:
                # heartbeat: a first call builds the CUDA kernels (nvcc), which
                # can be a minute of silence: show that we are alive, not hung
                stall = time.time() - changed_at
                if stall > 3.0 and time.time() - beat > 1.0:
                    self.stream.write(
                        f"\r{100.0 * p:6.1f}%  (compiling/working {stall:.0f}s)"
                    )
                    self.stream.flush()
                    beat = time.time()

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self.stream.write("\r" + " " * 48 + "\r")
        self.stream.flush()
        return False
