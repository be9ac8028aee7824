"""Hierarchical RAII profiler (parity: src/pine/core/profiler.h/.cpp).

Counterpart of pine_tpu/core/profiler.py.  Context-manager scopes build a
shared record tree; ``finalize()`` prints the sorted tree with
percent-of-parent, like the reference's Profiler::Finalize.  Scopes time the
host's wall clock; CUDA work is asynchronous, so a scope that needs the
device's time must synchronize before it closes (a film read or save does).
"""
from __future__ import annotations

import time


class _Record:
    __slots__ = ("name", "time", "samples", "children")

    def __init__(self, name):
        self.name = name
        self.time = 0.0
        self.samples = 0
        self.children = {}


_root = _Record("root")
_stack = [_root]


class Profiler:
    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __enter__(self):
        parent = _stack[-1]
        rec = parent.children.get(self.name)
        if rec is None:
            rec = parent.children[self.name] = _Record(self.name)
        _stack.append(rec)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = _stack.pop()
        rec.time += time.perf_counter() - self._t0
        rec.samples += 1
        return False

    @staticmethod
    def finalize(out=print):
        def emit(rec, parent_time, depth):
            pct = 100.0 * rec.time / parent_time if parent_time > 0 else 100.0
            out(
                f"{'  ' * depth}{rec.name:<24} {rec.time * 1e3:10.1f} ms "
                f"{pct:6.1f}%  x{rec.samples}"
            )
            for child in sorted(rec.children.values(), key=lambda r: -r.time):
                emit(child, rec.time, depth + 1)

        total = sum(c.time for c in _root.children.values())
        for child in sorted(_root.children.values(), key=lambda r: -r.time):
            emit(child, total, 0)

    @staticmethod
    def reset():
        global _root, _stack
        _root = _Record("root")
        _stack = [_root]
