"""SparseArray3d.  Counterpart of pine_tpu/core/sparse_array.py (parity:
src/pine/core/sparse_array.h:11-59).

A hash map over integer 3-D cells with a default value: a host-side
container only, which no render path reads (the grid media keep dense
grids, scene/media.py).
"""
from __future__ import annotations


class SparseArray3d:
    def __init__(self, default=0.0):
        self._d = {}
        self.default = default

    @staticmethod
    def _key(p):
        return (int(p[0]), int(p[1]), int(p[2]))

    def __getitem__(self, p):
        return self._d.get(self._key(p), self.default)

    def __setitem__(self, p, v):
        self._d[self._key(p)] = v

    def __contains__(self, p):
        return self._key(p) in self._d

    def __len__(self):
        return len(self._d)

    def items(self):
        return self._d.items()

    def clear(self):
        self._d.clear()
