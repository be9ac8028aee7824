"""PRL runtime values.  Counterpart of pine_tpu/prl/values.py.

The reference compiles PRL to native code with C++ value types (vec3,
mat4...).  Here a script evaluates eagerly over numpy: a vec is a length-n
array (``PrlVec``), a mat an (n, n) array (``PrlMat``).  pine_tpu's branches
for jax tracers (lambdas re-entered under a trace) are not ported: the port
has no traced values yet (ROADMAP.md, modules item 15).
"""
from __future__ import annotations

import numpy as np


def is_int_value(x):
    if isinstance(x, bool):
        return False
    if isinstance(x, (int, np.integer)):
        return True
    d = getattr(x, "dtype", None)
    return d is not None and np.issubdtype(d, np.integer)


class PrlVec:
    """vec2/3/4 (+ integer variants). data is a length-n array."""

    __slots__ = ("data", "is_int")

    def __init__(self, data, is_int=False):
        if isinstance(data, (list, tuple)):
            data = np.asarray(data, np.int32 if is_int else np.float32)
        self.data = data
        self.is_int = bool(is_int)

    @property
    def n(self):
        return int(self.data.shape[-1])

    def member(self, name):
        idx = {"x": 0, "y": 1, "z": 2, "w": 3}[name]
        return _unwrap_scalar(self.data[..., idx], self.is_int)

    def set_member(self, name, value):
        idx = {"x": 0, "y": 1, "z": 2, "w": 3}[name]
        self.data = np.array(self.data, copy=True)
        self.data[..., idx] = value

    def subscript(self, i):
        return _unwrap_scalar(self.data[..., int(i)], self.is_int)

    def set_subscript(self, i, value):
        self.data = np.array(self.data, copy=True)
        self.data[..., int(i)] = value

    def copy(self):
        return PrlVec(np.array(self.data, copy=True), self.is_int)

    def __repr__(self):
        return f"PrlVec({self.data}, int={self.is_int})"


class PrlMat:
    """mat2/3/4 stored as (n,n) with math convention m[row, col]; the PRL
    members .x/.y/.z/.w are COLUMNS (vecmath.h mat = column vectors)."""

    __slots__ = ("data",)

    def __init__(self, data):
        if isinstance(data, (list, tuple)):
            data = np.asarray(data, np.float32)
        self.data = data

    @property
    def n(self):
        return int(self.data.shape[-1])

    def member(self, name):
        idx = {"x": 0, "y": 1, "z": 2, "w": 3}[name]
        return PrlVec(self.data[..., :, idx])

    def set_member(self, name, value):
        idx = {"x": 0, "y": 1, "z": 2, "w": 3}[name]
        self.data = np.array(self.data, copy=True)
        self.data[..., :, idx] = value.data if isinstance(value, PrlVec) else value

    def subscript(self, i):
        return PrlVec(self.data[..., :, int(i)])

    def copy(self):
        return PrlMat(np.array(self.data, copy=True))

    def __repr__(self):
        return f"PrlMat({self.data})"


def _unwrap_scalar(x, is_int):
    """numpy 0-d -> python scalar."""
    if isinstance(x, np.ndarray) and x.ndim == 0:
        return int(x) if is_int else float(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def make_vec(components):
    """[a,b,c] literal -> vec (int variant iff all components are ints;
    jit.cpp Vector::emit)."""
    allint = all(is_int_value(c) for c in components)
    comps = [c.data if isinstance(c, PrlVec) else c for c in components]
    arr = np.asarray(comps, np.int32 if allint else np.float32)
    if any(np.ndim(c) for c in comps):
        arr = arr.T
    return PrlVec(arr, allint)


def to_float_vec(v):
    if isinstance(v, PrlVec) and v.is_int:
        return PrlVec(v.data.astype(np.float32), False)
    return v


def prl_to_string(x):
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, float):
        return f"{x:g}"
    if isinstance(x, PrlVec):
        return "[" + ", ".join(prl_to_string(_unwrap_scalar(x.data[..., i], x.is_int))
                               for i in range(x.n)) + "]"
    if isinstance(x, PrlMat):
        return "[" + "; ".join(prl_to_string(x.subscript(i)) for i in range(x.n)) + "]"
    if isinstance(x, np.floating):
        return f"{float(x):g}"
    return str(x)
