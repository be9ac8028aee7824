"""PRL runtime values.  Counterpart of pine_tpu/prl/values.py.

The reference compiles PRL to native code with C++ value types (vec3,
mat4...).  Here a script evaluates eagerly over numpy: a vec is a length-n
array (``PrlVec``), a mat an (n, n) array (``PrlMat``).  A lambda handed to
a consumer that runs it over a batch of lanes (``draw`` fragments, ``SDF``
distances, ``Function`` nodes, ``heightmap(size, fn)``, loop_jit's batched
tier) sees *traced* values: ``torch.Tensor``s whose leading axis is the
lanes (a vec's data (N, n), a scalar (N,)), on the device of the lanes it
was given.  The same interpreter code serves both: every numeric op
dispatches on whether a tensor is among its operands (``is_traced``), and a
concrete operand that meets a tensor becomes a tensor on that tensor's
device (``as_tensor``), never the other way round.
"""
from __future__ import annotations

import numpy as np
import torch


def data_of(x):
    return x.data if isinstance(x, (PrlVec, PrlMat)) else x


def is_traced(x):
    return isinstance(data_of(x), torch.Tensor)


def lanes_of(*vals):
    """The first tensor among ``vals`` (their data), or None."""
    for v in vals:
        d = data_of(v)
        if isinstance(d, torch.Tensor):
            return d
    return None


def is_int_value(x):
    if isinstance(x, bool):
        return False
    if isinstance(x, (int, np.integer)):
        return True
    d = getattr(x, "dtype", None)
    if isinstance(d, torch.dtype):
        return not d.is_floating_point and d != torch.bool
    return d is not None and np.issubdtype(d, np.integer)


def as_tensor(x, like, dtype=None):
    """``x`` (a Python or numpy value, or a tensor) as a tensor on ``like``'s
    device: an integer value int32, a bool bool, anything else float32,
    unless ``dtype`` says."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    if dtype is None:
        if isinstance(x, (bool, np.bool_)) or getattr(x, "dtype", None) == np.bool_:
            dtype = torch.bool
        else:
            dtype = torch.int32 if is_int_value(x) else torch.float32
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=like.device)


def scalar_of(x):
    """A numpy scalar as the Python scalar torch treats as weakly typed, as
    jnp does; anything else unchanged."""
    if isinstance(x, np.ndarray) and x.ndim == 0:
        x = x[()]
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def operands(a, b):
    """``a``, ``b`` ready for a torch op when either is a tensor: numpy
    arrays become tensors on that tensor's device, numpy scalars Python
    scalars; with no tensor among them, unchanged."""
    like = lanes_of(a, b)
    if like is None:
        return a, b

    def conv(x):
        return as_tensor(x, like) if isinstance(x, np.ndarray) and x.ndim else scalar_of(x)

    return conv(a), conv(b)


class PrlVec:
    """vec2/3/4 (+ integer variants). data is a length-n array, or a
    tensor (..., n) over lanes."""

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
        self.set_subscript({"x": 0, "y": 1, "z": 2, "w": 3}[name], value)

    def subscript(self, i):
        return _unwrap_scalar(self.data[..., int(i)], self.is_int)

    def set_subscript(self, i, value):
        self.data = _set_last(self.data, int(i), value)

    def copy(self):
        d = self.data
        return PrlVec(np.array(d, copy=True) if isinstance(d, np.ndarray) else d, self.is_int)

    def __repr__(self):
        return f"PrlVec({self.data}, int={self.is_int})"


def _set_last(data, i, value):
    """``data`` with component ``i`` of its last axis set to ``value``, out
    of place (a tensor on the lanes' device when either is traced)."""
    like = lanes_of(data, value)
    if like is None:
        data = np.array(data, copy=True)
        data[..., i] = value
        return data
    d = as_tensor(data, like)
    v = as_tensor(scalar_of(value), like, d.dtype)
    lanes = torch.broadcast_shapes(d.shape[:-1], v.shape)
    out = d.expand(lanes + d.shape[-1:]).clone()
    out[..., i] = v
    return out


def _set_column(data, i, col):
    """``data`` (..., n, n) with column ``i`` set to ``col`` (..., n), out of
    place (a tensor when either is traced)."""
    like = lanes_of(data, col)
    if like is None:
        data = np.array(data, copy=True)
        data[..., :, i] = col
        return data
    d = as_tensor(data, like)
    c = as_tensor(col, like, d.dtype)
    lanes = torch.broadcast_shapes(d.shape[:-2], c.shape[:-1])
    out = d.expand(lanes + d.shape[-2:]).clone()
    out[..., :, i] = c
    return out


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
        self.data = _set_column(self.data, idx, data_of(value))

    def subscript(self, i):
        return PrlVec(self.data[..., :, int(i)])

    def copy(self):
        d = self.data
        return PrlMat(np.array(d, copy=True) if isinstance(d, np.ndarray) else d)

    def __repr__(self):
        return f"PrlMat({self.data})"


def _unwrap_scalar(x, is_int):
    """numpy 0-d -> python scalar; tensors stay as they are."""
    if isinstance(x, np.ndarray) and x.ndim == 0:
        return int(x) if is_int else float(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def make_vec(components):
    """[a,b,c] literal -> vec (int variant iff all components are ints;
    jit.cpp Vector::emit).  Traced components broadcast the others to their
    lanes."""
    allint = all(is_int_value(c) for c in components)
    comps = [data_of(c) for c in components]
    like = lanes_of(*comps)
    if like is None:
        arr = np.asarray(comps, np.int32 if allint else np.float32)
        if any(np.ndim(c) for c in comps):
            arr = arr.T
        return PrlVec(arr, allint)
    dt = torch.int32 if allint else torch.float32
    comps = [as_tensor(scalar_of(c), like, dt) for c in comps]
    return PrlVec(torch.stack(torch.broadcast_tensors(*comps), -1), allint)


def to_float_vec(v):
    if isinstance(v, PrlVec) and v.is_int:
        d = v.data
        return PrlVec(d.to(torch.float32) if isinstance(d, torch.Tensor) else d.astype(np.float32),
                      False)
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
