"""PRL arithmetic/comparison semantics over Python + PrlVec/PrlMat values.
Counterpart of pine_tpu/prl/ops.py.

Replicates the reference's operator registrations (vecmath.cpp:133-309,
jit.cpp i32/f32 fast paths): C-style integer division/modulo, elementwise
vector ops, matrix*vector / matrix*matrix, string concatenation with
to_string of any operand.  Arithmetic on texture nodes builds node trees
(node.cpp operator registrations).  Works alike for eager numpy values and
traced tensors (values.py): integer tensors stay int32 and wrap as i32
does, ``/`` of two integers truncates as C's, ``%`` of two scalars keeps the
dividend's sign (C's fmod, for integers and floats alike, eager or traced),
``%`` of vectors is the floor modulo (numpy's and pine_tpu's), comparisons
of tensors are bool masks, and a scalar broadcasts over a vector's
components and over the lanes.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.prl.values import (
    PrlMat,
    PrlVec,
    as_tensor,
    is_int_value,
    is_traced,
    lanes_of,
    operands,
    prl_to_string,
)


def _c_div(a, b):
    if is_int_value(a) and is_int_value(b):
        if is_traced(a) or is_traced(b):  # i32 lanes: C truncation
            return _trunc_div(*operands(a, b))
        q = abs(a) // abs(b)
        return int(q if (a >= 0) == (b >= 0) else -q)
    if is_traced(a) or is_traced(b):
        return _fdiv(*operands(a, b))
    return a / b


def _fdiv(a, b):
    """a / b with a tensor among them, correctly rounded on every device:
    a Python scalar operand becomes a 0-d tensor on the lanes' device first
    (torch's CUDA division by a host scalar multiplies by its reciprocal,
    and its scalar / tensor takes the reciprocal of the tensor, where the
    CPU divides: the card and the CPU would round differently)."""
    like = a if isinstance(a, torch.Tensor) else b
    dt = like.dtype if like.dtype.is_floating_point else torch.float32
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=dt, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=dt, device=like.device)
    return torch.div(a, b)


def _trunc_div(a, b):
    """C's integer division of int32 tensors (or a tensor and a Python int):
    |a| // max(|b|, 1) with the sign of a*b, as pine_tpu's traced form (a
    zero divisor gives |a| with that sign instead of a fault)."""
    if isinstance(b, int) and b != 0:
        return torch.div(a, b, rounding_mode="trunc")
    ab = abs(b) if isinstance(b, int) else torch.abs(b)
    q = torch.abs(a) // (max(ab, 1) if isinstance(ab, int) else torch.clamp_min(ab, 1))
    return torch.where((a >= 0) == (b >= 0), q, -q)


def _c_mod(a, b):
    if is_int_value(a) and is_int_value(b):
        if is_traced(a) or is_traced(b):
            a, b = operands(a, b)
            if isinstance(b, int) and b != 0:
                return torch.fmod(a, b)
            return a - _trunc_div(a, b) * b
        return int(a - _c_div(a, b) * b)
    if is_traced(a) or is_traced(b):
        a, b = operands(a, b)
        if not isinstance(a, torch.Tensor):
            a = torch.full_like(b, a, dtype=torch.float32)
        return torch.fmod(a, b)
    return np.fmod(a, b)


def _mask(x):
    x = x.data if isinstance(x, (PrlVec, PrlMat)) else x
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.bool else x != 0
    return bool(x)


def binary(op, a, b):
    from pine_tpu_torch.scene import nodes as N

    if isinstance(a, N.Node) or isinstance(b, N.Node):
        if op not in N.Binary.OPS:
            raise TypeError(f"op {op} is not defined for texture nodes")
        conv = lambda x: x if isinstance(x, N.Node) else N.Constant(  # noqa: E731
            np.asarray(x.data, np.float32) if isinstance(x, PrlVec) else float(x))
        return N.Binary(op, conv(a), conv(b))
    # string concatenation
    if op == "+" and (isinstance(a, str) or isinstance(b, str)):
        return prl_to_string(a) + prl_to_string(b)
    if op in ("==", "!=") and isinstance(a, str) and isinstance(b, str):
        return (a == b) if op == "==" else (a != b)
    if op in ("&&", "||"):
        if not (is_traced(a) or is_traced(b)):
            return (bool(a) and bool(b)) if op == "&&" else (bool(a) or bool(b))
        ma, mb = _mask(a), _mask(b)
        return (ma & mb) if op == "&&" else (ma | mb)
    if isinstance(a, PrlMat) or isinstance(b, PrlMat):
        return _mat_op(op, a, b)
    if isinstance(a, PrlVec) or isinstance(b, PrlVec):
        return _vec_op(op, a, b)
    return _scalar_op(op, a, b)


def _scalar_op(op, a, b):
    if op == "/":
        return _c_div(a, b)
    if op == "%":
        return _c_mod(a, b)
    traced = is_traced(a) or is_traced(b)
    if traced:
        a, b = operands(a, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "^":
        if traced:
            return fm.pow(a, b)
        return float(np.power(np.float64(a), b))
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    raise TypeError(f"unsupported scalar op {op}")


def _vec_op(op, a, b):
    av = a.data if isinstance(a, PrlVec) else a
    bv = b.data if isinstance(b, PrlVec) else b
    a_int = a.is_int if isinstance(a, PrlVec) else is_int_value(a)
    b_int = b.is_int if isinstance(b, PrlVec) else is_int_value(b)
    out_int = a_int and b_int
    like = lanes_of(av, bv)
    if like is not None:
        av, bv = operands(av, bv)
        # a non-vec operand is a scalar; over lanes it takes a trailing
        # component axis to broadcast against the vector's components
        if not isinstance(a, PrlVec) and isinstance(av, torch.Tensor) and av.ndim >= 1:
            av = av[..., None]
        if not isinstance(b, PrlVec) and isinstance(bv, torch.Tensor) and bv.ndim >= 1:
            bv = bv[..., None]
        return _vec_op_t(op, av, bv, out_int)
    if op == "+":
        r = av + bv
    elif op == "-":
        r = av - bv
    elif op == "*":
        r = av * bv
    elif op == "/":
        if out_int:
            q = np.abs(av) // np.maximum(np.abs(bv), 1)
            r = np.where((av >= 0) == (bv >= 0), q, -q)
        else:
            r = av / bv
    elif op == "%":
        r = av % bv
    elif op == "^":
        r = np.power(av, bv)
        out_int = False
    elif op in ("==", "!="):
        eq = bool(np.all(av == bv))
        return eq if op == "==" else not eq
    else:
        raise TypeError(f"unsupported vector op {op}")
    if not out_int and hasattr(r, "dtype") and np.issubdtype(r.dtype, np.integer):
        r = r.astype(np.float32)
    return PrlVec(r, out_int)


def _vec_op_t(op, av, bv, out_int):
    """A vector op with a tensor among the operands; lanes broadcast."""
    if op == "+":
        r = av + bv
    elif op == "-":
        r = av - bv
    elif op == "*":
        r = av * bv
    elif op == "/":
        r = _trunc_div(*_tensor_pair(av, bv)) if out_int else _fdiv(av, bv)
    elif op == "%":
        r = torch.remainder(*_tensor_pair(av, bv))
    elif op == "^":
        r = fm.pow(*_float_pair(av, bv))
        out_int = False
    elif op in ("==", "!="):
        eq = torch.eq(*_tensor_pair(av, bv)).all(-1)  # per lane
        return eq if op == "==" else ~eq
    else:
        raise TypeError(f"unsupported vector op {op}")
    if not out_int and not r.dtype.is_floating_point:
        r = r.to(torch.float32)
    return PrlVec(r, out_int)


def _tensor_pair(a, b):
    like = a if isinstance(a, torch.Tensor) else b
    return as_tensor(a, like), as_tensor(b, like)


def _float_pair(a, b):
    a, b = _tensor_pair(a, b)
    return a.to(torch.float32), b


def _mat_op(op, a, b):
    if op == "*":
        if isinstance(a, PrlMat) and isinstance(b, PrlMat):
            ad, bd = a.data, b.data
            if lanes_of(ad, bd) is not None:
                return PrlMat(torch.matmul(*_tensor_pair(ad, bd)))
            return PrlMat(np.matmul(ad, bd))
        if isinstance(a, PrlMat) and isinstance(b, PrlVec):
            an = a.data.shape[-1]
            if lanes_of(a, b) is not None:
                md, bd = _tensor_pair(a.data, b.data)
                bd = bd.to(torch.float32)
                if b.n == an:
                    return PrlVec(_matvec(md, bd))
                if an == 4 and b.n == 3:
                    return PrlVec(_matvec(md[..., :3, :3], bd) + md[..., :3, 3])
                raise TypeError("mat*vec dimension mismatch")
            bd = b.data.astype(np.float32) if b.is_int else b.data
            if b.n == an:
                return PrlVec(np.einsum("...ij,...j->...i", a.data, bd))
            if an == 4 and b.n == 3:
                # mat4 * vec3: affine point transform (vecmath mat4*(vec3,1))
                r = np.einsum("...ij,...j->...i", a.data[..., :3, :3], bd) + a.data[..., :3, 3]
                return PrlVec(r)
            raise TypeError("mat*vec dimension mismatch")
        if isinstance(a, PrlVec) and isinstance(b, PrlMat):
            raise TypeError("vec*mat is not defined in PRL")
        raise TypeError("mat * scalar is not defined in PRL")
    if op == "+":
        if lanes_of(a, b) is not None:
            return PrlMat(torch.add(*_tensor_pair(a.data, b.data)))
        return PrlMat(a.data + b.data)
    raise TypeError(f"unsupported matrix op {op}")


def _matvec(m, v):
    """m (..., n, n) times v (..., n), the sum written out term by term in
    column order: the same bits on the card and the CPU."""
    r = m[..., :, 0] * v[..., 0, None]
    for j in range(1, m.shape[-1]):
        r = r + m[..., :, j] * v[..., j, None]
    return r


def unary(op, x):
    if op == "neg":
        if isinstance(x, PrlVec):
            return PrlVec(-x.data, x.is_int)
        if isinstance(x, PrlMat):
            return PrlMat(-x.data)
        return -x
    if op == "pos":
        return x
    if op == "not":
        return ~_mask(x) if is_traced(x) else not x
    raise TypeError(f"unsupported unary op {op}")
