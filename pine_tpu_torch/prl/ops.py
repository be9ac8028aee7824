"""PRL arithmetic/comparison semantics over Python + PrlVec/PrlMat values.
Counterpart of pine_tpu/prl/ops.py, for eager numpy values only.

Replicates the reference's operator registrations (vecmath.cpp:133-309,
jit.cpp i32/f32 fast paths): C-style integer division/modulo, elementwise
vector ops, matrix*vector / matrix*matrix, string concatenation with
to_string of any operand.  Arithmetic on texture nodes builds node trees
(node.cpp operator registrations).
"""
from __future__ import annotations

import numpy as np

from pine_tpu_torch.prl.values import PrlMat, PrlVec, is_int_value, prl_to_string


def _c_div(a, b):
    if is_int_value(a) and is_int_value(b):
        q = abs(a) // abs(b)
        return int(q if (a >= 0) == (b >= 0) else -q)
    return a / b


def _c_mod(a, b):
    if is_int_value(a) and is_int_value(b):
        return int(a - _c_div(a, b) * b)
    return np.fmod(a, b)


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
    if op == "&&":
        return bool(a) and bool(b)
    if op == "||":
        return bool(a) or bool(b)
    if isinstance(a, PrlMat) or isinstance(b, PrlMat):
        return _mat_op(op, a, b)
    if isinstance(a, PrlVec) or isinstance(b, PrlVec):
        return _vec_op(op, a, b)
    return _scalar_op(op, a, b)


def _scalar_op(op, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return _c_div(a, b)
    if op == "%":
        return _c_mod(a, b)
    if op == "^":
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


def _mat_op(op, a, b):
    if op == "*":
        if isinstance(a, PrlMat) and isinstance(b, PrlMat):
            return PrlMat(np.matmul(a.data, b.data))
        if isinstance(a, PrlMat) and isinstance(b, PrlVec):
            an = a.data.shape[-1]
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
        return PrlMat(a.data + b.data)
    raise TypeError(f"unsupported matrix op {op}")


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
        return not x
    raise TypeError(f"unsupported unary op {op}")
