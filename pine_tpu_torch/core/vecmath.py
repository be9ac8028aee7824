"""Vector math on batched tensors (vectors live in the trailing axis).

Counterpart of pine_tpu/core/vecmath.py.  Device-side functions take
``(..., 3)`` tensors; the 4x4 transform builders are host-side numpy, used
while a scene is built.  Dot products and cross products of 3-vectors are
written out term by term, each product and sum its own operation: a
reduction over the trailing axis sums in another order on the card than on
the CPU, and a fused kernel (``torch.linalg.cross``) may contract a
multiply-add there, so the card and the CPU would differ in the last ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import profiler

Pi = float(np.pi)
FLOAT_MAX = float(np.finfo(np.float32).max)


def dot(a, b):
    p = a * b
    if p.shape[-1] == 3:
        return p[..., 0] + p[..., 1] + p[..., 2]
    return p.sum(-1)


def dotk(a, b):
    return dot(a, b)[..., None]


def length_squared(v):
    return dot(v, v)


def length(v):
    return fm.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    n = fm.sqrt(dotk(v, v))
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def safe_normalize(v):
    return normalize(v, eps=1e-20)


_NEXT, _PREV = (1, 2, 0), (2, 0, 1)  # the cyclic shifts of (x, y, z)


def cross(a, b):
    dev, to = a.device, profiler.to_device  # each index copied to the card, as a tuple index is
    return (a[..., to(_NEXT, dev, "cross")] * b[..., to(_PREV, dev, "cross")]
            - a[..., to(_PREV, dev, "cross")] * b[..., to(_NEXT, dev, "cross")])


def face_forward(v, n):
    """Flip v to lie in the hemisphere of n."""
    return torch.where(dotk(v, n) < 0.0, -v, v)


def _axis(n, i):
    e = torch.zeros(3, dtype=n.dtype, device=n.device)
    with profiler.sync("axis"):  # the scalar write copies it to the card
        e[i] = 1.0
    return e.expand(n.shape)


def coordinate_system(n):
    """Tangent/bitangent for normals n -> (t, b), branching on |n.x| > |n.y|."""
    pick = (n[..., 0].abs() > n[..., 1].abs())[..., None]
    t = torch.where(pick, cross(n, _axis(n, 1)), cross(n, _axis(n, 0)))
    t = safe_normalize(t)
    return t, cross(n, t)


def to_local(n, w):
    """World -> local frame where local z == n."""
    t, b = coordinate_system(n)
    return torch.stack([dot(w, t), dot(w, b), dot(w, n)], -1)


def to_world(n, w):
    t, b = coordinate_system(n)
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def phi2pi(x, y):
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, 2 * Pi + phi, phi)


def cartesian_to_spherical(d):
    return torch.stack(
        [phi2pi(d[..., 0], d[..., 1]), torch.acos(d[..., 2].clamp(-1.0, 1.0))], -1
    )


# ---- host-side 4x4 transform builders (numpy, scene construction) ----------

def look_at(from_p, at, up=(0.0, 1.0, 0.0)):
    """Camera-to-world 4x4 with columns right, up, forward, position."""
    from_p = np.asarray(from_p, np.float32)
    at = np.asarray(at, np.float32)
    up = np.asarray(up, np.float32)
    z = at - from_p
    z = z / np.linalg.norm(z)
    if abs(float(np.dot(z, up))) > 0.999:
        z = z + np.array([0.0, 0.0, 1e-5], np.float32)
        z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = from_p
    return m


def translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def scale(v):
    m = np.eye(4, dtype=np.float32)
    v = np.asarray(v, np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v[0], v[1], v[2]
    return m


def rotate_x(rad):
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(rad):
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(rad):
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m
