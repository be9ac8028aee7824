"""CSG ray intersection by interval algebra.  Counterpart of
pine_tpu/scene/csg_intersect.py (parity: geometry.cpp:764-882).

Each convex child gives one analytic (t_enter, t_exit) interval per lane;
union, intersection and difference combine sorted lists of at most
MAX_IVALS intervals, branch-free over the whole wavefront.  Children:
Sphere, BoxAABB, BoxOBB, Cone, Cylinder and nested CSG shapes.  An empty
slot is (BIG, -BIG).

The 3-vector dot products and the 3x4 transforms are written out term by
term (core/vecmath.py), so that the card sums in the CPU's order; the slot
sort is stable, as ``jnp.argsort``, so ties in the starts keep their order
and ``_clip_slots`` drops the same slots as pine_tpu's.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core.vecmath import dot
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.csg import CSGDifference, CSGIntersection, CSGShape, CSGUnion

BIG = 1e30
MAX_IVALS = 8


def on_device(shape, attr, like):
    """``shape.<attr>`` (a host array) as a float32 tensor on ``like``'s
    device, uploaded once per shape and device."""
    cache = shape.__dict__.setdefault("_on_device", {})
    key = (attr, str(like.device))
    if key not in cache:
        cache[key] = torch.as_tensor(np.array(getattr(shape, attr), np.float32),
                                     device=like.device)
    return cache[key]


def affine(m, p, translate=True):
    """Rows of a 4x4 (or 3x4) matrix tensor ``m`` applied to points (or, with
    ``translate`` False, directions) ``p`` (N,3), each sum written out."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    out = x * m[:3, 0] + y * m[:3, 1] + z * m[:3, 2]
    return out + m[:3, 3] if translate else out


def norm3(v):
    return fm.sqrt(dot(v, v))


def _sphere_interval(shape, ro, rd):
    ro_p = ro - on_device(shape, "c", ro)
    r = shape.r
    b = dot(ro_p, rd)
    cc = dot(ro_p, ro_p) - r * r
    disc = b * b - cc
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    t0, t1 = -b - sq, -b + sq
    ok = disc > 0.0
    return torch.where(ok, t0, BIG), torch.where(ok, t1, -BIG)


def _aabb_interval_raw(lower, upper, ro, rd):
    inv = 1.0 / torch.where(rd.abs() < 1e-9, torch.where(rd < 0, -1e-9, 1e-9), rd)
    t0 = (lower - ro) * inv
    t1 = (upper - ro) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    ok = tn <= tf
    return torch.where(ok, tn, BIG), torch.where(ok, tf, -BIG)


def _aabb_interval(shape, ro, rd):
    return _aabb_interval_raw(on_device(shape, "lower", ro), on_device(shape, "upper", ro), ro, rd)


def _obb_interval(shape, ro, rd):
    mi = on_device(shape, "m_inv", ro)
    o_l = affine(mi, ro)
    d_l = affine(mi, rd, translate=False)
    scale = norm3(d_l)[:, None]
    d_ln = d_l / torch.clamp_min(scale, 1e-20)
    tn, tf = _aabb_interval_raw(on_device(shape.base, "lower", ro), on_device(shape.base, "upper", ro), o_l,
                                d_ln)
    # a local t maps back to the world by 1/scale (d_l carries the world scale)
    s = torch.clamp_min(scale[:, 0], 1e-20)
    return tn / s, tf / s


def _cone_interval(shape, ro, rd):
    nvec = on_device(shape, "n", ro)
    A2 = shape.A2
    o = ro - on_device(shape, "apex", ro)
    dn = dot(rd, nvec)
    on = dot(o, nvec)
    a = -A2 * dn * dn + dot(rd, rd)
    b = 2 * (-A2 * on * dn + dot(o, rd))
    c = -A2 * on * on + dot(o, o)
    disc = b * b - 4 * a * c
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    a_s = torch.where(a.abs() < 1e-12, 1e-12, a)
    t0 = (-b - sq) / (2 * a_s)
    t1 = (-b + sq) / (2 * a_s)
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    # clip to the real (below-apex) nappe and the base plane
    mid = (lo_t + hi_t) / 2
    ok = (disc > 0.0) & (dot(o + mid[:, None] * rd, nvec) <= 0.0)
    t_plane = dot(on_device(shape, "base_p", ro) - ro, nvec) / torch.where(dn == 0, 1e-12, dn)
    going_up = dn > 0
    lo2 = torch.where(going_up, torch.maximum(lo_t, t_plane), lo_t)
    hi2 = torch.where(going_up, hi_t, torch.minimum(hi_t, t_plane))
    ok = ok & (lo2 <= hi2)
    return torch.where(ok, lo2, BIG), torch.where(ok, hi2, -BIG)


def _cylinder_interval(shape, ro, rd):
    p0 = on_device(shape, "p0", ro)
    nvec = on_device(shape, "n", ro)
    r = shape.r
    m = ro - p0
    v = rd - dot(rd, nvec)[:, None] * nvec
    w = m - dot(m, nvec)[:, None] * nvec
    a = dot(v, v)
    b = 2 * dot(v, w)
    c = dot(w, w) - r * r
    disc = b * b - 4 * a * c
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    a_s = torch.where(a < 1e-12, 1e-12, a)
    lo_t = (-b - sq) / (2 * a_s)
    hi_t = (-b + sq) / (2 * a_s)
    # the axial clamp between the two caps
    ln = float(np.dot(shape.p1 - shape.p0, shape.n))
    dn = dot(rd, nvec)
    mn = dot(m, nvec)
    dn_s = torch.where(dn == 0, 1e-12, dn)
    t_cap0 = (0.0 - mn) / dn_s
    t_cap1 = (ln - mn) / dn_s
    lo2 = torch.maximum(lo_t, torch.minimum(t_cap0, t_cap1))
    hi2 = torch.minimum(hi_t, torch.maximum(t_cap0, t_cap1))
    ok = (disc > 0.0) & (lo2 <= hi2)
    return torch.where(ok, lo2, BIG), torch.where(ok, hi2, -BIG)


_INTERVAL_FNS = {
    S.Sphere: _sphere_interval,
    S.BoxAABB: _aabb_interval,
    S.BoxOBB: _obb_interval,
    S.Cone: _cone_interval,
    S.Cylinder: _cylinder_interval,
}


def check_csg(shape):
    """Refuse a CSG tree with a child that has no interval test (as pine_tpu's
    ``intervals_of`` does, here when the scene is flattened)."""
    if isinstance(shape, CSGShape):
        check_csg(shape.a)
        check_csg(shape.b)
    elif type(shape) not in _INTERVAL_FNS:
        raise TypeError(f"CSG child {type(shape).__name__} has no interval intersector")
    return shape


def intervals_of(shape, ro, rd):
    """-> (starts (N,K), ends (N,K)) sorted by start, empty slots (BIG, -BIG)."""
    if isinstance(shape, CSGShape):
        sa, ea = intervals_of(shape.a, ro, rd)
        sb, eb = intervals_of(shape.b, ro, rd)
        if isinstance(shape, CSGUnion):
            return _union(sa, ea, sb, eb)
        if isinstance(shape, CSGIntersection):
            return _intersection(sa, ea, sb, eb)
        return _difference(sa, ea, sb, eb)
    fn = _INTERVAL_FNS.get(type(shape))
    if fn is None:
        raise TypeError(f"CSG child {type(shape).__name__} has no interval intersector")
    s, e = fn(shape, ro, rd)
    return s[:, None], e[:, None]


def _merge_sorted(s, e):
    """Slots sorted by start, stably."""
    s, order = torch.sort(s, dim=1, stable=True)
    return s, torch.gather(e, 1, order)


def _clip_slots(s, e):
    return s[:, :MAX_IVALS], e[:, :MAX_IVALS]


def _union(sa, ea, sb, eb):
    return _clip_slots(*_merge_sorted(torch.cat([sa, sb], 1), torch.cat([ea, eb], 1)))


def _intersection(sa, ea, sb, eb):
    """The pairwise overlap of every slot of a with every slot of b."""
    n = sa.shape[0]
    s = torch.maximum(sa[:, :, None], sb[:, None, :]).reshape(n, -1)
    e = torch.minimum(ea[:, :, None], eb[:, None, :]).reshape(n, -1)
    empty = s > e
    s = torch.where(empty, BIG, s)
    e = torch.where(empty, -BIG, e)
    return _clip_slots(*_merge_sorted(s, e))


def _difference(sa, ea, sb, eb):
    """a \\ b: each interval of b taken out of a's set in turn."""
    s, e = sa, ea
    for j in range(sb.shape[1]):
        bs, be = sb[:, j:j + 1], eb[:, j:j + 1]
        # each slot splits into (s, min(e, bs)) and (max(s, be), e)
        s = torch.cat([s, torch.maximum(s, be)], 1)
        e = torch.cat([torch.minimum(e, bs), e], 1)
        empty = s >= e
        s = torch.where(empty, BIG, s)
        e = torch.where(empty, -BIG, e)
        s, e = _clip_slots(*_merge_sorted(s, e))
    return s, e


def csg_intersect(shape, ro, rd, tmin, tmax):
    """-> (t (N,), hit (N,)): the first interval boundary in (tmin, tmax)."""
    s, e = intervals_of(shape, ro, rd)
    cand = torch.cat([s, e], 1)
    valid = (s <= e).repeat(1, 2)
    ok = valid & (cand > tmin[:, None]) & (cand < tmax[:, None])
    t = torch.where(ok, cand, BIG).amin(1)
    return t, t < BIG


def csg_normal(shape, p, eps=1e-4):
    """The normal at a CSG surface point: the central-difference gradient of
    the tree's approximate signed distance (``_sdf_of``)."""
    g = []
    for k in range(3):
        d = torch.zeros(3, dtype=p.dtype, device=p.device)
        d[k] = eps
        g.append(_sdf_of(shape, p + d) - _sdf_of(shape, p - d))
    g = torch.stack(g, -1)
    ln = norm3(g)[:, None]
    up = torch.zeros_like(p[:1])
    up[:, 1] = 1.0
    return torch.where(ln > 1e-12, g / torch.clamp_min(ln, 1e-12), up)


def _sdf_of(shape, q):
    """Approximate signed distance of a CSG tree, for its normals."""
    if isinstance(shape, CSGUnion):
        return torch.minimum(_sdf_of(shape.a, q), _sdf_of(shape.b, q))
    if isinstance(shape, CSGIntersection):
        return torch.maximum(_sdf_of(shape.a, q), _sdf_of(shape.b, q))
    if isinstance(shape, CSGDifference):
        return torch.maximum(_sdf_of(shape.a, q), -_sdf_of(shape.b, q))
    if isinstance(shape, S.Sphere):
        return norm3(q - on_device(shape, "c", q)) - shape.r
    if isinstance(shape, S.BoxAABB):
        lo, up = on_device(shape, "lower", q), on_device(shape, "upper", q)
        d = (q - (lo + up) / 2).abs() - (up - lo) / 2
        return norm3(torch.clamp_min(d, 0.0)) + torch.clamp_max(d.amax(-1), 0.0)
    if isinstance(shape, S.BoxOBB):
        return _sdf_of(shape.base, affine(on_device(shape, "m_inv", q), q))
    if isinstance(shape, S.Cone):
        # the distance to the infinite cone, clipped by the base plane (approximate)
        nv = on_device(shape, "n", q)
        o = q - on_device(shape, "apex", q)
        h = dot(o, nv)
        radial = norm3(o - h[:, None] * nv)
        d_cone = (radial + h * (shape.r / shape.h)) * shape.h / np.sqrt(shape.r**2 + shape.h**2)
        return torch.maximum(d_cone, -(h + shape.h))
    if isinstance(shape, S.Cylinder):
        nv = on_device(shape, "n", q)
        o = q - on_device(shape, "p0", q)
        h = dot(o, nv)
        radial = norm3(o - h[:, None] * nv) - shape.r
        ln = float(np.linalg.norm(shape.p1 - shape.p0))
        return torch.maximum(radial, torch.maximum(-h, h - ln))
    raise TypeError(type(shape))
