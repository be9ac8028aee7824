"""Closed-form per-type ray queries.  Counterpart of pine_tpu/scene/intersect.py.

Each analytic shape type has:

- ``intersect_T(params (M,k), ro (N,3), rd (N,3), tmin (N,1), tmax (N,1))``
  -> t (N,M), BIG on a miss: pine_tpu's brute-force product for scenes of
  24 or fewer prims, here the "plain" route's query of a type no kernel
  tests (lines; accel/dense_traverse.plain_query);
- ``surface_info_T(rows (N,k), p (N,3))`` -> (p_corrected, n, uv) for lanes
  whose closest hit is of type T (rows are the per-lane gathered params);
- ``sample_T(rows, p, u)`` area sampling for NEE and ``pdf_T`` the matching
  solid-angle pdf for MIS.
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core.sampling import sample_disk_concentric, uniform_hemisphere
from pine_tpu_torch.core.vecmath import (
    Pi, cartesian_to_spherical, coordinate_system, cross, dot, dotk, length,
    length_squared, safe_normalize,
)
from pine_tpu_torch.scene import shapes as S

BIG = 1e30
EPS = 1e-6


def _bc(ro, rd):
    """Rays get a prim axis: (N,1,3)."""
    return ro[:, None, :], rd[:, None, :]


def _col3(params, i):
    return params[None, :, i:i + 3]


def _col(params, i):
    return params[None, :, i]


def _valid_t(t, valid, tmin, tmax):
    return torch.where(valid & (t > tmin) & (t < tmax), t, BIG)


# ---------------------------------------------------------------- sphere ----

def intersect_sphere(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    c, r = _col3(params, 0), _col(params, 3)
    ro_p = o - c
    b = (ro_p * d).sum(-1)
    cc = (ro_p * ro_p).sum(-1) - r * r
    disc = b * b - cc
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t = torch.where(t0 < tmin, -b + sq, t0)
    return _valid_t(t, disc > 0.0, tmin, tmax)


def surface_info_sphere(rows, p):
    c, r = rows[:, 0:3], rows[:, 3:4]
    n = safe_normalize(p - c)
    return c + n * r, n, cartesian_to_spherical(n)


def sample_sphere(rows, p, u):
    """Solid-angle cone sampling."""
    c, r = rows[:, 0:3], rows[:, 3]
    l = length(c - p)
    rl = r / l
    cos_theta = fm.sqrt(torch.clamp_min(1.0 - rl * rl, 0.0))
    solid = 2 * Pi * (1.0 - cos_theta)
    cos_wo = 1.0 - u[:, 1] * (1.0 - cos_theta)
    sin_wo = fm.sqrt(torch.clamp_min(1.0 - cos_wo * cos_wo, 0.0))
    phi = u[:, 0] * 2 * Pi
    w_local = torch.stack([sin_wo * fm.cos(phi), sin_wo * fm.sin(phi), cos_wo], -1)
    z = (c - p) / l[..., None]
    t, b = coordinate_system(z)
    w = w_local[:, 0:1] * t + w_local[:, 1:2] * b + w_local[:, 2:3] * z
    ro_p = p - c
    bq = dot(ro_p, w)
    cq = length_squared(ro_p) - r * r
    disc = torch.clamp_min(bq * bq - cq, 0.0)
    dist = -bq - fm.sqrt(disc)
    sp = p + w * dist[..., None]
    n = safe_normalize(sp - c)
    pdf = 1.0 / torch.clamp_min(solid, EPS)
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_sphere(rows, ro, rd, t, ns):
    c, r = rows[:, 0:3], rows[:, 3]
    l = length(c - ro)
    rl = r / l
    cos_theta = fm.sqrt(torch.clamp_min(1.0 - rl * rl, 0.0))
    solid = 2 * Pi * (1.0 - cos_theta)
    return 1.0 / torch.clamp_min(solid, EPS)


# ------------------------------------------------------------------ rect ----

def intersect_rect(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    pos, ex, ey, n = _col3(params, 0), _col3(params, 3), _col3(params, 6), _col3(params, 9)
    lx, ly = _col(params, 12), _col(params, 13)
    denom = (d * n).sum(-1)
    t = ((pos - o) * n).sum(-1) / torch.where(denom == 0.0, 1.0, denom)
    p = o + t[..., None] * d - pos
    u = (p * ex).sum(-1) / lx
    v = (p * ey).sum(-1) / ly
    ok = (denom != 0.0) & (u.abs() <= 0.5) & (v.abs() <= 0.5)
    return _valid_t(t, ok, tmin, tmax)


def surface_info_rect(rows, p):
    pos, ex, ey, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    lx, ly = rows[:, 12:13], rows[:, 13:14]
    rp = p - pos
    u = dotk(rp, ex) / lx
    v = dotk(rp, ey) / ly
    p_c = pos + ex * lx * u + ey * ly * v
    return p_c, n, torch.cat([u + 0.5, v + 0.5], -1)


def sample_rect(rows, p, u):
    pos, ex, ey, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    lx, ly = rows[:, 12:13], rows[:, 13:14]
    sp = pos + (u[:, 0:1] - 0.5) * ex * lx + (u[:, 1:2] - 0.5) * ey * ly
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    area = (lx * ly)[:, 0]
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * area, EPS)
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_rect(rows, ro, rd, t, ns):
    area = rows[:, 12] * rows[:, 13]
    return t * t / torch.clamp_min(area * dot(ns, rd).abs(), EPS)


# ------------------------------------------------------------------ disk ----

def intersect_disk(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    pos, n, r = _col3(params, 0), _col3(params, 3), _col(params, 12)
    denom = (d * n).sum(-1)
    t = ((pos - o) * n).sum(-1) / torch.where(denom == 0.0, 1.0, denom)
    p = o + t[..., None] * d - pos
    ok = (denom != 0.0) & ((p * p).sum(-1) <= r * r)
    return _valid_t(t, ok, tmin, tmax)


def surface_info_disk(rows, p):
    pos, n, u_ax, v_ax = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    ex = dotk(p - pos, u_ax)
    ey = dotk(p - pos, v_ax)
    return pos + ex * u_ax + ey * v_ax, n, torch.cat([ex, ey], -1)


def sample_disk(rows, p, u):
    pos, n, u_ax, v_ax = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    r = rows[:, 12:13]
    uv = sample_disk_concentric(u)
    sp = pos + r * u_ax * uv[:, 0:1] + r * v_ax * uv[:, 1:2]
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    area = Pi * (r[:, 0] * r[:, 0])
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * area, EPS)
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_disk(rows, ro, rd, t, ns):
    r = rows[:, 12]
    area = Pi * (r * r)
    return t * t / torch.clamp_min(area * dot(ns, rd).abs(), EPS)


# ----------------------------------------------------------------- plane ----

def intersect_plane(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    pos, n = _col3(params, 0), _col3(params, 3)
    denom = (d * n).sum(-1)
    t = ((pos - o) * n).sum(-1) / torch.where(denom == 0.0, 1.0, denom)
    return _valid_t(t, denom != 0.0, tmin, tmax)


def surface_info_plane(rows, p):
    pos, n, u_ax, v_ax = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    dp = p - pos
    u = dotk(dp, u_ax)
    v = dotk(dp, v_ax)
    return pos + u * u_ax + v * v_ax, n, torch.cat([u, v], -1)


def sample_plane(rows, p, u):
    """Hemisphere projection sampling."""
    pos, n, u_ax, v_ax = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    sph = uniform_hemisphere(u)
    l = dot(p - pos, n).abs()
    ex = l * sph[:, 0] / torch.clamp_min(sph[:, 2], 1e-4)
    ey = l * sph[:, 1] / torch.clamp_min(sph[:, 2], 1e-4)
    dp = p - pos
    proj = pos + u_ax * dotk(dp, u_ax) + v_ax * dotk(dp, v_ax)
    sp = proj + u_ax * ex[..., None] + v_ax * ey[..., None]
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    pdf = torch.full_like(dist, 1.0 / (2 * Pi))
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_plane(rows, ro, rd, t, ns):
    return torch.full_like(t, 1.0 / (2 * Pi))


# ------------------------------------------------------------------ aabb ----

def _slab(lower, upper, o, d, tmin, tmax):
    """Slab test -> (tnear, tfar, ok) with the parallel-axis outside check."""
    par = d.abs() < 1e-6
    inv = 1.0 / torch.where(par, torch.where(d < 0, -1e-6, 1e-6), d)
    t0 = (lower - o) * inv
    t1 = (upper - o) * inv
    near = torch.maximum(torch.minimum(t0, t1).amax(-1), torch.as_tensor(tmin))
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), torch.as_tensor(tmax))
    outside = par & ((o < lower) | (o > upper))
    return near, far, (near <= far) & ~outside.any(-1)


def intersect_aabb(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    near, far, ok = _slab(_col3(params, 0), _col3(params, 3), o, d, tmin, tmax)
    t = torch.where(near > tmin, near, far)
    return torch.where(ok & (t > tmin) & (t <= tmax), t, BIG)


def _aabb_face(lower, upper, p):
    centroid = (lower + upper) / 2
    diag = torch.clamp_min(upper - lower, EPS)
    pu = (p - centroid) / diag
    axis = pu.abs().argmax(-1)
    sign = torch.sign(torch.gather(pu, -1, axis[:, None]))[:, 0]
    onehot = torch.arange(3, device=p.device)[None, :] == axis[:, None]
    n = torch.where(onehot, sign[:, None], torch.zeros_like(p))
    face = torch.where(sign[:, None] > 0, upper, lower)
    return torch.where(onehot, face, p), n


def surface_info_aabb(rows, p):
    p_c, n = _aabb_face(rows[:, 0:3], rows[:, 3:6], p)
    return p_c, n, torch.zeros_like(p[:, :2])


def sample_aabb(rows, p, u):
    """Face sampling."""
    lower, upper = rows[:, 0:3], rows[:, 3:6]
    diag = upper - lower
    ux = u[:, 0] * 3.0
    axis = (ux.to(torch.int32)).clamp(0, 2)
    ux = ux - axis
    b = u[:, 1] < 0.5
    uy = torch.where(b, u[:, 1] * 2.0, u[:, 1] * 2.0 - 1.0)
    ar = torch.arange(3, device=p.device)[None, :]
    a1 = (axis[:, None] + 1) % 3
    a2 = (axis[:, None] + 2) % 3
    on_axis = ar == axis[:, None]
    p0 = torch.where(on_axis, torch.where(b[:, None], upper, lower), lower)
    p0 = p0 + torch.where(ar == a1, ux[:, None] * torch.gather(diag, -1, a1.long()), 0.0)
    p0 = p0 + torch.where(ar == a2, uy[:, None] * torch.gather(diag, -1, a2.long()), 0.0)
    n = torch.where(on_axis, torch.where(b[:, None], 1.0, -1.0), 0.0)
    dvec = p0 - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    area = 2 * (diag[:, 0] * diag[:, 1] + diag[:, 0] * diag[:, 2] + diag[:, 1] * diag[:, 2])
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * area, EPS)
    return dict(p=p0, n=n, w=w, distance=dist, pdf=pdf)


def pdf_aabb(rows, ro, rd, t, ns):
    d = rows[:, 3:6] - rows[:, 0:3]
    area = 2 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2])
    return t * t / torch.clamp_min(area * dot(ns, rd).abs(), EPS)


# ------------------------------------------------------------------- obb ----

def _apply34(m, v, affine=True):
    """Row-major 3x4 matrices m (...,12) applied to points/dirs v (...,3)."""
    out = torch.stack([
        v[..., 0] * m[..., 4 * i] + v[..., 1] * m[..., 4 * i + 1] + v[..., 2] * m[..., 4 * i + 2]
        for i in range(3)
    ], -1)
    return out + m[..., 3:12:4] if affine else out


def _apply34_t(m, v):
    """Transpose of the 3x3 part of row-major 3x4 matrices applied to v."""
    return torch.stack([
        v[..., 0] * m[..., i] + v[..., 1] * m[..., 4 + i] + v[..., 2] * m[..., 8 + i]
        for i in range(3)
    ], -1)


def intersect_obb(params, ro, rd, tmin, tmax):
    """Transform to local, slab, map t back as world distances."""
    o, d = _bc(ro, rd)
    lower, upper = _col3(params, 0), _col3(params, 3)
    m, mi = params[None, :, 6:18], params[None, :, 18:30]
    o_l = _apply34(mi, o)
    d_l = _apply34(mi, d, affine=False)
    d_l = d_l / torch.clamp_min(fm.sqrt((d_l * d_l).sum(-1, keepdim=True)), 1e-20)
    near, far, ok = _slab(lower, upper, o_l, d_l, 0.0, BIG)

    def world_t(t_l):
        p_w = _apply34(m, o_l + t_l[..., None] * d_l)
        dw = p_w - o
        return fm.sqrt((dw * dw).sum(-1))

    t = torch.where(near > 0.0, world_t(near), world_t(far))
    return torch.where(ok & (t > tmin) & (t <= tmax), t, BIG)


def surface_info_obb(rows, p):
    m, mi = rows[:, 6:18], rows[:, 18:30]
    p_c, n_l = _aabb_face(rows[:, 0:3], rows[:, 3:6], _apply34(mi, p))
    return _apply34(m, p_c), safe_normalize(_apply34_t(mi, n_l)), torch.zeros_like(p[:, :2])


def sample_obb(rows, p, u):
    ss = sample_aabb(rows, p, u)
    sp = _apply34(rows[:, 6:18], ss["p"])
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    return dict(p=sp, n=ss["n"], w=w, distance=dist, pdf=ss["pdf"])


def pdf_obb(rows, ro, rd, t, ns):
    return pdf_aabb(rows, ro, rd, t, ns)


# -------------------------------------------------------------- triangle ----

def intersect_triangle(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    v0, v1, v2 = _col3(params, 0), _col3(params, 3), _col3(params, 6)
    e1 = v1 - v0
    e2 = v2 - v0
    tv = o - v0
    pv = cross(d, e2)
    qv = cross(tv, e1)
    det = (pv * e1).sum(-1)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    t = (qv * e2).sum(-1) * inv
    u = (pv * tv).sum(-1) * inv
    v = (qv * d).sum(-1) * inv
    ok = (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (u + v <= 1.0)
    return _valid_t(t, ok, tmin, tmax)


def surface_info_triangle(rows, p):
    v0, v1, v2, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    u = dotk(p - v0, v1 - v0)
    v = dotk(p - v0, v2 - v0)
    return p, n, torch.cat([u, v], -1)


def sample_triangle(rows, p, u):
    v0, v1, v2, n = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
    flip = (u[:, 0] + u[:, 1]) > 1.0
    uu = torch.where(flip[:, None], 1.0 - u, u)
    sp = v0 + uu[:, 0:1] * (v1 - v0) + uu[:, 1:2] * (v2 - v0)
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    area = length(cross(v1 - v0, v2 - v0)) / 2
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * area, EPS)
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_triangle(rows, ro, rd, t, ns):
    v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    area = length(cross(v1 - v0, v2 - v0)) / 2
    return t * t / torch.clamp_min(area * dot(ns, rd).abs(), EPS)


# ------------------------------------------------------------------ cone ----

def intersect_cone(params, ro, rd, tmin, tmax):
    """Finite cone, clamped to its base plane."""
    o_w, d = _bc(ro, rd)
    apex, n, A2 = _col3(params, 0), _col3(params, 3), _col(params, 6)
    h = _col(params, 10)
    o = o_w - apex
    dn = (d * n).sum(-1)
    on = (o * n).sum(-1)
    a = -A2 * dn * dn + (d * d).sum(-1)
    b = 2 * (-A2 * on * dn + (o * d).sum(-1))
    c = -A2 * on * on + (o * o).sum(-1)
    disc = b * b - 4 * a * c
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a == 0.0, EPS, a)
    t0 = (-b - sq) / (2 * a_safe)
    t = torch.where(t0 < tmin, t0 + sq / a_safe, t0)
    height = ((o + t[..., None] * d) * n).sum(-1)
    ok = (disc > 0.0) & (height < 0.0) & (height >= -h)
    return _valid_t(t, ok, tmin, tmax)


def surface_info_cone(rows, p):
    apex, n = rows[:, 0:3], rows[:, 3:6]
    A, Sf = rows[:, 7:8], rows[:, 8:9]
    l = length(p - apex)[..., None] * A
    x = apex - n * l
    nn = safe_normalize(p - x)
    return x + nn * l * Sf, nn, torch.zeros_like(p[:, :2])


def sample_cone(rows, p, u):
    sp = rows[:, 0:3]
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    return dict(p=sp, n=-w, w=w, distance=dist, pdf=torch.zeros_like(dist))


def pdf_cone(rows, ro, rd, t, ns):
    r, h = rows[:, 9], rows[:, 10]
    area = Pi * r * fm.sqrt(r * r + h * h)
    return t * t / torch.clamp_min(area, EPS) * dot(ns, rd).abs()


# -------------------------------------------------------------- cylinder ----

def intersect_cylinder(params, ro, rd, tmin, tmax):
    o, d = _bc(ro, rd)
    p0, p1, n, r = _col3(params, 0), _col3(params, 3), _col3(params, 6), _col(params, 9)
    m = o - p0
    v = d - (d * n).sum(-1, keepdim=True) * n
    w = m - (m * n).sum(-1, keepdim=True) * n
    a = (v * v).sum(-1)
    b = 2 * (v * w).sum(-1)
    c = (w * w).sum(-1) - r * r
    disc = b * b - 4 * a * c
    sq = fm.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a == 0.0, EPS, a)
    t0 = (-b - sq) / (2 * a_safe)
    t = torch.where(t0 < tmin, (-b + sq) / (2 * a_safe), t0)
    axial = ((o + t[..., None] * d - p0) * n).sum(-1)
    len_ax = ((p1 - p0) * n).sum(-1)
    ok = (disc >= 0.0) & (axial >= 0.0) & (axial <= len_ax)
    return _valid_t(t, ok, tmin, tmax)


def surface_info_cylinder(rows, p):
    p0, n = rows[:, 0:3], rows[:, 6:9]
    proj = p0 + dotk(p - p0, n) * n
    return p, safe_normalize(p - proj), torch.zeros_like(p[:, :2])


def sample_cylinder(rows, p, u):
    return sample_cone(rows, p, u)


def pdf_cylinder(rows, ro, rd, t, ns):
    return torch.zeros_like(t)


# ------------------------------------------------------------------ line ----

def intersect_line(params, ro, rd, tmin, tmax):
    """A line with a thickness (geometry.cpp:180-214): the segment in the
    ray's look-at frame, where the ray runs along +z; a hit where the
    segment's closest approach to the ray lies within the thickness."""
    o_w, _ = _bc(ro, rd)
    p0, p1, thick = _col3(params, 0), _col3(params, 3), _col(params, 15)
    z = rd
    up = torch.tensor([0.0, 1.0, 0.0], dtype=rd.dtype, device=rd.device).expand_as(rd)
    z_adj = torch.where((dot(z, up).abs() > 0.999)[..., None],
                        safe_normalize(z + torch.tensor([0.0, 0.0, 1e-5], dtype=rd.dtype,
                                                        device=rd.device)), z)
    x = safe_normalize(cross(up, z_adj))
    y = cross(z_adj, x)

    def frame(rel):
        return torch.stack([dot(rel, x[:, None, :]), dot(rel, y[:, None, :]),
                            dot(rel, z[:, None, :])], -1)

    o = frame(p0 - o_w)
    dd = frame(p1 - o_w) - o
    dz = dd[..., 2]
    det = dot(dd, dd) - dz * dz
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    tt = torch.clamp((-dot(o, dd) + dz * o[..., 2]) / det, 0.0, 1.0)
    zhit = torch.minimum(torch.maximum(o[..., 2] + tt * dz, tmin + thick), tmax)
    closest = o + tt[..., None] * dd
    dist = fm.sqrt(closest[..., 0] ** 2 + closest[..., 1] ** 2 + (closest[..., 2] - zhit) ** 2)
    return torch.where(dist <= thick, zhit, BIG)


def surface_info_line(rows, p):
    p0, p1, tz = rows[:, 0:3], rows[:, 3:6], rows[:, 12:15]
    lt = dotk(p - p0, tz)
    lp = p0 + (p1 - p0) * lt / torch.clamp_min(dotk(p1 - p0, tz), EPS)
    return p, safe_normalize(p - lp), torch.cat([lt, torch.zeros_like(lt)], -1)


def sample_line(rows, p, u):
    p0, p1 = rows[:, 0:3], rows[:, 3:6]
    tx, ty = rows[:, 6:9], rows[:, 9:12]
    thick, ln = rows[:, 15:16], rows[:, 16]
    phi = u[:, 1:2] * 2 * Pi
    sp = p0 + (p1 - p0) * u[:, 0:1] + thick * fm.cos(phi) * tx + thick * fm.sin(phi) * ty
    n = fm.cos(phi) * tx + fm.sin(phi) * ty
    dvec = sp - p
    dist = length(dvec)
    w = dvec / torch.clamp_min(dist[..., None], EPS)
    area = 2 * Pi * thick[:, 0] * ln
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * area, EPS)
    return dict(p=sp, n=n, w=w, distance=dist, pdf=pdf)


def pdf_line(rows, ro, rd, t, ns):
    area = 2 * Pi * rows[:, 15] * rows[:, 16]
    return t * t / torch.clamp_min(area * dot(ns, rd).abs(), EPS)


# ---------------------------------------------------------------- tables ----

_TYPES = {
    S.SPHERE: "sphere", S.RECT: "rect", S.DISK: "disk", S.PLANE: "plane",
    S.BOX_AABB: "aabb", S.BOX_OBB: "obb", S.TRIANGLE: "triangle",
    S.CONE: "cone", S.CYLINDER: "cylinder", S.LINE: "line",
}
INTERSECT = {t: globals()[f"intersect_{n}"] for t, n in _TYPES.items()}
SURFACE_INFO = {t: globals()[f"surface_info_{n}"] for t, n in _TYPES.items()}
SAMPLE = {t: globals()[f"sample_{n}"] for t, n in _TYPES.items()}
PDF = {t: globals()[f"pdf_{n}"] for t, n in _TYPES.items()}
