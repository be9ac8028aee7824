"""The plain reference renderer: the path tracer and the ambient occlusion of
the upstream renderer (wicstas/pine: path.cpp, ao.cpp), written as plain
PyTorch over a batch of pixel lanes, every primitive tested against every
ray (no acceleration structure), in a dtype of the caller's choosing.

It reproduces the semantics the benchmark's integrators state, so that the
same pixels under the same blue-noise values give the same radiance:

- camera: a pinhole ThinLenCamera, film position (x + jitter) / W, the
  image plane at z = 1 spanning 2 fov (W / H) by 2 fov; jitter from
  dimensions 0-1;
- path (depth D): D closest-hit casts; an emissive hit adds its radiance
  (front face only) under the balance heuristic against the light's area
  pdf, unless the bounce before was a delta one; at each of the first D - 1
  vertices one light sample (dimensions +0..+2 of the depth's block of 16,
  from 4) with a shadow ray and the balance heuristic against the BSDF,
  then a BSDF sample (dimensions +5, +6): Lambertian, or a GGX conductor
  (Schlick's Fresnel of the albedo) whose roughness is raised to 0.6 after
  a diffuse bounce, a mirror below 1e-2; everything after the direct hit
  clamped to 8 per channel;
- ao: one closest-hit cast, then eight uniform-hemisphere occlusion rays
  (dimensions 4 + 2k) of length ``radius`` from the hit offset along the
  normal turned towards the viewer; the unoccluded share, 1 on a miss;
- film: the mean over the samples, then the Uncharted 2 filmic curve.

Ray origins are offset from surfaces by the upstream's integer step on the
float32 bit pattern.  The reference imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.sampler import BlueNoise
from perfbench.reference.scene import DIFFUSE, EMISSIVE, METAL

BIG = 1e30
CLAMP = 8.0
MIN_ROUGHNESS = 0.6
DELTA_ROUGHNESS = 1e-2
DELTA_ALPHA = 1e-4
EPS = 1e-7
PAIRS = 1 << 24  # ray-primitive pairs formed at once
RECT, CONE, BOX, TRI = 0, 1, 2, 3
KINDS = ("rect", "cone", "box", "tri")
_NX, _PX = [1, 2, 0], [2, 0, 1]


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    return a[..., _NX] * b[..., _PX] - a[..., _PX] * b[..., _NX]


def normalize(v):
    return v / torch.clamp_min(torch.sqrt(dot(v, v))[..., None], 1e-20)


def frame(n):
    """An orthonormal (t, b) around unit normals n."""
    e = torch.zeros_like(n)
    pick = (n[..., 0].abs() > n[..., 1].abs())[..., None]
    ey, ex = e.clone(), e.clone()
    ey[..., 1] = 1.0
    ex[..., 0] = 1.0
    t = normalize(torch.where(pick, cross(n, ey), cross(n, ex)))
    return t, cross(n, t)


def to_local(n, w):
    t, b = frame(n)
    return torch.stack([dot(w, t), dot(w, b), dot(w, n)], -1)


def to_world(n, w):
    t, b = frame(n)
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def flip_towards(v, n):
    return torch.where(dot(v, n)[..., None] < 0.0, -v, v)


def offset_origin(p, n):
    """The upstream's origin offset: an integer step of 256 n on the float32
    bit pattern, or a float step of n / 65536 near the origin."""
    dtype = p.dtype
    p, n = p.float().contiguous(), n.float()
    step = (256.0 * n).to(torch.int32)
    p_i = (p.view(torch.int32) + torch.where(p < 0.0, -step, step)).view(torch.float32)
    return torch.where(p.abs() < 1.0 / 32.0, p + n / 65536.0, p_i).to(dtype)


# ---------------------------------------------------------------- geometry

def _t_rect(P, o, d, tmin, tmax):
    pos, ex, ey, n = P[None, :, 0:3], P[None, :, 3:6], P[None, :, 6:9], P[None, :, 9:12]
    lx, ly = P[None, :, 12], P[None, :, 13]
    denom = dot(d, n)
    t = dot(pos - o, n) / torch.where(denom == 0.0, 1.0, denom)
    q = o + t[..., None] * d - pos
    ok = (denom != 0.0) & ((dot(q, ex) / lx).abs() <= 0.5) & ((dot(q, ey) / ly).abs() <= 0.5)
    return torch.where(ok & (t > tmin) & (t < tmax), t, BIG)


def _t_cone(P, o_w, d, tmin, tmax):
    apex, n, a2, h = P[None, :, 0:3], P[None, :, 3:6], P[None, :, 6], P[None, :, 10]
    o = o_w - apex
    dn, on = dot(d, n), dot(o, n)
    a = -a2 * dn * dn + dot(d, d)
    b = 2 * (-a2 * on * dn + dot(o, d))
    c = -a2 * on * on + dot(o, o)
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_s = torch.where(a == 0.0, 1e-6, a)
    t0 = (-b - sq) / (2 * a_s)
    t = torch.where(t0 < tmin, t0 + sq / a_s, t0)
    height = dot(o + t[..., None] * d, n)
    ok = (disc > 0.0) & (height < 0.0) & (height >= -h)
    return torch.where(ok & (t > tmin) & (t < tmax), t, BIG)


def _affine(m, v, move=True):
    out = torch.stack([v[..., 0] * m[..., 4 * i] + v[..., 1] * m[..., 4 * i + 1]
                       + v[..., 2] * m[..., 4 * i + 2] for i in range(3)], -1)
    return out + m[..., 3:12:4] if move else out


def _slab(lo, up, o, d, tmin, tmax):
    par = d.abs() < 1e-6
    inv = 1.0 / torch.where(par, torch.where(d < 0, -1e-6, 1e-6), d)
    t0, t1 = (lo - o) * inv, (up - o) * inv
    near = torch.clamp_min(torch.minimum(t0, t1).amax(-1), tmin)
    far = torch.clamp_max(torch.maximum(t0, t1).amin(-1), tmax)
    outside = (par & ((o < lo) | (o > up))).any(-1)
    return near, far, (near <= far) & ~outside


def _t_box(P, o, d, tmin, tmax):
    lo, up, m, mi = P[None, :, 0:3], P[None, :, 3:6], P[None, :, 6:18], P[None, :, 18:30]
    o_l = _affine(mi, o)
    d_l = _affine(mi, d, move=False)
    d_l = d_l / torch.clamp_min(torch.sqrt(dot(d_l, d_l))[..., None], 1e-20)
    near, far, ok = _slab(lo, up, o_l, d_l, 0.0, BIG)
    t_l = torch.where(near > 0.0, near, far)
    w = _affine(m, o_l + t_l[..., None] * d_l) - o
    t = torch.sqrt(dot(w, w))
    return torch.where(ok & (t > tmin) & (t <= tmax), t, BIG)


def _t_tri(P, o, d, tmin, tmax):
    v0, e1, e2 = P[None, :, 0:3], P[None, :, 3:6], P[None, :, 6:9]
    tv = o - v0
    pv, qv = cross(d, e2), cross(tv, e1)
    det = dot(pv, e1)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    t, u, v = dot(qv, e2) * inv, dot(pv, tv) * inv, dot(qv, d) * inv
    ok = (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (u + v <= 1.0)
    return torch.where(ok & (t > tmin) & (t < tmax), t, BIG)


TESTS = {RECT: _t_rect, CONE: _t_cone, BOX: _t_box, TRI: _t_tri}


def closest(S, o, d, tmin, tmax):
    """-> (t, kind, index): the nearest hit of each ray over every prim,
    t = BIG on a miss; a later kind wins only on a strictly smaller t."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    best_k = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_i = torch.zeros(n, dtype=torch.int64, device=o.device)
    for kind, test in TESTS.items():
        P = S["isect_" + KINDS[kind]]
        if P.shape[0] == 0:
            continue
        step = max(1, PAIRS // P.shape[0])
        for a in range(0, n, step):
            sl = slice(a, a + step)
            t = test(P, o[sl, None, :], d[sl, None, :], tmin[sl, None], tmax[sl, None])
            t_min, i_min = t.min(1)
            better = t_min < best_t[sl]
            best_t[sl] = torch.where(better, t_min, best_t[sl])
            best_k[sl] = torch.where(better, kind, best_k[sl])
            best_i[sl] = torch.where(better, i_min, best_i[sl])
    return best_t, best_k, best_i


def surface(S, kind, idx, p):
    """-> (p on the surface, unit normal, material row) at the hits."""
    n_out = torch.zeros_like(p)
    p_out, mat = p, torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for k, name in enumerate(KINDS):
        T = S[name]
        if T.shape[0] == 0:
            continue
        r = T[idx.clamp(0, T.shape[0] - 1)]
        if k == RECT:
            pos, ex, ey, nn = r[:, 0:3], r[:, 3:6], r[:, 6:9], r[:, 9:12]
            lx, ly = r[:, 12:13], r[:, 13:14]
            q = p - pos
            pc = pos + ex * lx * (dot(q, ex)[:, None] / lx) + ey * ly * (dot(q, ey)[:, None] / ly)
        elif k == CONE:
            apex, axis, A, Sf = r[:, 0:3], r[:, 3:6], r[:, 7:8], r[:, 8:9]
            q = p - apex
            ell = torch.sqrt(dot(q, q))[:, None] * A
            x = apex - axis * ell
            nn = normalize(p - x)
            pc = x + nn * ell * Sf
        elif k == BOX:
            lo, up, m, mi = r[:, 0:3], r[:, 3:6], r[:, 6:18], r[:, 18:30]
            pl = _affine(mi, p)
            c = (lo + up) / 2
            rel = (pl - c) / torch.clamp_min(up - lo, 1e-6)
            axis = rel.abs().argmax(-1)
            sign = torch.sign(rel.gather(1, axis[:, None]))
            onehot = torch.arange(3, device=p.device)[None, :] == axis[:, None]
            nl = torch.where(onehot, sign, torch.zeros_like(pl))
            pl = torch.where(onehot, torch.where(sign > 0, up, lo), pl)
            pc = _affine(m, pl)
            nn = normalize(torch.stack([dot(nl, mi[:, i:12:4]) for i in range(3)], -1))
        else:
            pc, nn = p, r[:, 9:12]
        sel = (kind == k)[:, None]
        p_out = torch.where(sel, pc, p_out)
        n_out = torch.where(sel, nn, n_out)
        mat = torch.where(kind == k, r[:, -1].float().round().long(), mat)
    return p_out, n_out, mat


# --------------------------------------------------------------- sampling

def cosine_hemisphere(u):
    ux, uy = u[..., 0] * 2.0 - 1.0, u[..., 1] * 2.0 - 1.0
    use_x = ux.abs() > uy.abs()
    r = torch.where(use_x, ux, uy)
    th = torch.where(use_x, (math.pi / 4) * (uy / torch.where(ux == 0.0, 1.0, ux)),
                     math.pi / 2 - (math.pi / 4) * (ux / torch.where(uy == 0.0, 1.0, uy)))
    dx, dy = r * torch.cos(th), r * torch.sin(th)
    return torch.stack([dx, dy, torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))], -1)


def uniform_hemisphere(u):
    phi, z = u[..., 0] * math.pi * 2, u[..., 1]
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], -1)


def _tan2(w):
    c2 = w[..., 2] * w[..., 2]
    return (1.0 - c2) / torch.clamp_min(c2, EPS)


def ggx_d(alpha, wm):
    """Isotropic Trowbridge-Reitz density."""
    c2 = wm[..., 2] * wm[..., 2]
    e1 = 1.0 + _tan2(wm) / (alpha * alpha)
    d = 1.0 / torch.clamp_min(math.pi * alpha * alpha * c2 * c2 * e1 * e1, EPS)
    return torch.where(c2 * c2 < 1e-6, 0.0, d)


def ggx_lambda(alpha, w):
    return (torch.sqrt(1.0 + alpha * alpha * _tan2(w)) - 1.0) / 2.0


def ggx_g(alpha, wi, wo):
    return 1.0 / (1.0 + ggx_lambda(alpha, wi) + ggx_lambda(alpha, wo))


def ggx_pdf(alpha, w, wm):
    """The visible-normal density of wm seen from w."""
    g1 = 1.0 / (1.0 + ggx_lambda(alpha, w))
    dv = g1 / torch.clamp_min(w[..., 2].abs(), EPS) * ggx_d(alpha, wm) * dot(w, wm).abs()
    return torch.clamp_min(dv, EPS)


def ggx_sample_wm(alpha, w, u):
    """A visible microfacet normal (Heitz 2018)."""
    a = alpha[..., None]
    wh = normalize(torch.cat([a * w[..., :2], w[..., 2:3]], -1))
    wh = torch.where(wh[..., 2:3] < 0.0, -wh, wh)
    ez, ex = torch.zeros_like(wh), torch.zeros_like(wh)
    ez[..., 2] = 1.0
    ex[..., 0] = 1.0
    t1 = torch.where((wh[..., 2] < 0.99999)[..., None], normalize(cross(ez, wh)), ex)
    t2 = cross(wh, t1)
    r, phi = torch.sqrt(u[..., 0]), 2 * math.pi * u[..., 1]
    px, py = r * torch.cos(phi), r * torch.sin(phi)
    h = torch.sqrt(torch.clamp_min(1.0 - px * px, 0.0))
    py = (1.0 - (1.0 + wh[..., 2]) / 2.0) * h + (1.0 + wh[..., 2]) / 2.0 * py
    pz = torch.sqrt(torch.clamp_min(1.0 - px * px - py * py, 0.0))
    nh = px[..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    return normalize(torch.cat([a * nh[..., :2], torch.clamp_min(nh[..., 2:3], 1e-6)], -1))


def schlick(f0, c):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp_min(1.0 - c, 0.0), 5.0)[..., None]


def bsdf_sample(kind, albedo, rough, wi, u):
    """-> (wo, f, pdf, delta, valid) in the local frame."""
    wo_d = cosine_hemisphere(u)
    wo_d = torch.where((wi[..., 2] < 0.0)[..., None], -wo_d, wo_d)
    pdf_d = wo_d[..., 2].abs() / math.pi
    alpha = rough * rough
    smooth = alpha < DELTA_ALPHA
    a_s = torch.clamp_min(alpha, DELTA_ALPHA)
    wm = ggx_sample_wm(a_s, wi, u)
    wo_r = 2.0 * dot(wi, wm)[..., None] * wm - wi
    pdf_r = ggx_pdf(a_s, wi, wm) / torch.clamp_min(4 * dot(wi, wm).abs(), EPS)
    f_r = schlick(albedo, dot(wi, wm).abs()) * (
        ggx_d(a_s, wm) * ggx_g(a_s, wo_r, wi)
        / torch.clamp_min((4 * wi[..., 2] * wo_r[..., 2]).abs(), EPS))[..., None]
    wo_m = wi * torch.tensor([-1.0, -1.0, 1.0], dtype=wi.dtype, device=wi.device)
    c_m = wo_m[..., 2].abs()
    f_m = schlick(albedo, c_m) / torch.clamp_min(c_m, EPS)[..., None]
    metal = (kind == METAL)
    wo = torch.where(metal[..., None], torch.where(smooth[..., None], wo_m, wo_r), wo_d)
    f = torch.where(metal[..., None], torch.where(smooth[..., None], f_m, f_r), albedo / math.pi)
    pdf = torch.where(metal, torch.where(smooth, torch.ones_like(pdf_r), pdf_r), pdf_d)
    delta = metal & smooth
    valid = torch.where(metal, smooth | (wi[..., 2] * wo_r[..., 2] > 0.0), pdf_d > 0.0)
    return wo, f, pdf, delta, valid & (pdf > 0.0)


def bsdf_eval(kind, albedo, rough, wi, wo):
    """-> (f, pdf) of a given wo; 0 off the lobe."""
    same = wi[..., 2] * wo[..., 2] > 0.0
    alpha = torch.clamp_min(rough * rough, DELTA_ALPHA)
    wm = normalize(wi + wo)
    wm_f = torch.where(wm[..., 2:3] < 0.0, -wm, wm)
    dg = ggx_d(alpha, wm) * ggx_g(alpha, wo, wi)
    den = torch.clamp_min(4 * wo[..., 2].abs() * wi[..., 2].abs(), EPS)
    pdf_m = ggx_pdf(alpha, wi, wm_f) / torch.clamp_min(4 * dot(wi, wm_f).abs(), EPS)
    f_m = schlick(albedo, dot(wi, wm).abs()) * (dg / den)[..., None]
    metal = kind == METAL
    f = torch.where(metal[..., None], f_m, albedo / math.pi)
    pdf = torch.where(metal, pdf_m, wo[..., 2].abs() / math.pi)
    keep = same & ((kind == DIFFUSE) | metal)
    return torch.where(keep[..., None], f, 0.0), torch.where(keep, pdf, 0.0)


def balance(pf, pg):
    return pf / torch.clamp_min(pf + pg, 1e-20)


# ----------------------------------------------------------------- camera

def look_at(frm, to):
    """Camera-to-world rotation (columns right, up, forward), float32."""
    frm, to = np.asarray(frm, np.float32), np.asarray(to, np.float32)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    z = to - frm
    z = z / np.linalg.norm(z)
    if abs(float(np.dot(z, up))) > 0.999:
        z = z + np.array([0.0, 0.0, 1e-5], np.float32)
        z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 1).astype(np.float32)


def camera_rays(pos, rot, fov2d, xs, ys, W, H, jitter, dtype):
    """Per-lane pinhole rays; ``pos`` (N,3), ``rot`` (N,3,3) columns."""
    wh = torch.tensor([W, H], dtype=torch.float32, device=xs.device)
    p_film = ((torch.stack([xs, ys], -1).to(torch.float32) + jitter) / wh).to(dtype)
    pc = (p_film - 0.5) * 2.0 * fov2d
    d = pc[:, 0:1] * rot[:, :, 0] + pc[:, 1:2] * rot[:, :, 1] + rot[:, :, 2]
    return pos, normalize(d)


def uncharted2(v):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def curve(x):
        return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F

    return curve(v * 2.0) / curve(torch.tensor(11.2, dtype=v.dtype, device=v.device))


# ----------------------------------------------------------- integrators

def tables(scene, device, dtype):
    """The scene's tensors, with the triangles as (v0, e1, e2) for the test."""
    S = scene.on(device, dtype)
    for k in KINDS:
        S["isect_" + k] = S[k]
    tri = S["tri"]
    if tri.shape[0]:
        S["isect_tri"] = torch.cat([tri[:, 0:3], tri[:, 3:6] - tri[:, 0:3],
                                    tri[:, 6:9] - tri[:, 0:3]], 1)
    return S


def _light_sample(S, light, p, u):
    """Uniform point on the light rect -> (wo, distance, pdf, le, valid)."""
    r = S["rect"][light]
    pos, ex, ey, n, lx, ly = r[0:3], r[3:6], r[6:9], r[9:12], r[12], r[13]
    sp = pos + (u[:, 0:1] - 0.5) * ex * lx + (u[:, 1:2] - 0.5) * ey * ly
    dv = sp - p
    dist = torch.sqrt(dot(dv, dv))
    w = dv / torch.clamp_min(dist[:, None], 1e-6)
    pdf = dist * dist / torch.clamp_min(dot(w, n).abs() * (lx * ly), 1e-6)
    le = S["mat_color"][int(r[14].round())].expand_as(p)
    valid = (dot(-w, n) >= 0.0) & (pdf > 0.0) & (le > 0.0).any(-1)
    return w, dist, pdf, le, valid


def path_sample(S, light, o, d, xs, ys, noise, s, depth, dtype):
    """One sample of the path tracer on every lane -> L (N,3)."""
    n, dev = o.shape[0], o.device
    zero = torch.zeros(n, dtype=dtype, device=dev)
    L_dir = torch.zeros(n, 3, dtype=dtype, device=dev)
    L_ind = torch.zeros(n, 3, dtype=dtype, device=dev)
    beta = torch.ones(n, 3, dtype=dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf, prev_delta = zero.clone(), alive.clone()
    diffused = torch.zeros_like(alive)
    lrow = S["rect"][light]
    light_mat = int(lrow[14].round())
    for k in range(depth):
        t, kind, idx = closest(S, o, d, zero, torch.where(alive, torch.finfo(dtype).max, -1.0).to(dtype))
        hit = (t < BIG) & alive
        t_h = torch.where(hit, t, 1.0)
        p, nn, mat = surface(S, kind, idx, o + t_h[:, None] * d)
        emis = hit & (S["mat_kind"][mat] == EMISSIVE)
        front = dot(-d, nn) >= 0.0
        le = torch.where(front[:, None], S["mat_color"][mat], 0.0)
        pdf_l = t_h * t_h / torch.clamp_min(lrow[12] * lrow[13] * dot(nn, d).abs(), 1e-6)
        mis = torch.where(prev_delta, 1.0, balance(prev_pdf, pdf_l))
        add = torch.where(emis[:, None] & (mat == light_mat)[:, None], beta * le * mis[:, None],
                          0.0)
        if k == 0:
            L_dir = L_dir + add
        else:
            L_ind = L_ind + add
        surf = hit & ~emis
        if k + 1 >= depth:
            break
        dim = 4 + 16 * k
        mk = S["mat_kind"][mat]
        albedo = S["mat_albedo"][mat]
        rough = torch.where(mk == METAL,
                            torch.maximum(S["mat_rough"][mat],
                                          torch.where(diffused, MIN_ROUGHNESS, 0.0).to(dtype)),
                            0.0)
        wi = to_local(nn, -d)
        u_b = noise.u2(xs, ys, s, dim + 5).to(dtype)
        wo, f, pdf, delta, valid = bsdf_sample(mk, albedo, rough, wi, u_b)
        wo_w = to_world(nn, wo)
        thr = f * (dot(wo_w, nn).abs() / torch.clamp_min(pdf, 1e-20))[:, None]
        nxt = surf & valid
        # one light sample with a shadow ray
        w, dist, lpdf, lle, lvalid = _light_sample(S, light, p,
                                                   noise.u2(xs, ys, s, dim + 1).to(dtype))
        is_delta = (mk == METAL) & (rough < DELTA_ROUGHNESS)
        do = surf & lvalid & ~is_delta & (lpdf > 0.0)
        so = offset_origin(p, flip_towards(nn, w))
        tsh, _, _ = closest(S, so, w, zero, torch.where(do, dist * (1.0 - 1e-3), -1.0))
        fl, pl = bsdf_eval(mk, albedo, rough, wi, to_local(nn, w))
        c = lle * fl * (dot(w, nn).abs() / torch.clamp_min(lpdf, 1e-20) * balance(lpdf, pl))[:, None]
        L_ind = L_ind + beta * torch.where((do & (tsh >= BIG))[:, None], c, 0.0)
        beta = torch.where(nxt[:, None], beta * thr, beta)
        o = offset_origin(p, flip_towards(nn, wo_w))
        d = wo_w
        alive, prev_pdf, prev_delta = nxt, pdf, delta
        diffused = diffused | (nxt & ~delta)
    return L_dir + torch.clamp_max(L_ind, CLAMP)


def ao_sample(S, radius, o, d, xs, ys, noise, s, dtype):
    """One sample of ambient occlusion on every lane -> (N,) in [0, 1]."""
    n = o.shape[0]
    zero = torch.zeros(n, dtype=dtype, device=o.device)
    t, kind, idx = closest(S, o, d, zero, torch.full_like(zero, torch.finfo(dtype).max))
    hit = t < BIG
    p, nn, _ = surface(S, kind, idx, o + torch.where(hit, t, 1.0)[:, None] * d)
    nn = flip_towards(nn, -d)
    so = offset_origin(p, nn)
    tmax = torch.where(hit, radius, -1.0).to(dtype)
    occ = zero.clone()
    for k in range(8):
        w = to_world(nn, uniform_hemisphere(noise.u2(xs, ys, s, 4 + 2 * k).to(dtype)))
        tb, _, _ = closest(S, so, w, zero, tmax)
        occ = occ + torch.where(tb < BIG, 0.0, 1.0)
    return torch.where(hit, occ / 8, 1.0)


def render_pixels(scene, mode, pixels, W, H, spp, depth=4, device="cpu", dtype=torch.float32,
                  block=8192):
    """Tone-mapped values (N,3) float32 on the host of ``pixels``: rows of
    (x, y, camera position (3), camera forward (3)); ``mode`` "path" or
    "ao"; ``spp`` samples of the 16-spp blue-noise tables."""
    S = tables(scene, device, dtype)
    noise = BlueNoise(device)
    cam = scene.camera
    fov = float(cam["fov"])
    fov2d = torch.tensor(np.array([fov * (W / H), fov], np.float32), device=device).to(dtype)
    light = scene.light
    radius = scene.ao_radius()
    out = []
    for a in range(0, len(pixels), block):
        rows = pixels[a:a + block]
        xs = torch.as_tensor(rows[:, 0].astype(np.int32), device=device)
        ys = torch.as_tensor(rows[:, 1].astype(np.int32), device=device)
        pos = np.asarray(rows[:, 2:5], np.float32)
        rot = np.stack([look_at(p, p + f) for p, f in zip(pos, np.asarray(rows[:, 5:8],
                                                                           np.float32))])
        pos_t = torch.as_tensor(pos, device=device).to(dtype)
        rot_t = torch.as_tensor(rot, device=device).to(dtype)
        acc = torch.zeros(len(rows), 3, dtype=dtype, device=device)
        for s in range(spp):
            o, d = camera_rays(pos_t, rot_t, fov2d, xs, ys, W, H, noise.u2(xs, ys, s, 0), dtype)
            if mode == "path":
                acc = acc + path_sample(S, light, o, d, xs, ys, noise, s, depth, dtype)
            else:
                acc = acc + ao_sample(S, radius, o, d, xs, ys, noise, s, dtype)[:, None]
        out.append(uncharted2(acc / spp).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 3), np.float32)
