"""Shading-frame scattering math, batched.  Counterpart of pine_tpu/core/scattering.py.

All directions are in the local shading frame (z == geometric normal); every
function is a branch-free elementwise form so it runs dense over a wavefront.
The GGX distribution is isotropic (alpha_x == alpha_y == roughness^2).
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core import fmath as fm
from pine_tpu_torch.core import profiler
from pine_tpu_torch.core.sampling import sample_disk_polar
from pine_tpu_torch.core.vecmath import Pi, cross, dot, dotk, length_squared, safe_normalize

EPS = 1e-7


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin2_theta(w):
    return 1.0 - cos2_theta(w)


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp_min(cos2_theta(w), EPS)


def cos_phi(w):
    sin_t = fm.sqrt(torch.clamp_min(sin2_theta(w), 0.0))
    return torch.where(
        sin_t == 0.0, 1.0, (w[..., 0] / torch.clamp_min(sin_t, EPS)).clamp(-1.0, 1.0)
    )


def sin_phi(w):
    sin_t = fm.sqrt(torch.clamp_min(sin2_theta(w), 0.0))
    return torch.where(
        sin_t == 0.0, 1.0, (w[..., 1] / torch.clamp_min(sin_t, EPS)).clamp(-1.0, 1.0)
    )


def same_hemisphere(w0, w1):
    return w0[..., 2] * w1[..., 2] > 0.0


def face_normal(v):
    """Flip v into the +z hemisphere."""
    return torch.where(v[..., 2:3] < 0.0, -v, v)


def reflect_z(w):
    """Mirror reflection about the local z axis."""
    return w * profiler.to_device([-1.0, -1.0, 1.0], w.device, "reflect_z", w.dtype)


def reflect(wi, n):
    return 2.0 * dotk(wi, n) * n - wi


def refract(wi, n, eta):
    """Snell refraction -> (ok, wt, eta_eff); handles rays from either side."""
    cos_i = dot(n, wi)
    flip = cos_i < 0.0
    eta_eff = torch.where(flip, 1.0 / eta, eta)
    cos_i = cos_i.abs()
    n_eff = torch.where(flip[..., None], -n, n)
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = sin2_i / (eta_eff * eta_eff)
    ok = sin2_t < 1.0
    cos_t = fm.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wt = -wi / eta_eff[..., None] + (cos_i / eta_eff - cos_t)[..., None] * n_eff
    return ok, wt, eta_eff


def fr_dielectric(cos_i, eta):
    """Dielectric Fresnel reflectance."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=cos_i.device)
    flip = cos_i < 0.0
    eta = torch.where(flip, 1.0 / eta, eta)
    cos_i = cos_i.abs()
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = fm.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    r_parl = (eta * cos_i - cos_t) / torch.clamp_min(eta * cos_i + cos_t, EPS)
    r_perp = (cos_i - eta * cos_t) / torch.clamp_min(cos_i + eta * cos_t, EPS)
    return torch.where(tir, 1.0, (r_parl * r_parl + r_perp * r_perp) / 2.0)


def fr_schlick(f0, cos_t):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp_min(1.0 - cos_t, 0.0), 5.0)[..., None]


# ---- Trowbridge-Reitz (GGX) microfacet distribution -------------------------

def ggx_d(alpha, wm):
    tan2 = tan2_theta(wm)
    cos4 = cos2_theta(wm) * cos2_theta(wm)
    cpa = cos_phi(wm) / alpha
    spa = sin_phi(wm) / alpha
    e = tan2 * (cpa * cpa + spa * spa)
    e1 = 1.0 + e
    d = 1.0 / torch.clamp_min(Pi * alpha * alpha * cos4 * (e1 * e1), EPS)
    return torch.where(cos4 < 1e-6, 0.0, d)


def ggx_lambda(alpha, w):
    tan2 = tan2_theta(w)
    ca = cos_phi(w) * alpha
    sa = sin_phi(w) * alpha
    alpha2 = ca * ca + sa * sa
    return (fm.sqrt(1.0 + alpha2 * tan2) - 1.0) / 2.0


def ggx_g1(alpha, w):
    return 1.0 / (1.0 + ggx_lambda(alpha, w))


def ggx_g(alpha, wi, wo):
    return 1.0 / (1.0 + ggx_lambda(alpha, wi) + ggx_lambda(alpha, wo))


def ggx_d_g(alpha, wi, wm, wo):
    return ggx_d(alpha, wm) * ggx_g(alpha, wi, wo)


def ggx_d_visible(alpha, w, wm):
    """Visible-normal density D_w(wm)."""
    return (
        ggx_g1(alpha, w)
        / torch.clamp_min(abs_cos_theta(w), EPS)
        * ggx_d(alpha, wm)
        * dot(w, wm).abs()
    )


def ggx_pdf(alpha, w, wm):
    return torch.clamp_min(ggx_d_visible(alpha, w, wm), EPS)


def ggx_sample_wm(alpha, w, u):
    """Sample a visible microfacet normal (Heitz VNDF)."""
    a = alpha[..., None]
    wh = safe_normalize(torch.cat([a * w[..., :2], w[..., 2:3]], -1))
    wh = face_normal(wh)
    z_axis = torch.zeros_like(wh)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(wh)
    x_axis[..., 0] = 1.0
    t1 = torch.where(
        (wh[..., 2] < 0.99999)[..., None], safe_normalize(cross(z_axis, wh)), x_axis
    )
    t2 = cross(wh, t1)
    p = sample_disk_polar(u)
    h = fm.sqrt(torch.clamp_min(1.0 - p[..., 0] * p[..., 0], 0.0))
    py = (1.0 - (1.0 + wh[..., 2]) / 2.0) * h + (1.0 + wh[..., 2]) / 2.0 * p[..., 1]
    p = torch.stack([p[..., 0], py], -1)
    pz = fm.sqrt(torch.clamp_min(1.0 - length_squared(p), 0.0))
    nh = p[..., 0:1] * t1 + p[..., 1:2] * t2 + pz[..., None] * wh
    return safe_normalize(
        torch.cat([a * nh[..., :2], torch.clamp_min(nh[..., 2:3], 1e-6)], -1)
    )
