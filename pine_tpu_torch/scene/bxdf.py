"""Wavefront BXDF evaluation.  Counterpart of pine_tpu/scene/bxdf.py.

Per-lane state is a dict of dense tensors: ``tag`` (N,) int32 (BX_* from
materials.py), ``albedo`` (N,3), ``roughness`` (N,), ``ior`` (N,).  Every
lobe runs for all lanes and results select by tag: diffuse, conductor
(Metal), refractive (Subsurface's rough reflection), refractive dielectric
(Glass), diffusive dielectric (Glossy) and the BSSRDF exit lobe (a cosine
lobe on the far side).  Directions are in the local shading frame.
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core import scattering as sc
from pine_tpu_torch.core.sampling import cosine_weighted_hemisphere
from pine_tpu_torch.core.vecmath import Pi, dot, safe_normalize
from pine_tpu_torch.scene.materials import (
    BX_BSSRDF, BX_CONDUCTOR, BX_DIFF_DIELECTRIC, BX_DIFFUSE, BX_REFR_DIELECTRIC, BX_REFRACTIVE,
)

EPS = 1e-7
DELTA_ALPHA = 1e-4  # alpha = roughness^2 below this counts as a delta lobe
DELTA_ROUGHNESS = 1e-2


def _sel(mask, a, b):
    if a.dim() > mask.dim():
        mask = mask[..., None]
    return torch.where(mask, a, b)


def is_delta(state):
    """GGX lobes with roughness < 1e-2 are delta lobes."""
    tag = state["tag"]
    specularish = (tag == BX_CONDUCTOR) | (tag == BX_REFRACTIVE) | (tag == BX_REFR_DIELECTRIC)
    return specularish & (state["roughness"] < DELTA_ROUGHNESS)


def sample(state, wi, u2, u1, u2b):
    """Sample all lobes, select by tag -> dict(wo, f (N,3), pdf,
    is_delta_sample, valid)."""
    tag = state["tag"]
    albedo = state["albedo"]
    rough = state["roughness"]
    ior = state["ior"]
    alpha = rough * rough
    n_l = wi.shape[0]
    dev = wi.device
    false = torch.zeros(n_l, dtype=torch.bool, device=dev)

    out = dict(wo=torch.zeros(n_l, 3, device=dev), f=torch.zeros(n_l, 3, device=dev),
               pdf=torch.zeros(n_l, device=dev), is_delta_sample=false, valid=false)

    def put(mask, wo, f, pdf, delta, valid):
        for k, v in (("wo", wo), ("f", f), ("pdf", pdf), ("is_delta_sample", delta),
                     ("valid", valid)):
            out[k] = _sel(mask, v, out[k])

    # ---- Diffuse ----
    wo_d = cosine_weighted_hemisphere(u2)
    wo_d = _sel(sc.cos_theta(wi) < 0.0, -wo_d, wo_d)
    pdf_d = sc.abs_cos_theta(wo_d) / Pi
    put(tag == BX_DIFFUSE, wo_d, albedo / Pi, pdf_d, false, pdf_d > 0.0)

    # ---- shared GGX microfacet quantities ----
    alpha_s = torch.clamp_min(alpha, DELTA_ALPHA)
    wm = sc.ggx_sample_wm(alpha_s, wi, u2)
    wo_r = sc.reflect(wi, wm)
    same_hemi = sc.same_hemisphere(wi, wo_r)
    pdf_wm = sc.ggx_pdf(alpha_s, wi, wm) / torch.clamp_min(4 * dot(wi, wm).abs(), EPS)
    dg_over = sc.ggx_d_g(alpha_s, wo_r, wm, wi) / torch.clamp_min(
        (4 * sc.cos_theta(wi) * sc.cos_theta(wo_r)).abs(), EPS
    )
    is_smooth = alpha < DELTA_ALPHA

    # ---- Conductor ----
    wo_mirror = sc.reflect_z(wi)
    fr_mirror = sc.fr_schlick(albedo, sc.abs_cos_theta(wo_mirror))
    f_c_smooth = fr_mirror / torch.clamp_min(sc.abs_cos_theta(wo_mirror), EPS)[..., None]
    fr_c = sc.fr_schlick(albedo, dot(wi, wm).abs())
    wo_c = _sel(is_smooth, wo_mirror, wo_r)
    f_c = _sel(is_smooth, f_c_smooth, fr_c * dg_over[..., None])
    pdf_c = torch.where(is_smooth, 1.0, pdf_wm)
    put(tag == BX_CONDUCTOR, wo_c, f_c, pdf_c, is_smooth, is_smooth | same_hemi)

    # ---- Refractive: a rough mirror with albedo (bxdf.cpp:96-120) ----
    wo_rr = _sel(is_smooth, wo_mirror, wo_r)
    f_r = _sel(is_smooth, albedo, albedo * dg_over[..., None])
    pdf_r = torch.where(is_smooth, sc.abs_cos_theta(wo_mirror), pdf_wm)
    put(tag == BX_REFRACTIVE, wo_rr, f_r, pdf_r, is_smooth, is_smooth | same_hemi)

    # ---- RefractiveDielectric (Glass) ----
    fr_diel = sc.fr_dielectric(sc.cos_theta(wi), ior)
    choose_reflect = u1 < fr_diel
    z_up = torch.zeros_like(wi)
    z_up[:, 2] = 1.0
    ok_t, wt_s, _ = sc.refract(wi, z_up, ior)
    f_g_sr = albedo * (fr_diel / torch.clamp_min(sc.abs_cos_theta(wo_mirror), EPS))[..., None]
    f_g_st = albedo * ((1.0 - fr_diel) / torch.clamp_min(sc.abs_cos_theta(wt_s), EPS))[..., None]
    # rough case: guard the same denominator in f and pdf so the ratio stays
    # bounded near the total-internal-reflection boundary
    ok_tm, wt_m, eta_m = sc.refract(wi, wm, ior)
    den = dot(wt_m, wm) + dot(wi, wm) / eta_m
    denom_s = torch.clamp_min(den * den, 1e-6)
    cos_prod = torch.clamp_min((sc.cos_theta(wi) * sc.cos_theta(wt_m)).abs(), 1e-4)
    pdf_gt = (1.0 - fr_diel) * sc.ggx_pdf(alpha_s, wi, wm) * dot(wt_m, wm).abs() / denom_s
    f_gt = albedo * (
        (1.0 - fr_diel)
        * sc.ggx_d(alpha_s, wm)
        * sc.ggx_g(alpha_s, wi, wt_m)
        * (dot(wt_m, wm) * dot(wi, wm)).abs()
        / (denom_s * cos_prod)
    )[..., None]
    wo_g = _sel(choose_reflect, _sel(is_smooth, wo_mirror, wo_r), _sel(is_smooth, wt_s, wt_m))
    f_g = _sel(
        choose_reflect,
        _sel(is_smooth, f_g_sr, albedo * (fr_diel * dg_over)[..., None]),
        _sel(is_smooth, f_g_st, f_gt),
    )
    pdf_g = torch.where(
        choose_reflect,
        torch.where(is_smooth, fr_diel, fr_diel * pdf_wm),
        torch.where(is_smooth, 1.0 - fr_diel, pdf_gt),
    )
    valid_g = torch.where(choose_reflect, is_smooth | same_hemi, torch.where(is_smooth, ok_t, ok_tm))
    put(tag == BX_REFR_DIELECTRIC, wo_g, f_g, pdf_g, is_smooth, valid_g)

    # ---- DiffusiveDielectric (Glossy) ----
    wo_dd_t = cosine_weighted_hemisphere(u2b)
    wo_dd_t = _sel(sc.cos_theta(wi) < 0.0, -wo_dd_t, wo_dd_t)
    f_dd_t = albedo * ((1.0 - fr_diel) / Pi)[..., None]
    pdf_dd_t = (1.0 - fr_diel) * sc.abs_cos_theta(wo_dd_t) / Pi
    wo_dd = _sel(choose_reflect, _sel(is_smooth, wo_mirror, wo_r), wo_dd_t)
    f_dd = _sel(
        choose_reflect,
        _sel(is_smooth, torch.stack([fr_diel] * 3, -1), torch.stack([fr_diel * dg_over] * 3, -1)),
        f_dd_t,
    )
    pdf_dd = torch.where(
        choose_reflect,
        torch.where(is_smooth, fr_diel * sc.abs_cos_theta(wo_mirror), fr_diel * pdf_wm),
        pdf_dd_t,
    )
    valid_dd = torch.where(choose_reflect, is_smooth | same_hemi, pdf_dd_t > 0.0)
    put(tag == BX_DIFF_DIELECTRIC, wo_dd, f_dd, pdf_dd, choose_reflect & is_smooth, valid_dd)

    # ---- BSSRDF exit lobe (bxdf.cpp:355-369): a cosine lobe on the far side ----
    wo_ss = cosine_weighted_hemisphere(u2b)
    wo_ss = _sel(sc.cos_theta(wi) > 0.0, -wo_ss, wo_ss)
    pdf_ss = sc.abs_cos_theta(wo_ss) / Pi
    put(tag == BX_BSSRDF, wo_ss, albedo / Pi, pdf_ss, false, pdf_ss > 0.0)

    out["valid"] = out["valid"] & (out["pdf"] > 0.0)
    return out


def f_and_pdf(state, wi, wo):
    """f and pdf for a given wo (NEE MIS); delta lobes give 0."""
    tag = state["tag"]
    albedo = state["albedo"]
    rough = state["roughness"]
    ior = state["ior"]
    alpha = torch.clamp_min(rough * rough, DELTA_ALPHA)
    n_l = wi.shape[0]

    same = sc.same_hemisphere(wi, wo)
    wm = safe_normalize(wi + wo)
    wm_f = sc.face_normal(wm)
    dg = sc.ggx_d_g(alpha, wo, wm, wi)
    denom4 = torch.clamp_min(4 * sc.abs_cos_theta(wo) * sc.abs_cos_theta(wi), EPS)
    pdf_wm = sc.ggx_pdf(alpha, wi, wm_f) / torch.clamp_min(4 * dot(wi, wm_f).abs(), EPS)
    wm_ok = (dot(wm_f, wo) * sc.cos_theta(wo) > 0.0) & (dot(wm_f, wi) * sc.cos_theta(wi) > 0.0)

    out_f = torch.zeros(n_l, 3, device=wi.device)
    out_pdf = torch.zeros(n_l, device=wi.device)

    def put(mask, f, pdf):
        nonlocal out_f, out_pdf
        out_f = _sel(mask, f, out_f)
        out_pdf = torch.where(mask, pdf, out_pdf)

    put((tag == BX_DIFFUSE) & same, albedo / Pi, sc.abs_cos_theta(wo) / Pi)

    fr_c = sc.fr_schlick(albedo, dot(wi, wm).abs())
    put((tag == BX_CONDUCTOR) & same, fr_c * (dg / denom4)[..., None], pdf_wm)

    # Refractive: the reflection
    put((tag == BX_REFRACTIVE) & same & wm_ok, albedo * (dg / denom4)[..., None], pdf_wm)

    # RefractiveDielectric: the reflection part (NEE light paths reflect)
    fr_diel = sc.fr_dielectric(dot(wi, wm_f), ior)
    put((tag == BX_REFR_DIELECTRIC) & same & wm_ok,
        albedo * (fr_diel * dg / denom4)[..., None], fr_diel * pdf_wm)

    # DiffusiveDielectric: diffuse + specular mix
    alpha_raw = rough * rough
    diffused = albedo * ((1.0 - fr_diel) / Pi)[..., None]
    spec = (fr_diel * dg / denom4)[..., None]
    f_dd = torch.where((alpha_raw < DELTA_ALPHA)[..., None], diffused, diffused + spec)
    pt = (1.0 - fr_diel) * sc.abs_cos_theta(wo) / Pi
    pr = fr_diel * pdf_wm
    pdf_dd = torch.where(alpha_raw < DELTA_ALPHA, pt, pt + pr)
    put((tag == BX_DIFF_DIELECTRIC) & same & wm_ok, f_dd, pdf_dd)

    put(tag == BX_BSSRDF, albedo / Pi, sc.abs_cos_theta(wo) / Pi)

    return out_f, out_pdf
