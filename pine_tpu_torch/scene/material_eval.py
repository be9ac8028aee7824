"""Material -> per-lane BXDF state.  Counterpart of pine_tpu/scene/material_eval.py.

Every scene material's parameter nodes are evaluated densely over the
wavefront at the hits (``ctx``; a constant stays a broadcast, a texture is
a gather on every lane) and selected by the lane's material slot, as
pine_tpu does; Uber's lobe choice reads the lane's sampler dims ``u_a`` and
``u_b``, Subsurface's ``u_a`` against the boundary's Fresnel reflectance
(material.cpp:9-29).  The result is a dict of dense tensors the BXDF module
and the subsurface walk read.
"""
from __future__ import annotations

import torch

from pine_tpu_torch.core.scattering import fr_dielectric
from pine_tpu_torch.core.vecmath import dot
from pine_tpu_torch.scene import materials as M
from pine_tpu_torch.scene.nodes import eval_scalar_node, eval_vec3_node

_BXDF_OF = {
    M.DIFFUSE: M.BX_DIFFUSE,
    M.METAL: M.BX_CONDUCTOR,
    M.GLOSSY: M.BX_DIFF_DIELECTRIC,
    M.GLASS: M.BX_REFR_DIELECTRIC,
}


def eval_bxdf_state(cscene, mat_idx, ctx, wi_world, u_a, u_b, min_roughness, diffused):
    """mat_idx (N,) material slots; ctx dict(p, n, uv) at the hits; u_a, u_b
    (N,) uniforms for Uber's lobe choice; diffused (N,) bool (a diffuse
    bounce happened, so the rough lobes of every material but Uber are
    clamped to min_roughness).  ``wi_world`` (N,3) is the direction back
    along the ray, which Subsurface's Fresnel choice reads."""
    n_l = mat_idx.shape[0]
    dev = mat_idx.device
    tag = torch.zeros(n_l, dtype=torch.int32, device=dev)
    albedo = torch.zeros(n_l, 3, device=dev)
    roughness = torch.zeros(n_l, device=dev)
    ior = torch.full((n_l,), 1.4, device=dev)
    sigma_s = torch.zeros(n_l, 3, device=dev)
    minr = torch.where(diffused, min_roughness, 0.0)
    for slot, mat in enumerate(cscene.materials):
        if mat["tag"] == M.EMISSIVE:
            continue
        m = mat_idx == slot
        albedo = torch.where(m[:, None], eval_vec3_node(mat["albedo"], ctx, n_l), albedo)
        if mat["tag"] == M.UBER:
            r = eval_scalar_node(mat["roughness"], ctx, n_l)
            pick_metal = u_a < eval_scalar_node(mat["metallic"], ctx, n_l)
            pick_trans = u_b < eval_scalar_node(mat["transmission"], ctx, n_l)
            t = torch.where(pick_metal, M.BX_CONDUCTOR,
                            torch.where(pick_trans, M.BX_REFR_DIELECTRIC, M.BX_DIFF_DIELECTRIC))
            tag = torch.where(m, t.to(torch.int32), tag)
            roughness = torch.where(m, r, roughness)
            ior = torch.where(m, eval_scalar_node(mat["ior"], ctx, n_l), ior)
            continue
        if mat["tag"] == M.SUBSURFACE:
            r = torch.maximum(eval_scalar_node(mat["roughness"], ctx, n_l), minr)
            mat_ior = eval_scalar_node(mat["ior"], ctx, n_l)
            reflect = u_a < fr_dielectric(dot(wi_world, ctx["n"]), mat_ior)
            t = torch.where(reflect, M.BX_REFRACTIVE,
                            torch.where(diffused, M.BX_DIFFUSE, M.BX_BSSRDF))
            tag = torch.where(m, t.to(torch.int32), tag)
            roughness = torch.where(m & reflect, r, roughness)
            ior = torch.where(m, mat_ior, ior)
            sigma_s = torch.where(m[:, None], eval_vec3_node(mat["sigma_s"], ctx, n_l), sigma_s)
            continue
        tag = torch.where(m, _BXDF_OF[mat["tag"]], tag)
        if mat["tag"] != M.DIFFUSE:
            r = torch.maximum(eval_scalar_node(mat["roughness"], ctx, n_l), minr)
            roughness = torch.where(m, r, roughness)
        if mat["tag"] in (M.GLOSSY, M.GLASS):
            ior = torch.where(m, eval_scalar_node(mat["ior"], ctx, n_l), ior)
    return dict(tag=tag, albedo=albedo, roughness=roughness, ior=ior, sigma_s=sigma_s)
