"""Material -> per-lane BXDF state.  Counterpart of pine_tpu/scene/material_eval.py.

Every scene material's parameter nodes are evaluated densely over the
wavefront at the hits (``ctx``; a constant stays a broadcast, a texture is
a gather on every lane) and selected by the lane's material slot, as
pine_tpu does; Uber's lobe choice reads the lane's sampler dims ``u_a`` and
``u_b`` (material.cpp:9-29).  The result is a dict of dense tensors the
BXDF module reads.
"""
from __future__ import annotations

import torch

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
    clamped to min_roughness).  ``wi_world`` is the Subsurface lobe choice's
    input in pine_tpu; the port refuses Subsurface, so it is unused."""
    n_l = mat_idx.shape[0]
    dev = mat_idx.device
    tag = torch.zeros(n_l, dtype=torch.int32, device=dev)
    albedo = torch.zeros(n_l, 3, device=dev)
    roughness = torch.zeros(n_l, device=dev)
    ior = torch.full((n_l,), 1.4, device=dev)
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
        tag = torch.where(m, _BXDF_OF[mat["tag"]], tag)
        if mat["tag"] != M.DIFFUSE:
            r = torch.maximum(eval_scalar_node(mat["roughness"], ctx, n_l), minr)
            roughness = torch.where(m, r, roughness)
        if mat["tag"] in (M.GLOSSY, M.GLASS):
            ior = torch.where(m, eval_scalar_node(mat["ior"], ctx, n_l), ior)
    return dict(tag=tag, albedo=albedo, roughness=roughness, ior=ior)
