"""Mesh shading attributes at a hit.  Counterpart of
pine_tpu/accel/unified.py::unified_surface_info_triangle.

The accel's entity-order tables (accel/packet.build_packet_accel) hold each
triangle's vertices and geometric normal (``ent_param``), its three vertex
normals (``tri_n``) and texcoords (``tri_t``) and whether the mesh had them.
"""
from __future__ import annotations

import torch


def unified_surface_info_triangle(accel, ent, p):
    """Barycentric normal and uv of triangle entities ``ent`` at points ``p``
    -> (p, n, uv).  A vertex normal that interpolates to under 1e-8 falls
    back to the geometric normal.  Ids past the table (virtual ids of
    instanced hits, which instanced_surface_info shades) are clamped."""
    ent = ent.clamp(0, accel["ent_param"].shape[0] - 1).long()
    rows = accel["ent_param"][ent]
    v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    gn = rows[:, 9:12]
    e1 = v1 - v0
    e2 = v2 - v0
    dp = p - v0
    d11 = (e1 * e1).sum(-1)
    d12 = (e1 * e2).sum(-1)
    d22 = (e2 * e2).sum(-1)
    dp1 = (dp * e1).sum(-1)
    dp2 = (dp * e2).sum(-1)
    det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
    u = torch.clamp((d22 * dp1 - d12 * dp2) / det, 0.0, 1.0)
    v = torch.clamp((d11 * dp2 - d12 * dp1) / det, 0.0, 1.0)
    w = torch.clamp(1.0 - u - v, 0.0, 1.0)
    na = accel["tri_n"][ent]
    nrm = w[:, None] * na[:, 0:3] + u[:, None] * na[:, 3:6] + v[:, None] * na[:, 6:9]
    ln = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    smooth = accel["tri_has_n"][ent][:, None] & (ln > 1e-8)
    n = torch.where(smooth, nrm / torch.clamp_min(ln, 1e-8), gn)
    ta = accel["tri_t"][ent]
    uv_i = w[:, None] * ta[:, 0:2] + u[:, None] * ta[:, 2:4] + v[:, None] * ta[:, 4:6]
    uv = torch.where(accel["tri_has_t"][ent][:, None], uv_i, torch.stack([u, v], -1))
    return p, n, uv
