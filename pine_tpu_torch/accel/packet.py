"""Primitive groups and the per-group traversal dispatch.

Counterpart of pine_tpu/accel/packet.py for analytic shapes and meshes:

- ``build_packet_accel`` groups the prims by shape type.  A type with
  DENSE_MAX or fewer prims keeps insertion order ("dense"); a larger one is
  put in SAH leaf order ("bvh", plus LEAF_MAX zero pad rows that never hit)
  and keeps its SAH node arrays, which the BVH walk reads.
  A group that forms a regular 1-D/2-D lattice (script loops) has its rows
  snapped to the affine model, so every traversal path sees the same
  geometry, and keeps the model, which the lattice traversal reads.  The triangles of all meshes form one more group, with their
  shading attributes in entity order.
- Each lazy instancing becomes an instanced group (``_instanced_group``):
  the mesh's triangles once, in the mesh's own SAH leaf order, and a second
  SAH tree over the instances' world boxes, whose order the per-instance
  transforms and geometry ids follow.
- ``packet_intersect`` / ``packet_any_hit`` run each regular group through
  accel/dense_traverse.group_query, by the group's route (one of the six
  of that module: "dense", "scdense", "lattice", "grid", "sctree", "bvh";
  pine_tpu's defaults, or as ``CompiledScene.small_kernel`` and
  ``mesh_kernel`` force them), and then each instanced group through
  accel/inst_traverse.inst_query, the kernel routes on CUDA tensors.

Entity ids concatenate the groups' rows: a group-local row plus the group's
``base`` is the entity, and ``ent_gidx`` maps an entity to its scene
geometry.  Hits on instanced groups carry virtual ids
``vbase + instance * stride + tri`` (``tri`` in the mesh's leaf order;
``stride = T + LEAF_MAX``, ``vbase`` after the regular entities and their
LEAF_MAX pad rows), so the memory stays O(mesh); ``ent_to_gidx`` and
``instanced_surface_info`` decode them.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.accel.bvh import LEAF_MAX, sah_arrays
from pine_tpu_torch.accel.dense_traverse import BIG, group_query
from pine_tpu_torch.accel.inst_traverse import inst_query
from pine_tpu_torch.scene import shapes as S

DENSE_MAX = 16  # types with <= this many prims keep insertion order
ENT_PARAM_WIDTH = 32  # entity rows, padded to the widest prim


def _detect_lattice(params, lo, hi):
    """Detect a regular 1-D/2-D lattice of identical-shape prims.

    A lattice's rows are affine in the lattice indices:
    rows[i*nj + j] = base + i*dU + j*dV.  Returns None, or the lattice model
    the lattice kernel reads (accel/lattice_traverse.py): ``ni``, ``nj``,
    ``K`` (the candidate window's side), ``base``, ``dU``, ``dV``; the dual
    spatial basis ``gu``, ``gv`` and origin ``u0``, ``v0`` (x.gu - u0 is i at
    the cell centres, likewise j); the margins ``r_u``, ``r_v`` (a prim's
    half-extent in cell units) and the window capacities ``cap_u``,
    ``cap_v``; and ``snapped``, the rows recomputed from the model (float
    accumulation in script loops drifts ~1e-7 from it).
    """
    n = len(params)
    if n < 4:
        return None
    P = np.asarray(params, np.float64)
    C = np.asarray((lo + hi) * 0.5, np.float64)  # prim AABB centers
    ptp = P.max(0) - P.min(0)
    atol = ptp * 1e-5 + 1e-6
    dV = P[1] - P[0]
    fit1 = np.abs(P - (P[0] + np.arange(n)[:, None] * dV))
    bad = (fit1 > atol).any(1)
    nj = int(np.argmax(bad)) if bad.any() else n
    if nj < 2:
        return None
    if nj == n:
        ni = 1
        dU = np.zeros_like(dV)
    else:
        if n % nj:
            return None
        ni = n // nj
        dU = P[nj] - P[0]
        ii, jj = np.divmod(np.arange(n), nj)
        fit2 = np.abs(P - (P[0] + ii[:, None] * dU + jj[:, None] * dV))
        if (fit2 > atol).any():
            return None
    ii, jj = np.divmod(np.arange(n), nj)
    cV = C[1] - C[0]
    cU = C[nj] - C[0] if ni > 1 else np.zeros(3)
    cfit = np.abs(C - (C[0] + ii[:, None] * cU + jj[:, None] * cV))
    ctol = (C.max(0) - C.min(0)) * 1e-5 + 1e-6
    if (cfit > ctol).any():
        return None
    if ni > 1 and nj > 1:
        G = np.array([[cU @ cU, cU @ cV], [cV @ cU, cV @ cV]])
        if abs(np.linalg.det(G)) < 1e-12 * max(G[0, 0] * G[1, 1], 1e-30):
            return None  # degenerate (collinear axes)
        Ginv = np.linalg.inv(G)
        gu = Ginv[0, 0] * cU + Ginv[0, 1] * cV
        gv = Ginv[1, 0] * cU + Ginv[1, 1] * cV
    elif nj > 1:
        if cV @ cV < 1e-20:
            return None
        gu = np.zeros(3)
        gv = cV / (cV @ cV)
    else:
        return None
    half = np.asarray(hi - lo, np.float64) * 0.5
    r_u = float((half @ np.abs(gu)).max()) + 1e-4 if ni > 1 else 0.49
    r_v = float((half @ np.abs(gv)).max()) + 1e-4
    K = 4
    cap_u = K - 1 - 2 * r_u
    cap_v = K - 1 - 2 * r_v
    if cap_u < 0.45 or cap_v < 0.45:
        return None
    snapped = (P[0] + ii[:, None] * dU + jj[:, None] * dV).astype(np.float32)
    return dict(ni=ni, nj=nj, K=K, base=P[0].astype(np.float32),
                dU=dU.astype(np.float32), dV=dV.astype(np.float32),
                gu=gu.astype(np.float32), gv=gv.astype(np.float32),
                u0=float(C[0] @ gu), v0=float(C[0] @ gv), r_u=float(r_u), r_v=float(r_v),
                cap_u=float(cap_u), cap_v=float(cap_v), snapped=snapped)


def _mesh_triangles(meshes):
    """All meshes' triangles in scene order -> (rows (F,12) [v0, v1, v2, gn],
    gidx, lo, hi, n_attr (F,9), t_attr (F,6), has_n, has_t)."""
    parts = []
    for mesh, gidx in meshes:
        v = mesh.vertices
        f = mesh.indices.astype(np.int64)
        v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        gn = np.cross(v0 - v1, v0 - v2)
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        F = len(f)
        has_n, has_t = mesh.normals is not None, mesh.texcoords is not None
        vn, vt = mesh.normals, mesh.texcoords
        parts.append((
            np.concatenate([v0, v1, v2, gn], axis=1).astype(np.float32),
            np.full(F, gidx, np.int32),
            np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
            np.concatenate([vn[f[:, k]] for k in range(3)], axis=1) if has_n
            else np.zeros((F, 9), np.float32),
            np.concatenate([vt[f[:, k]] for k in range(3)], axis=1) if has_t
            else np.zeros((F, 6), np.float32),
            np.full(F, has_n), np.full(F, has_t),
        ))
    rows, gidx, lo, hi, n_attr, t_attr, has_n, has_t = (np.concatenate(x) for x in zip(*parts))
    return (rows, gidx, lo.astype(np.float32), hi.astype(np.float32),
            n_attr.astype(np.float32), t_attr.astype(np.float32), has_n, has_t)


def box_corners(lo, hi):
    """The 8 corners (8, 3) float32 of the box [lo, hi]."""
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])], np.float32)


def instancing_record(mesh, transforms, gidx):
    """The record ``_instanced_group`` takes, from 4x4 local->world
    transforms: their 3x4 parts ``m`` and those of their inverses ``minv``
    (float32, one row of 12 per instance) and the instances' geometry ids."""
    ms = np.asarray(transforms, np.float32).reshape(-1, 4, 4)
    return dict(mesh=mesh, m=ms[:, :3, :4].reshape(-1, 12),
                minv=np.linalg.inv(ms).astype(np.float32)[:, :3, :4].reshape(-1, 12),
                gidx=np.asarray(gidx, np.int32))


def _instanced_group(rec, vbase):
    """One lazy instanced group from an instancing record
    (``instancing_record``): the mesh's triangle
    rows and shading attributes in its SAH leaf order with LEAF_MAX pad rows;
    the instances' world boxes (the mesh box's corners through each ``m``)
    and the SAH tree over them (``ic_*``, as ``sah_arrays`` returns it);
    ``iboxes``, ``minv``, ``m``, ``gidx`` in that tree's instance order, the
    last three with LEAF_MAX zero pad rows."""
    rows, _, lo, hi, n_attr, t_attr, has_n, has_t = _mesh_triangles([(rec["mesh"], 0)])
    order = sah_arrays(lo, hi)[0]
    T = len(rows)

    def pad(x, idx):
        return np.concatenate([x[idx], np.zeros((LEAF_MAX,) + x.shape[1:], x.dtype)])

    corners = box_corners(lo.min(0), hi.max(0))
    m_l2w = np.asarray(rec["m"], np.float32).reshape(-1, 3, 4)
    n_inst = len(m_l2w)
    wc = np.einsum("iab,cb->ica", m_l2w[:, :, :3], corners) + m_l2w[:, None, :, 3]
    ilo, ihi = wc.min(axis=1), wc.max(axis=1)
    iorder, ic_lower, ic_upper, ic_node, ic_start, ic_count = sah_arrays(ilo, ihi)
    return dict(
        kind="instanced", tid=S.TRIANGLE, vbase=vbase, stride=T + LEAF_MAX, n_tris=T,
        n_inst=n_inst, rows=pad(rows, order), prim_aabbs=np.concatenate([lo, hi], 1)[order],
        tri_n=pad(n_attr, order), tri_t=pad(t_attr, order), tri_has_n=pad(has_n, order),
        tri_has_t=pad(has_t, order),
        ic_lower=ic_lower, ic_upper=ic_upper, ic_node=ic_node, ic_start=ic_start,
        ic_count=ic_count, iboxes=np.concatenate([ilo, ihi], 1)[iorder].astype(np.float32),
        minv=pad(np.asarray(rec["minv"], np.float32).reshape(n_inst, 12), iorder),
        m=pad(m_l2w.reshape(n_inst, 12), iorder),
        gidx=pad(np.asarray(rec["gidx"], np.int32), iorder),
    )


def build_packet_accel(analytic_prims, meshes=(), instanced=()):
    """analytic_prims: list of (type_id, params (k,), gidx, (lo, hi));
    meshes: list of (Mesh, gidx); instanced: list of instancing records
    (``instancing_record``).

    -> host accel dict: ``groups`` (each: tid, kind, base, rows, prim_aabbs,
    and ``lattice``: None, or ``_detect_lattice``'s model without ``snapped``
    and with ``slot_of_k``, the inverse of the SAH order; a "bvh" group also
    its SAH tree ``c_lower``, ``c_upper``, ``c_node``, ``c_start``,
    ``c_count``), ``inst_groups`` (``_instanced_group``'s dicts) and
    ``ent_gidx``; with meshes also the entity-order tables ``ent_param``
    (E, 32), ``geom_n``, ``tri_n``, ``tri_t``, ``tri_has_n``, ``tri_has_t``
    that mesh shading reads (accel/unified.py).  The triangles of all meshes
    form one group after the analytic ones; it is never lattice-detected.
    None when there are no prims and no instancings."""
    from pine_tpu_torch.accel.dense_traverse import PRIM_TESTS

    by_type = {}
    for tid, prm, gidx, (lo, hi) in analytic_prims:
        by_type.setdefault(tid, []).append((prm, gidx, lo, hi))
    inputs = []
    for tid in sorted(by_type):
        entries = by_type[tid]
        inputs.append((tid, np.stack([e[0] for e in entries]).astype(np.float32),
                       np.asarray([e[1] for e in entries], np.int32),
                       np.stack([e[2] for e in entries]).astype(np.float32),
                       np.stack([e[3] for e in entries]).astype(np.float32), None))
    if meshes:
        rows, gidx, lo, hi, *attrs = _mesh_triangles(meshes)
        inputs.append((S.TRIANGLE, rows, gidx, lo, hi, attrs))

    groups, ent_gidx, ent_param, ent_attrs = [], [], [], []
    base = 0
    for tid, params, gidxs, lo, hi, attrs in inputs:
        n = len(params)
        lattice = None
        if n > DENSE_MAX and tid in PRIM_TESTS and attrs is None:
            lattice = _detect_lattice(params, lo, hi)
            if lattice is not None:
                params = lattice.pop("snapped")
        nodes = {}
        if n <= DENSE_MAX:
            order = np.arange(n)
            rows = params
            kind = "dense"
        else:
            order, *tree = sah_arrays(lo, hi)
            nodes = dict(zip(("c_lower", "c_upper", "c_node", "c_start", "c_count"), tree))
            rows = np.concatenate([params[order], np.zeros((LEAF_MAX, params.shape[1]), np.float32)])
            kind = "bvh"
            if lattice is not None:  # lattice index k -> the group's row (SAH slot)
                lattice["slot_of_k"] = np.empty(n, np.int32)
                lattice["slot_of_k"][order] = np.arange(n, dtype=np.int32)
        groups.append(dict(
            tid=tid, kind=kind, base=base, rows=rows,
            prim_aabbs=np.concatenate([lo, hi], axis=1)[order],
            lattice=lattice, **nodes,
        ))
        ent_gidx.append(gidxs[order])
        padded = np.zeros((n, ENT_PARAM_WIDTH), np.float32)
        padded[:, :params.shape[1]] = params[order]
        ent_param.append(padded)
        ent_attrs.append([a[order] for a in attrs] if attrs is not None else
                         [np.zeros((n, 9), np.float32), np.zeros((n, 6), np.float32),
                          np.zeros(n, bool), np.zeros(n, bool)])
        base += n
    inst_groups = []
    vbase = base + LEAF_MAX  # virtual ids start clear of the entity pad rows
    for rec in instanced:
        inst_groups.append(_instanced_group(rec, vbase))
        vbase += inst_groups[-1]["n_inst"] * inst_groups[-1]["stride"]
    if base == 0 and not inst_groups:
        return None
    ent_gidx.append(np.zeros(LEAF_MAX, np.int32))
    accel = dict(groups=groups, inst_groups=inst_groups, ent_gidx=np.concatenate(ent_gidx))
    if meshes:
        ep = np.concatenate(ent_param + [np.zeros((LEAF_MAX, ENT_PARAM_WIDTH), np.float32)])
        is_tri = np.concatenate([np.full(len(g["prim_aabbs"]), g["tid"] == S.TRIANGLE)
                                 for g in groups] + [np.zeros(LEAF_MAX, bool)])
        accel["ent_param"] = ep
        accel["geom_n"] = np.where(is_tri[:, None], ep[:, 9:12], 0.0).astype(np.float32)
        for k, parts in zip(("tri_n", "tri_t", "tri_has_n", "tri_has_t"), zip(*ent_attrs)):
            pad = np.zeros((LEAF_MAX,) + parts[0].shape[1:], parts[0].dtype)
            accel[k] = np.concatenate(list(parts) + [pad])
    return accel


def _inst_lanes(ig, ent):
    """(lanes whose entity is a virtual id of instanced group ``ig``, their
    instance, their triangle row)."""
    span = ig["n_inst"] * ig["stride"]
    is_i = (ent >= ig["vbase"]) & (ent < ig["vbase"] + span)
    rel = (ent.long() - ig["vbase"]).clamp(0, span - 1)
    return is_i, rel // ig["stride"], (rel % ig["stride"]).clamp(0, ig["n_tris"] - 1)


def ent_to_gidx(accel, ent):
    """Entity ids (virtual ids of instanced groups too) -> scene geometry ids."""
    g = accel["ent_gidx"][ent.clamp(0, accel["ent_gidx"].shape[0] - 1).long()]
    for ig in accel.get("inst_groups", ()):
        is_i, inst, _ = _inst_lanes(ig, ent)
        g = torch.where(is_i, ig["gidx"][inst], g)
    return g


def instanced_surface_info(accel, ent, p, out_p, out_n, out_uv):
    """Overlay the shading of instanced hits: the local triangle through the
    instance's transform, barycentrics at ``p`` in world space, normals
    through the transpose of ``minv`` (the inverse transpose of ``m``)."""
    for ig in accel.get("inst_groups", ()):
        is_i, inst, tri = _inst_lanes(ig, ent)
        m = ig["m"][inst].reshape(-1, 3, 4)  # local -> world
        mi = ig["minv"][inst].reshape(-1, 3, 4)  # world -> local
        rows = ig["rows"][tri]
        v0, v1, v2 = (m[:, :, 0] * rows[:, k:k + 1] + m[:, :, 1] * rows[:, k + 1:k + 2]
                      + m[:, :, 2] * rows[:, k + 2:k + 3] + m[:, :, 3] for k in (0, 3, 6))
        e1, e2, dp = v1 - v0, v2 - v0, p - v0
        d11, d12, d22 = (e1 * e1).sum(-1), (e1 * e2).sum(-1), (e2 * e2).sum(-1)
        dp1, dp2 = (dp * e1).sum(-1), (dp * e2).sum(-1)
        det = torch.clamp_min(d11 * d22 - d12 * d12, 1e-20)
        u = torch.clamp((d22 * dp1 - d12 * dp2) / det, 0.0, 1.0)
        v = torch.clamp((d11 * dp2 - d12 * dp1) / det, 0.0, 1.0)
        w = torch.clamp(1.0 - u - v, 0.0, 1.0)

        def to_world_n(nl):
            nw = mi[:, 0, :3] * nl[:, 0:1] + mi[:, 1, :3] * nl[:, 1:2] + mi[:, 2, :3] * nl[:, 2:3]
            return nw / torch.clamp_min(torch.linalg.vector_norm(nw, dim=-1, keepdim=True), 1e-20)

        n = to_world_n(rows[:, 9:12])
        na = ig["tri_n"][tri]
        nl = w[:, None] * na[:, 0:3] + u[:, None] * na[:, 3:6] + v[:, None] * na[:, 6:9]
        ln = torch.linalg.vector_norm(nl, dim=-1, keepdim=True)
        smooth = ig["tri_has_n"][tri][:, None] & (ln > 1e-8)
        n = torch.where(smooth, to_world_n(nl / torch.clamp_min(ln, 1e-8)), n)
        ta = ig["tri_t"][tri]
        uv_i = w[:, None] * ta[:, 0:2] + u[:, None] * ta[:, 2:4] + v[:, None] * ta[:, 4:6]
        uv = torch.where(ig["tri_has_t"][tri][:, None], uv_i, torch.stack([u, v], -1))
        out_n = torch.where(is_i[:, None], n, out_n)
        out_uv = torch.where(is_i[:, None], uv, out_uv)
    return out_p, out_n, out_uv


def packet_intersect(accel, ro, rd, tmin, tmax):
    """Closest hit over all groups -> (t, ent), t = BIG on a miss.  The
    regular groups run first, then the instanced groups, which return full
    virtual ids."""
    best_t = tmax
    best_e = torch.full_like(tmax, -1, dtype=torch.int32)
    for g in accel["groups"]:
        t_new, e_loc = group_query(g, ro, rd, tmin, best_t, best_t, best_e, any_hit=False)
        best_e = torch.where(t_new < best_t, g["base"] + e_loc, best_e)
        best_t = t_new
    for g in accel.get("inst_groups", ()):
        best_t, best_e = inst_query(g, ro, rd, tmin, best_t, best_t, best_e, any_hit=False)
    return torch.where(best_t < tmax, best_t, BIG), best_e.clamp_min(0)


def packet_any_hit(accel, ro, rd, tmin, tmax):
    """Occlusion query -> (N,) bool."""
    occ = torch.zeros_like(tmax, dtype=torch.int32)
    for g in accel["groups"]:
        _, occ = group_query(g, ro, rd, tmin, tmax, tmax, occ, any_hit=True)
    for g in accel.get("inst_groups", ()):
        _, occ = inst_query(g, ro, rd, tmin, tmax, tmax, occ, any_hit=True)
    return occ != 0
