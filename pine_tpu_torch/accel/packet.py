"""Primitive groups and the per-group traversal dispatch.

Counterpart of pine_tpu/accel/packet.py for analytic shapes and meshes:

- ``build_packet_accel`` groups the prims by shape type.  A type with
  DENSE_MAX or fewer prims keeps insertion order ("dense"); a larger one is
  put in SAH leaf order ("bvh", plus LEAF_MAX zero pad rows that never hit).
  A group that forms a regular 1-D/2-D lattice (script loops) has its rows
  snapped to the affine model, so every traversal path sees the same
  geometry.  The triangles of all meshes form one more group, with their
  shading attributes in entity order.
- ``packet_intersect`` / ``packet_any_hit`` run each group through
  accel/dense_traverse.group_query, the kernel route on CUDA tensors.

Entity ids concatenate the groups' rows: a group-local row plus the group's
``base`` is the entity, and ``ent_gidx`` maps an entity to its scene
geometry.
"""
from __future__ import annotations

import numpy as np
import torch

from pine_tpu_torch.accel.bvh import LEAF_MAX, sah_arrays
from pine_tpu_torch.accel.dense_traverse import BIG, group_query
from pine_tpu_torch.scene import shapes as S

DENSE_MAX = 16  # types with <= this many prims keep insertion order
ENT_PARAM_WIDTH = 32  # entity rows, padded to the widest prim


def _detect_lattice(params, lo, hi):
    """Detect a regular 1-D/2-D lattice of identical-shape prims.

    A lattice's rows are affine in the lattice indices:
    rows[i*nj + j] = base + i*dU + j*dV.  Returns None, or a dict with the
    affine model, the dual spatial basis, the margins and ``snapped``, the
    rows recomputed from the model (float accumulation in script loops
    drifts ~1e-7 from it).
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
                dU=dU.astype(np.float32), dV=dV.astype(np.float32), snapped=snapped)


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


def build_packet_accel(analytic_prims, meshes=()):
    """analytic_prims: list of (type_id, params (k,), gidx, (lo, hi));
    meshes: list of (Mesh, gidx).

    -> host accel dict: ``groups`` (each: tid, kind, base, rows, prim_aabbs,
    lattice) and ``ent_gidx``; with meshes also the entity-order tables
    ``ent_param`` (E, 32), ``geom_n``, ``tri_n``, ``tri_t``, ``tri_has_n``,
    ``tri_has_t`` that mesh shading reads (accel/unified.py).  The triangles
    of all meshes form one group after the analytic ones; it is never
    lattice-detected.  None when there are no prims."""
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
                params = lattice["snapped"]
        if n <= DENSE_MAX:
            order = np.arange(n)
            rows = params
            kind = "dense"
        else:
            order = sah_arrays(lo, hi)[0]
            rows = np.concatenate([params[order], np.zeros((LEAF_MAX, params.shape[1]), np.float32)])
            kind = "bvh"
        groups.append(dict(
            tid=tid, kind=kind, base=base, rows=rows,
            prim_aabbs=np.concatenate([lo, hi], axis=1)[order],
            lattice=lattice is not None,
        ))
        ent_gidx.append(gidxs[order])
        padded = np.zeros((n, ENT_PARAM_WIDTH), np.float32)
        padded[:, :params.shape[1]] = params[order]
        ent_param.append(padded)
        ent_attrs.append([a[order] for a in attrs] if attrs is not None else
                         [np.zeros((n, 9), np.float32), np.zeros((n, 6), np.float32),
                          np.zeros(n, bool), np.zeros(n, bool)])
        base += n
    if base == 0:
        return None
    ent_gidx.append(np.zeros(LEAF_MAX, np.int32))
    accel = dict(groups=groups, ent_gidx=np.concatenate(ent_gidx))
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


def ent_to_gidx(accel, ent):
    """Entity ids -> scene geometry ids."""
    return accel["ent_gidx"][ent.clamp(0, accel["ent_gidx"].shape[0] - 1).long()]


def packet_intersect(accel, ro, rd, tmin, tmax):
    """Closest hit over all groups -> (t, ent), t = BIG on a miss."""
    best_t = tmax
    best_e = torch.full_like(tmax, -1, dtype=torch.int32)
    for g in accel["groups"]:
        t_new, e_loc = group_query(g, ro, rd, tmin, best_t, best_t, best_e, any_hit=False)
        best_e = torch.where(t_new < best_t, g["base"] + e_loc, best_e)
        best_t = t_new
    return torch.where(best_t < tmax, best_t, BIG), best_e.clamp_min(0)


def packet_any_hit(accel, ro, rd, tmin, tmax):
    """Occlusion query -> (N,) bool."""
    occ = torch.zeros_like(tmax, dtype=torch.int32)
    for g in accel["groups"]:
        _, occ = group_query(g, ro, rd, tmin, tmax, tmax, occ, any_hit=True)
    return occ != 0
