"""Coefficient tables of the MXU sweeps: each supported prim test factored
into per-pair values ``F @ W``, built on the host in float64, stored float32.

The port's own copy of the numpy parts of pine_tpu/accel/mxu_sweep.py
(``MXU_M``, ``supports``, ``_w_cols``, ``_lin``, ``_build_w``,
``build_tiled_tables``, ``build_mesh_tables``), without JAX.  A ray's
feature row is ``F = [dx, dy, dz, ox, oy, oz, 1, 0]``; a prim's value ``v``
is the dot of F with one column of W.  Identities fold every per-prim
constant into W (the cone's aperture into a scaled axis, the triangle into
its plane and dual edge basis, the quadrics' ``|p|^2 - r^2`` into the
origin's constant), so the test left per pair is a short epilogue
(accel/mxu_sweep.pair_t_vals, csrc/mxu_epilogue.cuh).  Types whose tests
are slab-based (AABB, OBB, cylinder) have no table.

Three layouts of one table:

- ``build_w``: value-major ``(8, m*C)``, value ``v`` of prim ``e`` in
  column ``v*C + e`` (the flat "mxu" route);
- ``build_tiled_tables``: tile-major, 128-prim tiles each holding its ``m``
  value blocks side by side, ``(8, n_tiles*m*128)``, zero columns past the
  last prim (the fused sweep, csrc/mxu_sweep.cu);
- ``build_mesh_tables``: supercell-major ``(n_super*8, m*128)``, row block
  ``[si*8, si*8+8)`` holding supercell ``si``'s value-major strip; prims past
  the last copy prim 0's columns (the MXU leaf forms of the grid and
  instanced kernels).
"""
from __future__ import annotations

import numpy as np

from pine_tpu_torch.scene import shapes as S

RAY_FEATS = 8  # [dx, dy, dz, ox, oy, oz, 1, 0]
C_TILE = 128  # prims per tile of the fused sweep, and per supercell

# pair values per prim type (the columns of W per prim)
MXU_M = {
    S.SPHERE: 2,
    S.RECT: 6,
    S.DISK: 4,
    S.PLANE: 2,
    S.TRIANGLE: 6,
    S.CONE: 5,
}


def supports(tid: int) -> bool:
    return tid in MXU_M


def _w_cols(vals):
    """Stack per-value (8, C) blocks into W (8, m*C)."""
    return np.concatenate(vals, axis=1).astype(np.float32)


def _lin(d_coef, o_coef, const):
    """One value's column block: value = d.d_coef + o.o_coef + const."""
    w = np.zeros((RAY_FEATS, const.shape[0]), np.float64)
    w[0:3] = d_coef.T
    w[3:6] = o_coef.T
    w[6] = const
    return w


def build_w(tid, rows):
    """Value-major (8, m*C) float32 table of the (C, width) prim rows,
    computed in float64 (mxu_sweep._build_w)."""
    rows = np.asarray(rows, np.float64)
    C = rows.shape[0]
    z3 = np.zeros((C, 3))
    z1 = np.zeros(C)
    if tid == S.CONE:
        # rows: [apex(3), n(3), A2, A, S, r, h, 0]
        apex, n, A2, h = rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 10]
        sa = np.sqrt(np.maximum(A2, 0.0))
        n_s = n * sa[:, None]  # the axis scaled by sqrt(A2)
        return _w_cols([
            _lin(n_s, z3, z1),                                   # dn'
            _lin(z3, n_s, -(apex * n_s).sum(1)),                 # on'
            _lin(apex, z3, z1),                                  # pd = p.d
            _lin(z3, -2.0 * apex, (apex * apex).sum(1)),         # op
            _lin(z3, z3, h * sa),                                # h'
        ])
    if tid == S.SPHERE:
        # rows: [c(3), r]
        c, r = rows[:, 0:3], rows[:, 3]
        return _w_cols([
            _lin(c, z3, z1),                                     # cd = c.d
            _lin(z3, -2.0 * c, (c * c).sum(1) - r * r),          # op, -r^2 included
        ])
    if tid == S.RECT:
        # rows: [p(3), ex_hat(3), ey_hat(3), n(3), lx, ly, flip]
        p, n = rows[:, 0:3], rows[:, 9:12]
        exp = rows[:, 3:6] / np.maximum(rows[:, 12:13], 1e-20)   # ex_hat / lx
        eyp = rows[:, 6:9] / np.maximum(rows[:, 13:14], 1e-20)
        return _w_cols([
            _lin(z3, -n, (p * n).sum(1)),                        # tnum = p.n - o.n
            _lin(n, z3, z1),                                     # dn
            _lin(z3, exp, -(p * exp).sum(1)),                    # oex
            _lin(exp, z3, z1),                                   # dex
            _lin(z3, eyp, -(p * eyp).sum(1)),                    # oey
            _lin(eyp, z3, z1),                                   # dey
        ])
    if tid == S.DISK:
        # rows: [p(3), n(3), u(3), v(3), r]
        p, n, r = rows[:, 0:3], rows[:, 3:6], rows[:, 12]
        return _w_cols([
            _lin(z3, -n, (p * n).sum(1)),                        # tnum
            _lin(n, z3, z1),                                     # dn
            _lin(p, z3, z1),                                     # pd
            _lin(z3, -2.0 * p, (p * p).sum(1) - r * r),          # op, -r^2 included
        ])
    if tid == S.PLANE:
        p, n = rows[:, 0:3], rows[:, 3:6]
        return _w_cols([
            _lin(z3, -n, (p * n).sum(1)),                        # tnum
            _lin(n, z3, z1),                                     # dn
        ])
    if tid == S.TRIANGLE:
        # rows: [v0(3), v1(3), v2(3), n(3)]
        v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        e1, e2 = v1 - v0, v2 - v0
        ng = np.cross(e1, e2)
        ng2 = (ng * ng).sum(1)
        ok = ng2 > 1e-30
        inv = np.where(ok, 1.0 / np.maximum(ng2, 1e-30), 0.0)
        # a degenerate triangle gets s1 = s2 = 0 and ng = 0: dng == 0, a miss
        ngz = np.where(ok[:, None], ng, 0.0)
        s1 = np.cross(e2, ng) * inv[:, None]
        s2 = np.cross(ng, e1) * inv[:, None]
        return _w_cols([
            _lin(ngz, z3, z1),                                   # dng
            _lin(z3, -ngz, (v0 * ngz).sum(1)),                   # tnum
            _lin(z3, s1, -(v0 * s1).sum(1)),                     # os1
            _lin(s1, z3, z1),                                    # ds1
            _lin(z3, s2, -(v0 * s2).sum(1)),                     # os2
            _lin(s2, z3, z1),                                    # ds2
        ])
    raise ValueError(f"no coefficient table for prim type {tid}")


def build_tiled_tables(tid, rows):
    """Tile-major table of the fused sweep -> dict(W (8, n_tiles*m*128)
    float32, m, C, n_tiles): tile ``ct``'s value ``v`` block is columns
    ``[(ct*m + v)*128, +128)``, zero past the last prim."""
    m = MXU_M[tid]
    W = build_w(tid, rows)
    C = W.shape[1] // m
    n_tiles = (C + C_TILE - 1) // C_TILE
    Wt = np.zeros((RAY_FEATS, n_tiles * m * C_TILE), np.float32)
    for ct in range(n_tiles):
        for v in range(m):
            src = W[:, v * C + ct * C_TILE: v * C + min((ct + 1) * C_TILE, C)]
            dst0 = (ct * m + v) * C_TILE
            Wt[:, dst0:dst0 + src.shape[1]] = src
    return dict(W=Wt, m=m, C=C, n_tiles=n_tiles)


def build_mesh_tables(tid, rows, e_pad, super_sz=C_TILE):
    """Supercell-major table of the (n_prims, width) prim rows, in the
    group's leaf order -> (e_pad/super_sz*8, m*super_sz) float32: row block
    ``[si*8, si*8+8)`` is supercell ``si``'s (8, m*super_sz) strip, value-major;
    prims ``n_prims .. e_pad-1`` copy prim 0's columns (the kernels mask them
    by index).  ``rows`` holds no builder pad rows."""
    m = MXU_M[tid]
    W = build_w(tid, rows)
    C = W.shape[1] // m
    n_super = e_pad // super_sz
    Wp = np.empty((RAY_FEATS, m * e_pad), np.float32)
    for v in range(m):
        Wp[:, v * e_pad: v * e_pad + C] = W[:, v * C:(v + 1) * C]
        Wp[:, v * e_pad + C: (v + 1) * e_pad] = W[:, v * C: v * C + 1]
    # (8, m, n_super, S) -> (n_super, 8, m, S) -> (n_super*8, m*S)
    return np.ascontiguousarray(
        Wp.reshape(RAY_FEATS, m, n_super, super_sz).transpose(2, 0, 1, 3)
        .reshape(n_super * RAY_FEATS, m * super_sz))
