"""The MXU coefficient-table sweeps of one prim group: the flat "mxu" route,
TPU kernel 7 (the fused "mxup" sweep) and the leaf test of the MXU forms of
the grid and instanced kernels.

Counterpart of pine_tpu/accel/mxu_sweep.py: ``group_query`` (here
``mxu_route``), ``_make_fused_kernel`` / ``group_query_fused`` (here
csrc/mxu_sweep.cu through ``mxup_cuda``, plain version ``mxup_plain``) and
``_pair_t_vals`` (here ``pair_t_vals``, and csrc/mxu_epilogue.cuh on the
card).  Every supported prim test is a product of the rays' feature rows
``F = [d, o, 1, 0]`` with the group's coefficient table W
(accel/mxu_tables.py), then an epilogue per (ray, prim) pair.  The contract
is ``dense_traverse.group_query``'s:

- closest-hit: ``(best_t, best_e)``, ``best_e`` the group-local row; the
  lowest t wins, ties go to the lowest row, and the group's best replaces
  the incoming one only when its t is strictly below it;
- any-hit: ``best_e = max(best_e_in, occluded)``, ``best_t`` passes through;
- a lane with ``limit <= tmin`` (closest: limit = best_t; any-hit: tmax)
  passes through bit for bit.

The three sweeps:

- ``mxu_route``: ``torch.matmul(F, W)`` in full FP32 (TF32 refused on the
  card: the counterpart of ``mxu_precision()``'s HIGHEST), then the
  epilogue, ``pine_tpu``'s plain-XLA "mxu" route; rays in chunks of at
  most ``ROUTE_PAIRS`` pair values, which change no result.  On a lane that nothing hits,
  closest-hit returns t = BIG with row 0 (the argmin), as there;
- ``mxup_cuda``: kernel 7 (csrc/mxu_sweep.cu): one ray per thread,
  128-prim tiles of the table's prim-major copy (``mxu_tables.prim_major``,
  the table's ``Wp``) staged in shared memory by bulk asynchronous copies;
- ``mxup_plain``: kernel 7 in plain PyTorch, each pair value the ordered
  sum ``((((((d0*w0 + d1*w1) + d2*w2) + o0*w3) + o1*w4) + o2*w5) + 1*w6)
  + 0*w7`` and ``odr``, ``oor``, ``ddr`` as ``(x0*y0 + x1*y1) + x2*y2``,
  the kernel's order, so that the card, built with -fmad=false, equals it
  bit for bit.  As the TPU kernel, a closest-hit lane that nothing hits
  gets t = BIG with row ``INT_BIG`` when its incoming best lies above BIG.

The matmul form computes ``o.n - p.n`` where the VPU tests compute
``(o - p).n``: results differ from the dense kernel in float ulps.
``PINE_MXU_PRECISION=high`` (the TPU's three-pass bf16 matmul) has no
counterpart: the card's matmul is FP32 here.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel import mxu_tables
from pine_tpu_torch.accel.dense_traverse import BIG, LAUNCHES, _check
from pine_tpu_torch.scene import shapes as S

INT_BIG = 2**30  # the row of a closest-hit lane that no prim improved (mxup)
ROUTE_PAIRS = 1 << 27  # pair values (rays x m*C) per matmul of mxu_route
PLAIN_PAIRS = 1 << 24  # pair values per chunk of mxup_plain
TILE = mxu_tables.C_TILE


# --------------------------------------------------------------------------
# the epilogue: per-pair t from the pair values, BIG on a miss
# --------------------------------------------------------------------------

def pair_t_vals(tid, val, odr, oor, ddr, tmin, limit):
    """t of each (ray, prim) pair from its values ``val(v)`` (broadcastable
    tensors) and the rays' ``odr = o.d``, ``oor = o.o``, ``ddr = d.d``;
    BIG where it misses or lies outside (tmin, limit).  The expression
    order is csrc/mxu_epilogue.cuh's."""
    if tid == S.CONE:
        dn, on, pd, op, hp = (val(v) for v in range(5))
        od = odr - pd
        oo = oor + op
        a = ddr - dn * dn
        b = 2.0 * (od - on * dn)
        c = oo - on * on
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        a_safe = torch.where(a == 0.0, 1e-6, a)
        t0 = (-b - sq) / (2.0 * a_safe)
        t = torch.where(t0 < tmin, t0 + sq / a_safe, t0)
        height = on + t * dn
        ok = (disc > 0.0) & (height < 0.0) & (height >= -hp)
    elif tid == S.SPHERE:
        cd, op = val(0), val(1)
        b = odr - cd
        cc = oor + op
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0 = -b - sq
        t = torch.where(t0 < tmin, -b + sq, t0)
        ok = disc > 0.0
    elif tid == S.RECT:
        tnum, dn, oex, dex, oey, dey = (val(v) for v in range(6))
        t = tnum / torch.where(dn == 0.0, 1e-12, dn)
        u = oex + t * dex
        v = oey + t * dey
        ok = (u.abs() <= 0.5) & (v.abs() <= 0.5)
    elif tid == S.DISK:
        tnum, dn, pd, op = (val(v) for v in range(4))
        t = tnum / torch.where(dn == 0.0, 1e-12, dn)
        # |o + t d - p|^2 - r^2 = (oo' - r^2) + 2 t od' + t^2 d.d
        f = (oor + op) + 2.0 * t * (odr - pd) + t * t * ddr
        ok = f <= 0.0
    elif tid == S.PLANE:
        tnum, dn = val(0), val(1)
        t = tnum / torch.where(dn == 0.0, 1e-12, dn)
        ok = torch.ones_like(t, dtype=torch.bool)
    elif tid == S.TRIANGLE:
        dng, tnum, os1, ds1, os2, ds2 = (val(v) for v in range(6))
        t = tnum / torch.where(dng == 0.0, 1e-12, dng)
        u = os1 + t * ds1
        v = os2 + t * ds2
        ok = (dng != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    else:
        raise ValueError(f"no MXU epilogue for prim type {tid}")
    return torch.where(ok & (t > tmin) & (t < limit), t, BIG)


def features(ro, rd):
    """Feature rows (n, 8) [d, o, 1, 0] and the (n, 1) columns odr, oor, ddr,
    each summed as (x0*y0 + x1*y1) + x2*y2."""
    n = ro.shape[0]
    F = torch.cat([rd, ro, ro.new_ones(n, 1), ro.new_zeros(n, 1)], 1)

    def dot(x, y):
        return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1] + x[:, 2] * y[:, 2])[:, None]

    return F, dot(ro, rd), dot(ro, ro), dot(rd, rd)


def ordered_values(F, W):
    """(n, K) pair values of feature rows F (n, 8) and table columns W (8, K),
    each the ordered sum of its eight products (the kernels' order)."""
    P = F[:, 0:1] * W[0]
    for f in range(1, mxu_tables.RAY_FEATS):
        P = P + F[:, f:f + 1] * W[f]
    return P


# --------------------------------------------------------------------------
# the flat route: torch.matmul + the epilogue
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fp32_matmul(device):
    """On the card, keep torch.matmul in full FP32 (no TF32 rounding of its
    inputs) inside the block, checked, and give the caller's settings back
    after it."""
    if device.type != "cuda":
        yield
        return
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.backends.cuda.matmul.allow_tf32 or \
                torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("mxu_route needs FP32 matmuls; TF32 is still enabled")
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def mxu_route(tid, W, m, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """pine_tpu's "mxu" route (module docstring) with the value-major table
    ``W`` (8, m*C) on the rays' device."""
    C = W.shape[1] // m
    limit = tmax if any_hit else best_t
    step = max(1, ROUTE_PAIRS // max(m * C, 1))
    out_t, out_e = [], []
    for c0 in range(0, ro.shape[0], step):
        sl = slice(c0, c0 + step)
        F, odr, oor, ddr = features(ro[sl], rd[sl])
        with fp32_matmul(ro.device):
            P = torch.matmul(F, W)
        t = pair_t_vals(tid, lambda v: P[:, v * C:(v + 1) * C], odr, oor, ddr,
                        tmin[sl, None], limit[sl, None])
        bt, be = best_t[sl], best_e[sl]
        if any_hit:
            out_t.append(bt)
            out_e.append(torch.maximum(be, (t < BIG).any(1).to(be.dtype)))
            continue
        t_min, e_min = t.min(1)  # the first minimum: the lowest row
        better = t_min < bt
        out_t.append(torch.where(better, t_min, bt))
        out_e.append(torch.where(better, e_min.to(be.dtype), be))
    return torch.cat(out_t), torch.cat(out_e)


def mxu_query(tid, rows, tab, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """``mxu_route`` on the value-major table ``tab`` (``prepare_tables``'s
    ``mxu``) of the group's ``rows``, in the traversal wrappers' form."""
    return mxu_route(tid, tab["W"], tab["m"], ro, rd, tmin, tmax, best_t, best_e, any_hit)


# --------------------------------------------------------------------------
# kernel 7: the plain version
# --------------------------------------------------------------------------

def mxup_plain(tid, rows, tab, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Kernel 7 in plain PyTorch (module docstring), on the tile-major table
    ``tab`` (``prepare_tables``'s ``mxut``) of the group's ``rows``."""
    W, m, C = tab["W"], tab["m"], tab["C"]
    n = ro.shape[0]
    limit = tmax if any_hit else best_t
    F, odr, oor, ddr = features(ro, rd)
    step = max(1, PLAIN_PAIRS // max(m * TILE * tab["n_tiles"], 1))
    out_t, out_e = best_t.clone(), best_e.clone()
    cols = torch.arange(TILE, device=ro.device)
    for c0 in range(0, n, step):
        sl = slice(c0, c0 + step)
        bt_run = torch.full_like(best_t[sl], BIG)
        be_run = torch.full_like(best_e[sl], INT_BIG)
        for ct in range(tab["n_tiles"]):
            width = min(TILE, C - ct * TILE)
            P = ordered_values(F[sl], W[:, ct * m * TILE:(ct + 1) * m * TILE])
            t = pair_t_vals(tid, lambda v: P[:, v * TILE:v * TILE + width], odr[sl], oor[sl],
                            ddr[sl], tmin[sl, None], limit[sl, None])
            t_min = t.min(1).values
            first = torch.where(t == t_min[:, None], cols[:width], TILE).min(1).values
            better = t_min < bt_run  # a later tile wins only on a strictly lower t
            bt_run = torch.where(better, t_min, bt_run)
            be_run = torch.where(better, (ct * TILE + first).to(be_run.dtype), be_run)
        if any_hit:
            out_e[sl] = torch.maximum(best_e[sl], (bt_run < BIG).to(best_e.dtype))
        else:
            win = bt_run < best_t[sl]
            out_t[sl] = torch.where(win, bt_run, best_t[sl])
            out_e[sl] = torch.where(win, be_run, best_e[sl])
    return (best_t, out_e) if any_hit else (out_t, out_e)


# --------------------------------------------------------------------------
# kernel 7: the kernel
# --------------------------------------------------------------------------

def bind(fn):
    """Give a library's ``pine_mxu_sweep`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("mxu_sweep").pine_mxu_sweep)


def mxup_cuda(tid, rows, tab, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/mxu_sweep.cu (kernel 7) on the current stream, on the
    prim-major copy ``Wp`` of the tile-major table ``tab`` of the group's
    ``rows`` (which it does not read)."""
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    m, n_tiles = tab["m"], tab["n_tiles"]
    if m != mxu_tables.MXU_M.get(tid):
        raise ValueError(f"a table of {m} values for prim type {tid}")
    if not 0 < tab["C"] <= n_tiles * TILE:
        raise ValueError(f"a table of {n_tiles} tiles for {tab['C']} prims")
    _check(tab["Wp"], f32, (n_tiles, TILE, m, mxu_tables.RAY_FEATS), dev, "Wp")
    if tab["Wp"].data_ptr() % 16:
        raise ValueError("Wp: the kernel needs a 16-byte-aligned table")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), tab["Wp"].data_ptr(), tab["C"], n_tiles, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(), best_e.data_ptr(),
        out_t.data_ptr(), out_e.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mxu_sweep kernel launch failed: CUDA error {err}")
    LAUNCHES["mxup.any_hit" if any_hit else "mxup.closest"] += 1
    return out_t, out_e


# --------------------------------------------------------------------------
# the leaf of the MXU forms, plain: one supercell's prims against some rays
# --------------------------------------------------------------------------

def mesh_leaf_t(tid, mesh, si, width, o, d, tmin, limit):
    """t (k, width) of the first ``width`` prims of supercell ``si`` from the
    supercell-major table ``mesh`` (``prepare_tables``'s ``mxum``) against k
    rays given as (k, 1) columns ``o``, ``d``, ``tmin``, ``limit``: the MXU
    forms' leaf test (grid_traverse.grid_plain with ``mxu``)."""
    Wm, m = mesh["W"], mesh["m"]
    ro, rd = torch.cat(o, 1), torch.cat(d, 1)
    F, odr, oor, ddr = features(ro, rd)
    P = ordered_values(F, Wm[si * mxu_tables.RAY_FEATS:(si + 1) * mxu_tables.RAY_FEATS])
    return pair_t_vals(tid, lambda v: P[:, v * TILE:v * TILE + width], odr, oor, ddr,
                       tmin, limit)


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def prepare_tables(g, kind):
    """Build and upload the table ``kind`` of group ``g`` if it does not hold
    it yet: "mxu" (value-major, ``g["mxu"]``), "mxut" (tile-major,
    ``g["mxut"]``, with its prim-major copy ``Wp`` for the kernel) or "mxum"
    (supercell-major over the group's prims without its builder pad rows,
    ``g["mxum"]``).  Each is a dict with the table ``W`` on the group's
    device and its counts."""
    if kind in g:
        return g[kind]
    rows = g["rows"].cpu().numpy()
    tid, dev = g["tid"], g["rows"].device
    if kind == "mxu":
        m = mxu_tables.MXU_M[tid]
        tab = dict(W=mxu_tables.build_w(tid, rows), m=m)
    elif kind == "mxut":
        tab = mxu_tables.build_tiled_tables(tid, rows)
        tab["Wp"] = torch.as_tensor(mxu_tables.prim_major(tab["W"], tab["m"]), device=dev)
    else:
        n_prims = len(g["prim_aabbs"])
        e_pad = (n_prims + TILE - 1) // TILE * TILE
        tab = dict(W=mxu_tables.build_mesh_tables(tid, rows[:n_prims], e_pad),
                   m=mxu_tables.MXU_M[tid])
    tab["W"] = torch.as_tensor(np.ascontiguousarray(tab["W"]), device=dev)
    g[kind] = tab
    return tab
