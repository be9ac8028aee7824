"""Dense traversal of one prim group, and the dispatch of every group to its
traversal kernel.

Counterpart of the dense path of pine_tpu/accel/pallas_traverse.py:
``PRIM_TESTS`` (the per-type ray tests on one prim row), ``_group_variant``
(which kernel a group takes, here ``group_variant``) and
``pallas_group_query`` (here ``group_query``), whose contract this keeps:

- closest-hit: ``(best_t, best_e)`` in and out; a prim replaces the running
  best only on a strict ``t < best_t`` (ties keep the lowest row) and
  ``best_e`` is the group-local row;
- any-hit: ``best_e`` in and out is the 0/1 occlusion flag, ``best_t``
  passes through; a lane with ``tmax <= tmin`` never becomes occluded;
- a lane whose ray cannot reach the group's box within its window (closest:
  ``(tmin, best_t)``; any-hit: ``(tmin, tmax)``, empty once occluded) passes
  both through bit for bit.

The routes, each a hand-written CUDA kernel on CUDA tensors (or a raise)
and its plain PyTorch version on CPU tensors, but "mxu":

- "dense": every row of the group (csrc/dense_traverse.cu, ``dense_plain``);
- "scdense": the rows in order, culled by 128-prim supercells and 16-prim
  cells (accel/scdense_traverse.py);
- "lattice": the march over a regular lattice's rows rebuilt by arithmetic
  (accel/lattice_traverse.py);
- "grid": coarse boxes, supercells and 32-prim cells, near-first per
  direction octant (accel/grid_traverse.py);
- "sctree": a SAH tree over the supercells (accel/sctree_traverse.py);
- "bvh": the group's own SAH tree of leaves of up to four prims
  (accel/bvh_traverse.py);
- "mxup": the fused coefficient-table sweep, TPU kernel 7
  (accel/mxu_sweep.py, csrc/mxu_sweep.cu);
- "grid_mxu": the grid traversal with the coefficient-table leaf (the grid
  kernel's MXU form, accel/grid_traverse.py);
- "mxu": ``torch.matmul`` of the rays' features with the coefficient table
  and the epilogue in PyTorch, on either device (pine_tpu's plain-XLA
  route, accel/mxu_sweep.mxu_route): no kernel of the port's own;
- "plain": every prim of the group through the type's closed-form query of
  scene/intersect.py, in PyTorch on either device (``plain_query``): the
  route of a group whose prim type has no ray test in PRIM_TESTS (the
  line), as pine_tpu sends such a group to its XLA packet walk
  (``group_supports_pallas``).  No kernel of any route tests such a type,
  so none can fail over to it, and no TPU kernel is replaced by it.

``group_variant`` picks the route as ``pine_tpu``'s defaults do: a group of
a prim type without a ray test takes "plain", whatever its size and the
settings; groups of 512 or fewer rows take the dense sweep; larger groups that form a lattice
(``packet._detect_lattice``) the lattice march; other groups the grid
traversal, or above GRID_MAX_PRIMS_HBM prims the BVH walk.  Two settings of
``CompiledScene`` force a route, as ``PINE_SMALL_KERNEL`` and
``PINE_MESH_KERNEL`` do for ``pine_tpu``: ``mesh_kernel`` for groups of more
than GRID_MAX_PRIMS prims and at most GRID_MAX_PRIMS_HBM, ``small_kernel``
for the other groups of at most GRID_MAX_PRIMS_HBM prims (a lattice group by
the same rule); groups above GRID_MAX_PRIMS_HBM keep their default.  A
forced "mxu" or "mxup" resolves as ``pallas_group_query`` rewrites it: on a
group of a type with a coefficient table (accel/mxu_tables.supports) of at
most GRID_MAX_PRIMS prims it is that route, on such a group over
GRID_MAX_PRIMS (and at most GRID_MAX_PRIMS_HBM) either value is
"grid_mxu", and a type with no table (AABB, OBB, cylinder) takes the size
default ("dense" up to DENSE_DEFAULT_MAX rows, else "grid").  ``route``
resolves a group's route under the settings, builds and uploads the tables
it needs (once, never per query) and records it as ``g["variant"]``, which
``group_query`` follows.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from pine_tpu_torch.core import profiler
from pine_tpu_torch.scene import shapes as S

BIG = 1e30
DENSE_DEFAULT_MAX = 512  # groups of up to this many rows take the dense kernel
GRID_MAX_PRIMS = 8192  # groups over this many prims are mesh-scale (mesh_kernel)
GRID_MAX_PRIMS_HBM = 2_000_000  # groups over this many prims take the BVH walk
VARIANTS = ("dense", "scdense", "lattice", "grid", "sctree", "bvh", "mxu", "mxup")


class RouteRefused(ValueError):
    """A route the group cannot take (the BVH walk on a group without SAH
    node arrays)."""


# kernel launches, counted where a wrapper launches its CUDA kernel
# (and "plain": the calls of that route on the card, which launch no kernel of
# the port's own)
LAUNCHES = {f"{k}.{form}": 0 for k in ("dense", "scdense", "grid", "sctree", "bvh", "inst",
                                       "lattice", "mxup", "grid_mxu", "inst_mxu", "plain")
            for form in ("closest", "any_hit")}
profiler.launch_counter(LAUNCHES)
PLAIN_CHUNK = 64  # prims a "plain" query tests at once


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# per-type ray tests.  r(c) -> the prim row's column c (a 0-dim tensor);
# o, d: ray components as (N,) tensors.  Return t, BIG on a miss.
# --------------------------------------------------------------------------

def _safe_inv(d):
    return 1.0 / torch.where(d.abs() < 1e-9, torch.where(d < 0, -1e-9, 1e-9), d)


def _finish(t, ok, tmin, tmax):
    return torch.where(ok & (t > tmin) & (t < tmax), t, BIG)


def _test_rect(r, o, d, tmin, tmax):
    px, py, pz = r(0), r(1), r(2)
    exx, exy, exz = r(3), r(4), r(5)
    eyx, eyy, eyz = r(6), r(7), r(8)
    nx, ny, nz = r(9), r(10), r(11)
    lx, ly = r(12), r(13)
    denom = d[0] * nx + d[1] * ny + d[2] * nz
    denom = torch.where(denom == 0.0, 1e-12, denom)
    t = ((px - o[0]) * nx + (py - o[1]) * ny + (pz - o[2]) * nz) / denom
    hx = o[0] + t * d[0] - px
    hy = o[1] + t * d[1] - py
    hz = o[2] + t * d[2] - pz
    u = (hx * exx + hy * exy + hz * exz) / lx
    v = (hx * eyx + hy * eyy + hz * eyz) / ly
    return _finish(t, (u.abs() <= 0.5) & (v.abs() <= 0.5), tmin, tmax)


def _test_sphere(r, o, d, tmin, tmax):
    cx, cy, cz, rad = r(0), r(1), r(2), r(3)
    rx, ry, rz = o[0] - cx, o[1] - cy, o[2] - cz
    b = rx * d[0] + ry * d[1] + rz * d[2]
    cc = rx * rx + ry * ry + rz * rz - rad * rad
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t = torch.where(t0 < tmin, -b + sq, t0)
    return _finish(t, disc > 0.0, tmin, tmax)


def _test_triangle(r, o, d, tmin, tmax):
    v0x, v0y, v0z = r(0), r(1), r(2)
    e1x, e1y, e1z = r(3) - v0x, r(4) - v0y, r(5) - v0z
    e2x, e2y, e2z = r(6) - v0x, r(7) - v0y, r(8) - v0z
    tx, ty, tz = o[0] - v0x, o[1] - v0y, o[2] - v0z
    px = d[1] * e2z - d[2] * e2y
    py = d[2] * e2x - d[0] * e2z
    pz = d[0] * e2y - d[1] * e2x
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    det = px * e1x + py * e1y + pz * e1z
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    t = (qx * e2x + qy * e2y + qz * e2z) * inv
    u = (px * tx + py * ty + pz * tz) * inv
    v = (qx * d[0] + qy * d[1] + qz * d[2]) * inv
    ok = (det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return _finish(t, ok, tmin, tmax)


def _test_cone(r, o, d, tmin, tmax):
    ax, ay, az = r(0), r(1), r(2)
    nx, ny, nz = r(3), r(4), r(5)
    A2, h = r(6), r(10)
    ox, oy, oz = o[0] - ax, o[1] - ay, o[2] - az
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    on = ox * nx + oy * ny + oz * nz
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    od = ox * d[0] + oy * d[1] + oz * d[2]
    oo = ox * ox + oy * oy + oz * oz
    a = -A2 * dn * dn + dd
    b = 2.0 * (-A2 * on * dn + od)
    c = -A2 * on * on + oo
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a == 0.0, 1e-6, a)
    t0 = (-b - sq) / (2.0 * a_safe)
    t = torch.where(t0 < tmin, t0 + sq / a_safe, t0)
    height = on + t * dn
    ok = (disc > 0.0) & (height < 0.0) & (height >= -h)
    return _finish(t, ok, tmin, tmax)


def _slab3(lo, up, o, inv, tmin, tmax):
    t0 = [(lo[a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(up[a] - o[a]) * inv[a] for a in range(3)]
    mn = [torch.minimum(t0[a], t1[a]) for a in range(3)]
    mx = [torch.maximum(t0[a], t1[a]) for a in range(3)]
    near = torch.maximum(torch.maximum(mn[0], mn[1]), torch.maximum(mn[2], tmin))
    far = torch.minimum(torch.minimum(mx[0], mx[1]), torch.minimum(mx[2], tmax))
    return near, far


def _test_aabb(r, o, d, tmin, tmax):
    inv = [_safe_inv(d[a]) for a in range(3)]
    near, far = _slab3((r(0), r(1), r(2)), (r(3), r(4), r(5)), o, inv, tmin, tmax)
    t = torch.where(near > tmin, near, far)
    return _finish(t, near <= far, tmin, tmax)


def _test_obb(r, o, d, tmin, tmax):
    """Local slab, then the world-space t through the hit point."""
    m = [r(6 + i) for i in range(12)]  # world <- local (3x4)
    mi = [r(18 + i) for i in range(12)]  # local <- world
    ol = [mi[4 * k] * o[0] + mi[4 * k + 1] * o[1] + mi[4 * k + 2] * o[2] + mi[4 * k + 3]
          for k in range(3)]
    dl = [mi[4 * k] * d[0] + mi[4 * k + 1] * d[1] + mi[4 * k + 2] * d[2] for k in range(3)]
    dn = torch.sqrt(dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2])
    dn = torch.clamp_min(dn, 1e-20)
    dl = [x / dn for x in dl]
    inv = [_safe_inv(x) for x in dl]
    zero = torch.zeros_like(dn)
    near, far = _slab3((r(0), r(1), r(2)), (r(3), r(4), r(5)), ol, inv, zero, zero + BIG)
    t_l = torch.where(near > 0.0, near, far)
    pl = [ol[k] + t_l * dl[k] for k in range(3)]
    pw = [m[4 * k] * pl[0] + m[4 * k + 1] * pl[1] + m[4 * k + 2] * pl[2] + m[4 * k + 3]
          for k in range(3)]
    e = [pw[k] - o[k] for k in range(3)]
    t = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    return _finish(t, near <= far, tmin, tmax)


def _test_disk(r, o, d, tmin, tmax):
    px, py, pz = r(0), r(1), r(2)
    nx, ny, nz = r(3), r(4), r(5)
    rad = r(12)  # disk rows are [p(3), n(3), u(3), v(3), r]
    denom = d[0] * nx + d[1] * ny + d[2] * nz
    denom = torch.where(denom == 0.0, 1e-12, denom)
    t = ((px - o[0]) * nx + (py - o[1]) * ny + (pz - o[2]) * nz) / denom
    hx = o[0] + t * d[0] - px
    hy = o[1] + t * d[1] - py
    hz = o[2] + t * d[2] - pz
    return _finish(t, hx * hx + hy * hy + hz * hz <= rad * rad, tmin, tmax)


def _test_plane(r, o, d, tmin, tmax):
    px, py, pz = r(0), r(1), r(2)
    nx, ny, nz = r(3), r(4), r(5)
    denom = d[0] * nx + d[1] * ny + d[2] * nz
    denom = torch.where(denom == 0.0, 1e-12, denom)
    t = ((px - o[0]) * nx + (py - o[1]) * ny + (pz - o[2]) * nz) / denom
    return _finish(t, torch.ones_like(t, dtype=torch.bool), tmin, tmax)


def _test_cylinder(r, o, d, tmin, tmax):
    px, py, pz = r(0), r(1), r(2)
    qx, qy, qz = r(3), r(4), r(5)
    nx, ny, nz = r(6), r(7), r(8)
    rad = r(9)
    mx, my, mz = o[0] - px, o[1] - py, o[2] - pz
    dn = d[0] * nx + d[1] * ny + d[2] * nz
    vx, vy, vz = d[0] - dn * nx, d[1] - dn * ny, d[2] - dn * nz
    mn = mx * nx + my * ny + mz * nz
    wx, wy, wz = mx - mn * nx, my - mn * ny, mz - mn * nz
    a = vx * vx + vy * vy + vz * vz
    b = 2.0 * (vx * wx + vy * wy + vz * wz)
    c = wx * wx + wy * wy + wz * wz - rad * rad
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a == 0.0, 1e-6, a)
    t0 = (-b - sq) / (2.0 * a_safe)
    t = torch.where(t0 < tmin, (-b + sq) / (2.0 * a_safe), t0)
    axial = mn + t * dn
    len_ax = (qx - px) * nx + (qy - py) * ny + (qz - pz) * nz
    ok = (disc >= 0.0) & (axial >= 0.0) & (axial <= len_ax)
    return _finish(t, ok, tmin, tmax)


PRIM_TESTS = {
    S.RECT: _test_rect,
    S.SPHERE: _test_sphere,
    S.TRIANGLE: _test_triangle,
    S.CONE: _test_cone,
    S.BOX_AABB: _test_aabb,
    S.BOX_OBB: _test_obb,
    S.DISK: _test_disk,
    S.PLANE: _test_plane,
    S.CYLINDER: _test_cylinder,
}


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def cull_window(gbox, o, d, tmin, tmax, best_t, best_e, any_hit):
    """Lanes whose ray reaches the group box within their window."""
    lim = torch.where(best_e == 0, tmax, tmin - 1.0) if any_hit else best_t
    near, far = tmin, lim
    for a in range(3):
        inv = _safe_inv(d[a])
        t0 = (gbox[a] - o[a]) * inv
        t1 = (gbox[3 + a] - o[a]) * inv
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    return near <= far


PLAIN_BLOCK_ELEMENTS = 1 << 22  # lanes x rows a block of dense_plain tests at once


def dense_plain(tid, rows, gbox, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """The dense sweep in plain PyTorch: the kernel's function, a block of
    rows at a time (lanes x rows of at most PLAIN_BLOCK_ELEMENTS).  Within a
    block every row is tested against the window the block starts with and
    the least t wins, the lowest row on a tie; that is the row-by-row sweep's
    result bit for bit, since a row's t does not depend on the window and
    every operation is elementwise."""
    test = PRIM_TESTS[tid]
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    live = cull_window(gbox, o, d, tmin, tmax, best_t, best_e, any_hit)
    oc, dc = tuple(x[:, None] for x in o), tuple(x[:, None] for x in d)
    step = max(1, PLAIN_BLOCK_ELEMENTS // max(ro.shape[0], 1))
    blocks = [(e0, rows[e0:e0 + step].T.contiguous()) for e0 in range(0, rows.shape[0], step)]
    if any_hit:
        occ = best_e
        for _, cols in blocks:
            tt = test(lambda c: cols[c][None, :], oc, dc, tmin[:, None], tmax[:, None])
            occ = torch.maximum(occ, (tt < BIG).any(1).to(torch.int32))
        return best_t, torch.where(live, occ, best_e)
    bt, be = best_t, best_e
    for e0, cols in blocks:
        tt = test(lambda c: cols[c][None, :], oc, dc, tmin[:, None], bt[:, None])
        bt, be = _take_least(tt, e0, bt, be)
    return torch.where(live, bt, best_t), torch.where(live, be, best_e)


def _take_least(t, e0, bt, be):
    """Fold a (lanes, rows) block of t, its first row ``e0``, into the
    running (best t, row): the least t below best t, the lowest row on a tie."""
    t_min = t.min(1).values
    row = torch.arange(e0, e0 + t.shape[1], dtype=torch.int32, device=t.device)
    first = torch.where(t == t_min[:, None], row, torch.iinfo(torch.int32).max).min(1).values
    better = t_min < bt
    return torch.where(better, t_min, bt), torch.where(better, first, be)


def plain_query(g, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """The "plain" route: the group's prims (its pad rows left out), PLAIN_CHUNK
    at a time, through ``scene.intersect.INTERSECT`` of their type as a
    (lanes, prims) product, under the dense sweep's contract (ties to the
    lowest row)."""
    from pine_tpu_torch.scene.intersect import INTERSECT

    if ro.is_cuda:
        LAUNCHES["plain.any_hit" if any_hit else "plain.closest"] += 1
    query = INTERSECT[g["tid"]]
    rows = g["rows"][:len(g["prim_aabbs"])]
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    live = cull_window(g["gbox"], o, d, tmin, tmax, best_t, best_e, any_hit)
    lo = tmin[:, None]
    if any_hit:
        occ = best_e
        for c0 in range(0, rows.shape[0], PLAIN_CHUNK):
            t = query(rows[c0:c0 + PLAIN_CHUNK], ro, rd, lo, tmax[:, None])
            occ = torch.maximum(occ, (t < BIG).any(1).to(torch.int32))
        return best_t, torch.where(live, occ, best_e)
    bt, be = best_t, best_e
    for c0 in range(0, rows.shape[0], PLAIN_CHUNK):
        bt, be = _take_least(query(rows[c0:c0 + PLAIN_CHUNK], ro, rd, lo, bt[:, None]), c0, bt,
                             be)
    return torch.where(live, bt, best_t), torch.where(live, be, best_e)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def bind(fn):
    """Give a library's ``pine_dense_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("dense_traverse").pine_dense_traverse)


def _check(x, dtype, shape, device, name):
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device:
        raise ValueError(
            f"{name}: want {dtype} {shape} on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(x, name):
    """The kernels stage rows and table strips by 16-byte copies."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte-aligned table")


def check_stack(need, cap, what):
    """Refuse a walk that may need more stack entries than its kernel has."""
    if need > cap:
        raise NotImplementedError(
            f"{what} needs a traversal stack of {need} entries; the kernel has {cap}")


def padded_width(tid):
    """The width of a prim row of type ``tid`` as the dense, scdense and BVH
    kernels read it: a multiple of 4 floats, so that each row is whole
    16-byte vectors."""
    return -(-S.PARAM_WIDTH[tid] // 4) * 4


PADDED = frozenset({"dense", "scdense", "bvh"})  # the kernels that read ``dense_rows``


def kernel_rows(g, variant):
    """The rows the kernel of ``variant`` reads for group ``g``: ``dense_rows``
    for the kernels in PADDED, else the group's own."""
    return dense_rows(g) if variant in PADDED else g["rows"]


def dense_rows(g):
    """The group's rows as the dense, scdense and BVH kernels read them
    (``g["drows"]``): each row zero-padded to ``padded_width`` floats, the
    rows themselves where the width is already a multiple of 4; built once,
    at the group's first such query on the card.  The pad columns are never
    read as data, so ``dense_plain`` takes either table."""
    if "drows" not in g:
        rows = g["rows"]
        pad = padded_width(g["tid"]) - rows.shape[1]
        g["drows"] = torch.nn.functional.pad(rows, (0, pad)).contiguous() if pad else rows
    return g["drows"]


def dense_cuda(tid, rows, gbox, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/dense_traverse.cu on the current stream, over ``rows``
    padded as ``dense_rows`` pads a group's."""
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    _check(rows, f32, (rows.shape[0], padded_width(tid)), dev, "rows")
    _aligned(rows, "rows")
    _check(gbox, f32, (6,), dev, "gbox")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), rows.data_ptr(), rows.shape[1], rows.shape[0], gbox.data_ptr(),
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        best_t.data_ptr(), best_e.data_ptr(), out_t.data_ptr(), out_e.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dense_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["dense.any_hit" if any_hit else "dense.closest"] += 1
    return out_t, out_e


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def group_variant(g, small_kernel=None, mesh_kernel=None):
    """The traversal route of a group under the settings (module docstring),
    as pine_tpu's ``_group_variant`` under PINE_SMALL_KERNEL and
    PINE_MESH_KERNEL.  A forced "lattice" on a group that is no lattice falls
    back to the size default, as there; "bvh" needs a SAH-ordered ("bvh"
    kind) group; "mxu" and "mxup" resolve as the module docstring says."""
    from pine_tpu_torch.accel.mxu_tables import supports

    if int(g.get("tid", S.CONE)) not in PRIM_TESTS:  # a type without a ray test
        return "plain"
    n_prims, n_rows = len(g["prim_aabbs"]), g["rows"].shape[0]
    lattice = bool(g.get("lattice"))
    eligible = n_prims <= GRID_MAX_PRIMS_HBM
    mesh = eligible and n_prims > GRID_MAX_PRIMS
    forced = mesh_kernel if mesh else small_kernel if eligible or lattice else None
    if forced is not None and forced not in VARIANTS:
        raise ValueError(f"unknown traversal route {forced!r}: one of {VARIANTS}")
    if forced in ("mxu", "mxup"):
        if supports(g["tid"]) and n_prims <= GRID_MAX_PRIMS:
            return forced
        if supports(g["tid"]) and eligible:
            return "grid_mxu"
        return "dense" if n_rows <= DENSE_DEFAULT_MAX else "grid"
    if forced == "bvh" and g.get("kind") != "bvh":
        raise RouteRefused(f"the bvh route needs a SAH-ordered group; this {g.get('kind')} "
                         f"group of {n_prims} prims has no node arrays")
    if forced is not None and (forced != "lattice" or lattice):
        return forced
    if n_rows <= DENSE_DEFAULT_MAX:
        return "dense"
    if lattice:
        return "lattice"
    return "grid" if eligible else "bvh"


def prepare(g, variant):
    """Build and upload the tables route ``variant`` reads, if the group does
    not hold them yet: ``grid``, ``scd``, ``sctree`` or ``bvh``; the
    coefficient tables ``mxu`` (value-major) or ``mxut`` (tile-major); for
    "grid_mxu" the grid layout and the supercell-major ``mxum``, joined as
    ``grid_mxu``; the dense sweep reads ``gbox`` and the lattice march
    ``lat``, which every such group holds."""
    from pine_tpu_torch.accel import bvh_traverse, grid_traverse, mxu_sweep
    from pine_tpu_torch.accel import scdense_traverse, sctree

    dev, pa = g["rows"].device, g["prim_aabbs"]
    if variant in ("grid", "grid_mxu") and "grid" not in g:
        g["grid"] = grid_traverse.upload_layout(grid_traverse.grid_layout(pa), dev)
    if variant == "grid_mxu" and "grid_mxu" not in g:
        g["grid_mxu"] = dict(g["grid"], mxu=mxu_sweep.prepare_tables(g, "mxum"))
    elif variant in ("mxu", "mxup"):
        mxu_sweep.prepare_tables(g, "mxu" if variant == "mxu" else "mxut")
    elif variant == "scdense" and "scd" not in g:
        g["scd"] = scdense_traverse.scdense_layout(pa, dev)
    elif variant == "sctree" and "sctree" not in g:
        g["sctree"] = grid_traverse.upload_layout(sctree.sc_tree_layout(pa), dev)
    elif variant == "bvh" and "bvh" not in g:
        if g.get("nodes") is None:
            raise RouteRefused("the bvh route needs the group's SAH node arrays")
        g["bvh"] = bvh_traverse.bvh_layout(g["nodes"], pa, dev)


def route(groups, small_kernel=None, mesh_kernel=None):
    """Resolve every group's route under the settings, build the tables each
    needs and then record it as ``g["variant"]``, so that a refused setting
    changes no route."""
    variants = [group_variant(g, small_kernel, mesh_kernel) for g in groups]
    for g, v in zip(groups, variants):
        prepare(g, v)
    for g, v in zip(groups, variants):
        g["variant"] = v


def group_query(g, ro, rd, tmin, tmax, best_t, best_e, any_hit=False, variant=None):
    """One group's traversal over a flat wavefront (see module docstring), by
    its route ``g["variant"]`` (``route``), or by ``variant`` for an A/B run,
    as pine_tpu's ``pallas_group_query`` forces one: the group must hold that
    route's tables (``prepare``); "lattice" on a group that is no lattice
    takes the size default, as there.  The span ``group.<route>``."""
    if variant is None:
        variant = g["variant"]
    with profiler.group_span(variant):
        return _route_query(g, variant, ro, rd, tmin, tmax, best_t, best_e, any_hit)


def _route_query(g, variant, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    if variant == "plain":
        return plain_query(g, ro, rd, tmin, tmax, best_t, best_e, any_hit)
    if variant == "lattice" and not g.get("lattice"):
        variant = "dense" if g["rows"].shape[0] <= DENSE_DEFAULT_MAX else "grid"
    if variant == "lattice":
        from pine_tpu_torch.accel.lattice_traverse import lattice_cuda, lattice_plain

        fn = lattice_cuda if ro.is_cuda else lattice_plain
        return fn(g, ro, rd, tmin, tmax, best_t, best_e, any_hit)
    if variant == "dense":
        if ro.is_cuda:
            return dense_cuda(g["tid"], kernel_rows(g, variant), g["gbox"], ro, rd, tmin, tmax,
                              best_t, best_e, any_hit)
        return dense_plain(g["tid"], g["rows"], g["gbox"], ro, rd, tmin, tmax, best_t, best_e,
                           any_hit)
    from pine_tpu_torch.accel import bvh_traverse, grid_traverse, mxu_sweep, scdense_traverse
    from pine_tpu_torch.accel import sctree_traverse

    table, kernel, plain = {
        "mxu": ("mxu", mxu_sweep.mxu_query, mxu_sweep.mxu_query),
        "mxup": ("mxut", mxu_sweep.mxup_cuda, mxu_sweep.mxup_plain),
        "grid_mxu": ("grid_mxu", partial(grid_traverse.grid_cuda, mxu=True),
                     partial(grid_traverse.grid_plain, mxu=True)),
        "grid": ("grid", grid_traverse.grid_cuda, grid_traverse.grid_plain),
        "scdense": ("scd", scdense_traverse.scdense_cuda, scdense_traverse.scdense_plain),
        "sctree": ("sctree", sctree_traverse.sctree_cuda, grid_traverse.supercell_plain),
        "bvh": ("bvh", bvh_traverse.bvh_cuda, grid_traverse.supercell_plain)}[variant]
    if not ro.is_cuda:
        return plain(g["tid"], g["rows"], g[table], ro, rd, tmin, tmax, best_t, best_e, any_hit)
    return kernel(g["tid"], kernel_rows(g, variant), g[table], ro, rd, tmin, tmax, best_t, best_e,
                  any_hit)
