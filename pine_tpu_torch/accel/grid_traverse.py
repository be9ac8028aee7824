"""Grid traversal of one prim group: host tables, the kernel wrapper and its
plain version.

Counterpart of pine_tpu/accel/pallas_traverse.py's grid kernel:
``_grid_layout`` (here ``grid_layout``), ``_make_grid_kernel`` /
``_compiled_grid_call`` (here csrc/grid_traverse.cu through ``grid_cuda``).
The group's prims, in SAH leaf order, are cut into 128-prim supercells and
32-prim cells; 16 supercells make a coarse box.  A ray is culled against
coarse boxes, then supercells, then cells, each with the slab test of
``pallas_traverse.py:878-910`` against its window (closest-hit: up to the
running best; any-hit: up to tmax), and tests the prims of the cells it
reaches.  The contract is ``dense_traverse.group_query``'s.

What was TPU-only is dropped: the (E_pad, 128) lane-padded table (the kernel
reads the group's rows as they are) and the 2048-row DMA alignment.

The MXU form (``grid_cuda`` and ``grid_plain`` with ``mxu=True``, the route
"grid_mxu"; pine_tpu's ``_make_grid_kernel`` with ``mxu_m > 0``) makes the
same culls and swaps the leaf: a prim's test is its pair values from the
supercell-major coefficient table (accel/mxu_tables.build_mesh_tables,
``grid["mxu"]``) and the epilogue of accel/mxu_sweep.py.

``grid_plain`` computes the same function in plain PyTorch: supercells in row
order, each tested as one (live lanes, 128) batch.  A closest hit is the
lowest t and, among equal t, the lowest row; the kernel keeps that rule
whatever its visit order.  The two can still differ on a rare lane where a
cull decides at a box face: the running best at the moment of a cull
depends on the visit order, and a hit on a box face can round outside the
slab (PERF.md, Findings).  ``supercell_plain``, the same sweep with no coarse
level, is the plain version of the supercell-tree and BVH routes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import BIG, LAUNCHES, PRIM_TESTS, _check, _safe_inv

SUPER = 128  # prims per supercell
CELL = 32  # prims per cull cell
COARSE = 16  # supercells per coarse box
SLAB_OPS = 24  # FP32 operations of one slab test (sub, mul, min, max)


def _boxes(aabbs, size, n_out):
    """Union boxes of consecutive ``size``-runs of (E,6) boxes -> (n_out,6);
    rows past the last run are the empty box (1,1,1,-1,-1,-1)."""
    out = np.zeros((n_out, 6), np.float32)
    out[:, 0:3] = 1.0
    out[:, 3:6] = -1.0
    aabbs = np.asarray(aabbs, np.float32)
    if len(aabbs):
        starts = np.arange(0, len(aabbs), size)
        out[: len(starts), 0:3] = np.minimum.reduceat(aabbs[:, 0:3], starts)
        out[: len(starts), 3:6] = np.maximum.reduceat(aabbs[:, 3:6], starts)
    return out


def _octant_orders(bx, segment=None):
    """Per-octant near-first visit orders by box centroid projected on the
    travel diagonal (octant bit k set: direction component k negative);
    empty boxes sort last.  ``segment=k`` sorts within each k-long run."""
    m = len(bx)
    cxyz = (bx[:, 0:3] + bx[:, 3:6]) * 0.5
    empty = bx[:, 0] > bx[:, 3]
    orders = np.zeros((8, m), np.int32)
    for o in range(8):
        s = np.array([-1.0 if o & 1 else 1.0, -1.0 if o & 2 else 1.0,
                      -1.0 if o & 4 else 1.0], np.float32)
        key = cxyz @ s
        key[empty] = np.inf
        if segment is None:
            orders[o] = np.argsort(key, kind="stable")
        else:
            for i in range(0, m, segment):
                orders[o, i : i + segment] = i + np.argsort(key[i : i + segment], kind="stable")
    return orders


def grid_layout(prim_aabbs):
    """Host tables of a group from its (E,6) leaf-order prim boxes:
    ``coarse_boxes`` (n_coarse,6), ``sc_boxes`` (n_coarse*16,6),
    ``cell_boxes`` (n_super*4,6), ``c_order8`` (8,n_coarse), ``s_order8``
    (8,n_coarse*16), and the counts.  The coarse level is used when there
    are more than 16 supercells (pallas_traverse.py:842)."""
    boxes = np.asarray(prim_aabbs, np.float32)
    E = len(boxes)
    n_super = (E + SUPER - 1) // SUPER
    n_coarse = (n_super + COARSE - 1) // COARSE
    sb = _boxes(boxes, SUPER, n_coarse * COARSE)
    cb = np.zeros((n_coarse, 6), np.float32)
    for i in range(n_coarse):
        seg = sb[i * COARSE : min((i + 1) * COARSE, n_super)]
        cb[i, 0:3] = seg[:, 0:3].min(0)
        cb[i, 3:6] = seg[:, 3:6].max(0)
    return dict(
        n_prims=E, n_super=n_super, n_coarse=n_coarse, use_coarse=n_super > COARSE,
        coarse_boxes=cb, sc_boxes=sb, cell_boxes=_boxes(boxes, CELL, n_super * (SUPER // CELL)),
        c_order8=_octant_orders(cb), s_order8=_octant_orders(sb, segment=COARSE),
    )


def upload_layout(lay, device):
    """The layout's tables as contiguous tensors on ``device`` (once, at compile())."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            if isinstance(v, np.ndarray) else v for k, v in lay.items()}


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _slab(box, o, inv, tmin, lim):
    """pallas_traverse.py's slab cull of (N,) rays against one (6,) box, or of
    (N,1) rays against (K,6) boxes -> (N,) or (N,K) bool."""
    t0 = [(box[..., a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(box[..., 3 + a] - o[a]) * inv[a] for a in range(3)]
    near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                         torch.maximum(torch.minimum(t0[2], t1[2]), tmin))
    far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                        torch.minimum(torch.maximum(t0[2], t1[2]), lim))
    return near <= far


def grid_plain(tid, rows, grid, ro, rd, tmin, tmax, best_t, best_e, any_hit, counts=None,
               mxu=False):
    """The grid traversal in plain PyTorch (see module docstring), its MXU
    form with ``mxu``.  With a
    ``counts`` dict, adds the slab tests and prim tests this call ran to
    ``counts["slabs"]`` and ``counts["tests"]`` (any-hit: tests up to each
    lane's first hit, as the kernel stops there), and the cell slab tests
    among them, those of the supercells that passed, to ``counts["cells"]``."""
    test = PRIM_TESTS[tid]
    mxu = mxu_table(grid) if mxu else None
    n_prims, n_super = grid["n_prims"], grid["n_super"]
    sc, cells, coarse = grid["sc_boxes"], grid["cell_boxes"], grid["coarse_boxes"]
    dev = ro.device
    inv = [_safe_inv(rd[:, a]) for a in range(3)]
    o = [ro[:, a] for a in range(3)]
    cols = torch.arange(SUPER, device=dev)
    big_row = torch.full((SUPER,), 2**30, dtype=torch.int64, device=dev)
    n_slabs = n_cells = n_tests = 0
    if any_hit:
        occ = best_e.clone()
        active = (best_e == 0) & (tmax > tmin)
    else:
        cur_t, cur_e = best_t.clone(), best_e.clone()

    def window(idx):
        return tmax[idx] if any_hit else cur_t[idx]

    for c in range(grid["n_coarse"]):
        lanes = torch.nonzero(active).squeeze(1) if any_hit else torch.arange(ro.shape[0], device=dev)
        if grid["use_coarse"]:
            n_slabs += lanes.numel()
            ok = _slab(coarse[c], [x[lanes] for x in o], [x[lanes] for x in inv],
                       tmin[lanes], window(lanes))
            lanes = lanes[ok]
        for si in range(c * COARSE, min((c + 1) * COARSE, n_super)):
            if any_hit:
                lanes = lanes[occ[lanes] == 0]
            n_slabs += lanes.numel()
            oi, ii, tmi = [x[lanes] for x in o], [x[lanes] for x in inv], tmin[lanes]
            ok = _slab(sc[si], oi, ii, tmi, window(lanes))
            idx = lanes[ok]
            if idx.numel() == 0:
                continue
            oi, ii, tmi = [x[idx, None] for x in o], [x[idx, None] for x in inv], tmin[idx, None]
            k_cells = min(SUPER // CELL, (n_prims - si * SUPER + CELL - 1) // CELL)
            n_slabs += idx.numel() * k_cells
            n_cells += idx.numel() * k_cells
            cell_ok = _slab(cells[si * (SUPER // CELL) : si * (SUPER // CELL) + k_cells],
                            oi, ii, tmi, window(idx)[:, None])
            p0 = si * SUPER
            width = min(SUPER, n_prims - p0)
            tested = cell_ok.repeat_interleave(CELL, dim=1)[:, :width]
            d = [rd[idx, a, None] for a in range(3)]
            limit = tmax[idx, None] if any_hit else best_t[idx, None]
            if mxu is not None:
                from pine_tpu_torch.accel.mxu_sweep import mesh_leaf_t

                tt = mesh_leaf_t(tid, mxu, si, width, oi, d, tmi, limit)
            else:
                r = rows[p0 : p0 + width]
                tt = test(lambda k: r[:, k], oi, d, tmi, limit)
            if any_hit:
                hit = tested & (tt < BIG)
                first = torch.where(hit.any(1), hit.to(torch.int8).argmax(1), width - 1)
                n_tests += int(tested.cumsum(1).gather(1, first[:, None]).sum())
                occ[idx] = torch.where(hit.any(1), 1, occ[idx])
            else:
                n_tests += int(tested.sum())
                tt = torch.where(tested, tt, float("inf"))
                tb = tt.min(1).values
                eb = torch.where(tt == tb[:, None], cols[:width], big_row[:width]).min(1).values
                better = tb < cur_t[idx]
                cur_t[idx] = torch.where(better, tb, cur_t[idx])
                cur_e[idx] = torch.where(better, (p0 + eb).to(cur_e.dtype), cur_e[idx])
    if counts is not None:
        counts["slabs"] = counts.get("slabs", 0) + n_slabs
        counts["tests"] = counts.get("tests", 0) + n_tests
        counts["cells"] = counts.get("cells", 0) + n_cells
    if any_hit:
        return best_t, occ
    return cur_t, cur_e


def supercell_plain(tid, rows, tables, ro, rd, tmin, tmax, best_t, best_e, any_hit,
                    counts=None):
    """The function of the supercell-tree and BVH routes in plain PyTorch:
    ``grid_plain``'s sweep in row order, culled by the group's 128-prim
    supercell and 32-prim cell boxes, with no coarse level (a Python loop
    over the supercells, so that it stays within seconds on a group of
    millions of prims on the card).  ``tables`` holds ``n_prims`` and either
    those boxes (``sc_boxes``, ``cell_boxes``: the supercell tree's tables)
    or the group's leaf-order ``prim_aabbs`` on the host (the BVH's), from
    which the boxes are built for this call: only the plain version reads
    them.  ``counts`` as ``grid_plain``'s."""
    n_prims = tables["n_prims"]
    n_super = (n_prims + SUPER - 1) // SUPER
    if "sc_boxes" in tables:
        sc, cells = tables["sc_boxes"], tables["cell_boxes"]
    else:
        pa = tables["prim_aabbs"]
        sc, cells = (torch.as_tensor(_boxes(pa, size, n), device=rows.device) for size, n in (
            (SUPER, n_super), (CELL, n_super * (SUPER // CELL))))
    grid = dict(n_prims=n_prims, n_super=n_super, n_coarse=(n_super + COARSE - 1) // COARSE,
                use_coarse=False, coarse_boxes=None, sc_boxes=sc, cell_boxes=cells)
    return grid_plain(tid, rows, grid, ro, rd, tmin, tmax, best_t, best_e, any_hit,
                      counts=counts)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _library():
    from pine_tpu_torch import cuda_build

    fn = cuda_build.load("grid_traverse").pine_grid_traverse
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def mxu_table(grid):
    """The coefficient table ``grid["mxu"]`` that the MXU form reads; refuses
    a layout without one (``dense_traverse.prepare`` joins it for the route
    "grid_mxu")."""
    if grid.get("mxu") is None:
        raise ValueError("the MXU form needs the group's coefficient table (route grid_mxu)")
    return grid["mxu"]


def grid_cuda(tid, rows, grid, ro, rd, tmin, tmax, best_t, best_e, any_hit, mxu=False):
    """Launch csrc/grid_traverse.cu on the current stream (its MXU form with
    ``mxu``)."""
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    n_super, n_coarse = grid["n_super"], grid["n_coarse"]
    if rows.shape[0] < grid["n_prims"]:
        raise ValueError(f"rows: {rows.shape[0]} rows for a grid of {grid['n_prims']} prims")
    _check(rows, f32, (rows.shape[0], rows.shape[1]), dev, "rows")
    for k, shape in (("coarse_boxes", (n_coarse, 6)), ("sc_boxes", (n_coarse * COARSE, 6)),
                     ("cell_boxes", (n_super * (SUPER // CELL), 6))):
        _check(grid[k], f32, shape, dev, k)
    _check(grid["c_order8"], i32, (8, n_coarse), dev, "c_order8")
    _check(grid["s_order8"], i32, (8, n_coarse * COARSE), dev, "s_order8")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    mxu = mxu_table(grid) if mxu else None
    if mxu is not None:
        from pine_tpu_torch.accel.mxu_tables import MXU_M, RAY_FEATS

        if mxu["m"] != MXU_M.get(tid):
            raise ValueError(f"a table of {mxu['m']} values for prim type {tid}")
        _check(mxu["W"], f32, (n_super * RAY_FEATS, mxu["m"] * SUPER), dev, "mxu W")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), rows.data_ptr(), rows.shape[1], grid["n_prims"], n_super, n_coarse,
        int(grid["use_coarse"]), grid["coarse_boxes"].data_ptr(), grid["sc_boxes"].data_ptr(),
        grid["cell_boxes"].data_ptr(), grid["c_order8"].data_ptr(), grid["s_order8"].data_ptr(),
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(),
        best_e.data_ptr(), out_t.data_ptr(), out_e.data_ptr(),
        None if mxu is None else mxu["W"].data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grid_traverse kernel launch failed: CUDA error {err}")
    kind = "grid" if mxu is None else "grid_mxu"
    LAUNCHES[f"{kind}.any_hit" if any_hit else f"{kind}.closest"] += 1
    return out_t, out_e

