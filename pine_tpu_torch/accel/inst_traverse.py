"""Two-level instanced traversal: host tables, the kernel wrapper and its
plain version.

Counterpart of pine_tpu/accel/instanced_kernel.py: ``inst_layout`` (here
``upload_inst_group``), ``_stack_need`` (here ``stack_need``),
``kernel_supports`` (here ``dense_traverse.check_stack``, which raises) and
``_make_inst_kernel`` / ``_compiled_inst_call`` (here
csrc/inst_traverse.cu through ``inst_cuda``).  An instanced group
(accel/packet._instanced_group) holds one triangle mesh in its SAH leaf
order, cut into the supercell tree of accel/sctree.py, and a SAH tree over
the instances' world boxes.  A ray walks the instance tree in world space;
at each instance it may reach it goes into the instance's frame through the
3x4 inverse transform (directions unnormalized, so local t is world t) and
walks the mesh's supercell tree there.  Hits carry virtual ids
``vbase + instance * stride + tri``.  On the card a warp walks both trees
together, as the TPU kernel's (8,128) ray block did: one stack per warp,
a node, instance or cell taken when any of its rays reaches it
(csrc/inst_traverse.cu).

Contract (``inst_query``), as inst_kernel_intersect / inst_kernel_any_hit:

- closest-hit: ``(best_t, best_e)`` in and out, ``best_e`` out the full
  virtual id; the best is the lowest ``(t, virtual id)`` over the group's
  triangles with ``tmin < t < best_t`` (the incoming best), so it replaces
  the incoming one only on a strict ``t < best_t`` and ties go to the lowest
  id whatever the visit order;
- any-hit: ``best_e`` in and out is the 0/1 occlusion flag, ``best_t``
  passes through; a lane with ``tmax <= tmin`` never becomes occluded.

What was TPU-only is dropped: ``INST_KERNEL_MAX`` (an SMEM budget), the
lane mask ``imask``, the lane-padded table and the ``PINE_INST_PROBE``
probes.

The MXU leaf form (``inst_cuda`` and ``inst_plain`` with ``mxu=True``;
``CompiledScene.inst_kernel = "mxu"``, the counterpart of
``PINE_INST_KERNEL=mxu``): the same walk, with each triangle's test read
from the shared mesh's supercell-major coefficient table
(accel/mxu_tables.build_mesh_tables, ``g["mxum"]``) over the instance's
local ray; its plain version is ``inst_plain`` with ``grid_plain``'s MXU
leaf.  ``g["variant"]`` ("inst" or "inst_mxu", set by
``route_inst``) selects the form ``inst_query`` runs.

``inst_plain`` computes the same function in plain PyTorch with
pine_tpu's other form of this traversal, the dense enumeration of
accel/instanced_pallas.py: every lane lists the instances whose world box
it enters, nearest first (entry distance, then id), and in each round every
lane takes its next one below its running best, goes into that instance's
frame with the kernel's expression order, and runs one
``grid_traverse.grid_plain`` query over the shared mesh; results merge by
the ``(t, virtual id)`` rule.  The two can differ only on a rare lane where
a cull decides at a box face, as the grid kernel and ``grid_plain`` can.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import (
    BIG, LAUNCHES, _aligned, _check, _safe_inv, check_stack,
)
from pine_tpu_torch.accel.grid_traverse import CELL, SUPER, grid_layout, grid_plain, upload_layout
from pine_tpu_torch.accel.sctree import TREE_LEAF, sc_tree_layout, tree_depth

STACK_DEPTH = 64  # entries of the kernel's per-warp stack (csrc/inst_traverse.cu)
ENTRY_CHUNK = 1 << 24  # (lanes, instances) slab tests per block of the plain version
# FP32 operations of entering one instance: its box's slab test (24), the 3x4
# transform of origin and direction (18 + 15) and three divisions
ENTER_OPS = 24 + 33 + 3


def stack_need(d_top, d_mesh):
    """Stack entries the kernel's warp walk may need for a group whose top
    tree has ``d_top`` node levels and whose mesh tree ``d_mesh``:
    d_top + 2 * TREE_LEAF + d_mesh - 2.

    A top node pops and pushes at most 2 * TREE_LEAF entries (two inner
    children, one inner child and up to TREE_LEAF instances, or the
    instances of two leaf children), its instances last, so they are all
    popped before its inner children: below a node at depth k lie at most
    k - 1 deferred siblings.  An instance pops, with at most
    2 * TREE_LEAF - 1 of its node's entries still below it, and the mesh
    walk runs above them; it holds at most d_mesh entries (one per level of
    the mesh tree: a node pushes its two inner children, or one and opens
    its leaf child, or opens one leaf child and defers the other).  The sum
    is the bound; pine_tpu's walk, which pushes every taken child, checks
    the larger d_top * (1 + 2 * TREE_LEAF) + d_mesh + 4
    (instanced_kernel.py:624-634)."""
    return d_top + 2 * TREE_LEAF + d_mesh - 2


def upload_inst_group(g, device):
    """An instanced group as the traversal reads it, uploaded once at
    compile(): the host group of ``_instanced_group`` with its tables as
    tensors on ``device``, the mesh's supercell tree (``sctree``), its grid
    tables for the plain version (``grid``), the instance tree ``tboxes``
    (M, 2, 6), ``tnode``, ``tstart``, ``tcount`` (M, 2), and the tree depths
    and ``need`` (``stack_need``)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    pa = np.asarray(g["prim_aabbs"], np.float32)
    sct = sc_tree_layout(pa)
    d_top = tree_depth(g["ic_node"])
    out = dict(
        kind="instanced", tid=int(g["tid"]), vbase=int(g["vbase"]), stride=int(g["stride"]),
        n_tris=int(g["n_tris"]), n_inst=int(g["n_inst"]), prim_aabbs=pa,
        rows=t(g["rows"], f32), tri_n=t(g["tri_n"], f32), tri_t=t(g["tri_t"], f32),
        tri_has_n=t(g["tri_has_n"], torch.bool), tri_has_t=t(g["tri_has_t"], torch.bool),
        iboxes=t(g["iboxes"], f32), minv=t(g["minv"], f32), m=t(g["m"], f32),
        gidx=t(g["gidx"], i32),
        tboxes=t(np.concatenate([g["ic_lower"], g["ic_upper"]], axis=-1), f32),
        tnode=t(g["ic_node"], i32), tstart=t(g["ic_start"], i32), tcount=t(g["ic_count"], i32),
        sctree=upload_layout(sct, device), grid=upload_layout(grid_layout(pa), device),
        d_top=d_top, d_mesh=sct["depth"], need=stack_need(d_top, sct["depth"]),
    )
    if out["vbase"] + out["n_inst"] * out["stride"] >= 2**31:
        raise ValueError("instanced group: virtual ids exceed int32")
    return out


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def _slab_near(boxes, o, inv, tmin):
    """Slab test of (N,) rays against (K, 6) boxes -> (entry (N, K), exit
    before any window (N, K)), the kernel's formula."""
    t0 = [(boxes[None, :, a] - o[a][:, None]) * inv[a][:, None] for a in range(3)]
    t1 = [(boxes[None, :, 3 + a] - o[a][:, None]) * inv[a][:, None] for a in range(3)]
    near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                         torch.maximum(torch.minimum(t0[2], t1[2]), tmin[:, None]))
    far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                        torch.maximum(t0[2], t1[2]))
    return near, far


def _candidates(g, ro, rd, tmin, bound):
    """Every lane's instances whose world box it enters at or before
    ``bound``, nearest first (entry, then id) -> (first (N,), count (N,),
    inst, entry) with lane k's candidates at first[k] : first[k] + count[k]."""
    n = ro.shape[0]
    inv = [_safe_inv(rd[:, a]) for a in range(3)]
    step = max(1, ENTRY_CHUNK // max(g["n_inst"], 1))
    lanes, insts, entries = [], [], []
    for c0 in range(0, n, step):
        sl = slice(c0, c0 + step)
        near, far = _slab_near(g["iboxes"], [ro[sl, a] for a in range(3)],
                               [x[sl] for x in inv], tmin[sl])
        lane, inst = torch.nonzero((near <= far) & (near <= bound[sl, None]), as_tuple=True)
        lanes.append(lane + c0)
        insts.append(inst)
        entries.append(near[lane, inst])
    lane, inst, entry = torch.cat(lanes), torch.cat(insts), torch.cat(entries)
    # lane-major (entry, id) order: a stable sort by entry, then by lane
    o = torch.sort(entry, stable=True)[1]
    o = o[torch.sort(lane[o], stable=True)[1]]
    count = torch.bincount(lane, minlength=n)
    first = torch.cumsum(count, 0) - count
    return first, count, inst[o], entry[o]


def local_rays(minv, ro, rd):
    """World rays into instance frames with (k, 12) inverses, in the kernel's
    expression order ((m0*x + m1*y) + m2*z) + m3 -> (origins, directions)."""
    o = torch.stack([minv[:, 4 * k] * ro[:, 0] + minv[:, 4 * k + 1] * ro[:, 1]
                     + minv[:, 4 * k + 2] * ro[:, 2] + minv[:, 4 * k + 3] for k in range(3)], 1)
    d = torch.stack([minv[:, 4 * k] * rd[:, 0] + minv[:, 4 * k + 1] * rd[:, 1]
                     + minv[:, 4 * k + 2] * rd[:, 2] for k in range(3)], 1)
    return o, d


def inst_plain(g, ro, rd, tmin, tmax, best_t, best_e, any_hit, counts=None, mxu=False):
    """The instanced traversal in plain PyTorch (see module docstring), its
    MXU leaf form with ``mxu``.  With a ``counts`` dict, adds the instances
    entered (``entries``) and grid_plain's ``slabs``, ``cells`` and
    ``tests``."""
    if any_hit:
        occ = best_e.clone()
        live = (occ == 0) & (tmax > tmin)
        bound = torch.where(live, tmax, -BIG)
    else:
        cur_t, cur_e = best_t.clone(), best_e.clone()
        bound = torch.where(best_t > tmin, best_t, -BIG)
    first, count, inst, entry = _candidates(g, ro, rd, tmin, bound)
    tid, rows, grid = g["tid"], g["rows"], g["grid"]
    if mxu:
        grid = dict(grid, mxu=mesh_table(g))
    leaf = dict(counts=counts, mxu=mxu)
    n_entries = 0
    for k in range(int(count.max()) if count.numel() else 0):
        idx = (first + k).clamp_max(max(inst.numel() - 1, 0))
        want = count > k
        if any_hit:
            want &= (occ == 0) & (entry[idx] <= tmax)
        else:
            want &= entry[idx] <= cur_t
        sel = torch.nonzero(want).squeeze(1)
        if sel.numel() == 0:
            continue  # lanes with more candidates may still be waiting
        n_entries += sel.numel()
        j = inst[idx[sel]]
        ol, dl = local_rays(g["minv"][j], ro[sel], rd[sel])
        if any_hit:
            _, o_new = grid_plain(tid, rows, grid, ol, dl, tmin[sel], tmax[sel], tmax[sel],
                                  torch.zeros_like(sel, dtype=torch.int32), True, **leaf)
            occ[sel] = torch.maximum(occ[sel], o_new)
            continue
        # each instance's best below the incoming bound, then the (t, id) rule
        t_i, e_i = grid_plain(tid, rows, grid, ol, dl, tmin[sel], best_t[sel], best_t[sel],
                              torch.full_like(sel, -1, dtype=torch.int32), False, **leaf)
        vid = (g["vbase"] + j * g["stride"] + e_i).to(torch.int32)
        ct, ce = cur_t[sel], cur_e[sel]
        better = (e_i >= 0) & ((t_i < ct) | ((t_i == ct) & (vid < ce)))
        cur_t[sel] = torch.where(better, t_i, ct)
        cur_e[sel] = torch.where(better, vid, ce)
    if counts is not None:
        counts["entries"] = counts.get("entries", 0) + n_entries
    if any_hit:
        return best_t, occ
    return cur_t, cur_e


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def bind(fn):
    """Give a library's ``pine_inst_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("inst_traverse").pine_inst_traverse)


def mesh_table(g):
    """The shared mesh's supercell-major coefficient table (``g["mxum"]``),
    which the MXU leaf form reads; ``route_inst`` builds it."""
    if "mxum" not in g:
        raise ValueError("the MXU leaf form needs the mesh's coefficient table (route_inst)")
    return g["mxum"]


def inst_cuda(g, ro, rd, tmin, tmax, best_t, best_e, any_hit, mxu=False):
    """Launch csrc/inst_traverse.cu on the current stream (its MXU leaf form
    with ``mxu``)."""
    check_stack(g["need"], STACK_DEPTH, f"instanced group (top tree depth {g['d_top']}, "
                f"mesh tree depth {g['d_mesh']})")
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    sct = g["sctree"]
    n_super, n_nodes, n_top = sct["n_super"], sct["boxes"].shape[0], g["tboxes"].shape[0]
    _check(g["rows"], f32, (g["n_tris"] + TREE_LEAF, 12), dev, "rows")
    _aligned(g["rows"], "rows")
    for k, shape in (("sc_boxes", (n_super, 6)), ("cell_boxes", (n_super * (SUPER // CELL), 6)),
                     ("boxes", (n_nodes, 2, 6))):
        _check(sct[k], f32, shape, dev, k)
    for k in ("cnode", "cstart", "ccount"):
        _check(sct[k], i32, (n_nodes, 2), dev, k)
    _check(sct["sc_order"], i32, (n_super + TREE_LEAF,), dev, "sc_order")
    _check(g["tboxes"], f32, (n_top, 2, 6), dev, "tboxes")
    for k in ("tnode", "tstart", "tcount"):
        _check(g[k], i32, (n_top, 2), dev, k)
    _check(g["iboxes"], f32, (g["n_inst"], 6), dev, "iboxes")
    _check(g["minv"], f32, (g["n_inst"] + TREE_LEAF, 12), dev, "minv")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    w_ptr = None
    if mxu:
        tab = mesh_table(g)
        _check(tab["W"], f32, (n_super * 8, tab["m"] * SUPER), dev, "mxu W")
        _aligned(tab["W"], "mxu W")
        w_ptr = tab["W"].data_ptr()
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        int(any_hit), STACK_DEPTH, g["rows"].data_ptr(), sct["n_prims"], n_super,
        sct["sc_boxes"].data_ptr(), sct["cell_boxes"].data_ptr(), sct["boxes"].data_ptr(),
        sct["cnode"].data_ptr(), sct["cstart"].data_ptr(), sct["ccount"].data_ptr(),
        sct["sc_order"].data_ptr(), g["tboxes"].data_ptr(), g["tnode"].data_ptr(),
        g["tstart"].data_ptr(), g["tcount"].data_ptr(), g["iboxes"].data_ptr(),
        g["minv"].data_ptr(), g["vbase"], g["stride"], ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(), best_e.data_ptr(),
        out_t.data_ptr(), out_e.data_ptr(), w_ptr, n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"inst_traverse kernel launch failed: CUDA error {err}")
    kind = "inst_mxu" if mxu else "inst"
    LAUNCHES[f"{kind}.any_hit" if any_hit else f"{kind}.closest"] += 1
    return out_t, out_e


INST_KERNELS = (None, "mxu")  # the values of CompiledScene.inst_kernel


def route_inst(groups, inst_kernel=None):
    """Route every instanced group under the setting ``inst_kernel`` (None:
    the VPU form; "mxu": the MXU leaf form, whose table is built here, once)
    and record it as ``g["variant"]``."""
    if inst_kernel not in INST_KERNELS:
        raise ValueError(f"unknown instanced route {inst_kernel!r}: one of {INST_KERNELS}")
    if inst_kernel == "mxu":
        from pine_tpu_torch.accel.mxu_sweep import prepare_tables

        for g in groups:
            prepare_tables(g, "mxum")
    for g in groups:
        g["variant"] = "inst_mxu" if inst_kernel == "mxu" else "inst"


def inst_query(g, ro, rd, tmin, tmax, best_t, best_e, any_hit=False):
    """One instanced group's traversal over a flat wavefront (see module
    docstring), in the form ``g["variant"]``: the kernel on CUDA tensors,
    the plain version on CPU ones."""
    fn = inst_cuda if ro.is_cuda else inst_plain
    return fn(g, ro, rd, tmin, tmax, best_t, best_e, any_hit, mxu=g.get("variant") == "inst_mxu")
