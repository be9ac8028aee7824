"""Supercell-tree traversal of one prim group: the kernel wrapper.

Counterpart of pine_tpu/accel/pallas_traverse.py's supercell-tree kernel
(``_make_sctree_kernel`` / ``_compiled_sctree_call``, here
csrc/sctree_traverse.cu through ``sctree_cuda``), which ``pine_tpu`` runs
under ``PINE_MESH_KERNEL=sctree`` and the port when
``CompiledScene.mesh_kernel`` (or ``small_kernel``) is "sctree".  The tables
are accel/sctree.py's (``sc_tree_layout``, uploaded once): a SAH tree over
the group's 128-prim supercells, the supercell and 32-prim cell boxes.  On
the card the warp is the unit of the walk, as the TPU kernel's (8,128) ray
block was: one stack per warp, a child taken when any of its rays reaches
its box, near-first; each supercell of a reached leaf, then each of its
cells, culled per ray, and each cell that a ray reaches staged in shared
memory and tested as the grid kernel tests its cells (csrc/warp_leaf.cuh).
The contract is ``dense_traverse.group_query``'s; exact ties in t go to the
lowest row whatever the visit order.

The kernel's stack holds STACK_DEPTH entries, and the walk needs at most the
tree's depth of them: the wrapper refuses a deeper tree.

The plain version is ``grid_traverse.supercell_plain``, which computes the
same function with a row-order sweep over the same supercell and cell boxes
(no tree): the lowest (t, row) among the prims the ray reaches in its
window, and the occlusion flag.  Apart from the lanes below, the two can
differ only on a rare lane where a cull decides at a box face, as the grid
kernel and ``grid_plain`` can: the running best at a cull depends on the
visit order.

A closest-hit lane whose window ends above the miss sentinel BIG and that
hits nothing (a render's windows end at FLT_MAX) gets BIG and the id of a
prim it tested; the two test different prims, so such lanes may differ in
that id (or keep their incoming state in one of them), and every caller
reads them as misses.
"""
from __future__ import annotations

import ctypes

import torch

from pine_tpu_torch.accel.dense_traverse import LAUNCHES, _aligned, _check, check_stack
from pine_tpu_torch.accel.grid_traverse import CELL, SUPER
from pine_tpu_torch.accel.sctree import TREE_LEAF
from pine_tpu_torch.scene import shapes as S

STACK_DEPTH = 64  # entries of the kernel's per-warp stack (csrc/sctree_traverse.cu)


def bind(fn):
    """Give a library's ``pine_sctree_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("sctree_traverse").pine_sctree_traverse)


def sctree_cuda(tid, rows, sct, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/sctree_traverse.cu on the current stream."""
    check_stack(sct["depth"], STACK_DEPTH, f"supercell tree of depth {sct['depth']}")
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    n_super, n_nodes = sct["n_super"], sct["boxes"].shape[0]
    if rows.shape[0] < sct["n_prims"]:
        raise ValueError(f"rows: {rows.shape[0]} rows for {sct['n_prims']} prims")
    _check(rows, f32, (rows.shape[0], S.PARAM_WIDTH[tid]), dev, "rows")
    _aligned(rows, "rows")
    for k, shape in (("sc_boxes", (n_super, 6)), ("cell_boxes", (n_super * (SUPER // CELL), 6)),
                     ("boxes", (n_nodes, 2, 6))):
        _check(sct[k], f32, shape, dev, k)
    for k in ("cnode", "cstart", "ccount"):
        _check(sct[k], i32, (n_nodes, 2), dev, k)
    _check(sct["sc_order"], i32, (n_super + TREE_LEAF,), dev, "sc_order")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), STACK_DEPTH, rows.data_ptr(), sct["n_prims"], n_super,
        sct["sc_boxes"].data_ptr(), sct["cell_boxes"].data_ptr(), sct["boxes"].data_ptr(),
        sct["cnode"].data_ptr(), sct["cstart"].data_ptr(), sct["ccount"].data_ptr(),
        sct["sc_order"].data_ptr(), ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(),
        tmax.data_ptr(), best_t.data_ptr(), best_e.data_ptr(), out_t.data_ptr(),
        out_e.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sctree_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["sctree.any_hit" if any_hit else "sctree.closest"] += 1
    return out_t, out_e
