"""BVH traversal of one prim group: host tables and the kernel wrapper.

Counterpart of pine_tpu/accel/pallas_traverse.py's BVH kernel
(``_make_bvh_kernel``, the kind "bvh" body of ``_compiled_call``, with the
node arrays of ``_group_smem_arrays``; here csrc/bvh_traverse.cu through
``bvh_cuda``).  ``pine_tpu`` runs it for a "bvh"-kind group (one of more than
DENSE_MAX prims, in SAH leaf order) when it is forced, and the port also for
every group over GRID_MAX_PRIMS_HBM prims, which ``pine_tpu`` leaves to its
XLA packet walk.  The tables (``bvh_layout``, uploaded once) are the group's
SAH node arrays from the C++ builder: ``boxes`` float32 (M, 2, 6), each
node's two child boxes, lo xyz and hi xyz; ``cnode`` int32 (M, 2), the child
node or < 0 for a leaf child, whose rows are ``cstart .. cstart + ccount``
(at most LEAF_MAX); ``depth``, the tree's node levels; ``n_prims`` and the
leaf-order ``prim_aabbs``, kept on the host for the plain version.  Each
ray walks the tree from the root: a node's two child boxes against (tmin,
running best) (any-hit: (tmin, tmax)), its leaf children's rows, the nearer
leaf first, its inner children pushed far first.  The contract is
``dense_traverse.group_query``'s; exact ties in t go to the lowest row
whatever the visit order.

The kernel's stack holds STACK_DEPTH entries and the walk needs at most the
tree's depth of them: the wrapper refuses a deeper tree (``pine_tpu``'s
48-entry stack drops pushes past 46 without a word).

The plain version is ``grid_traverse.supercell_plain``, which computes the
same function with a row-order sweep culled by the group's 128-prim
supercell and 32-prim cell boxes, built from ``prim_aabbs`` when it runs.
Apart from the lanes below, the two can differ only on a rare lane where a
cull decides at a box face, as the grid kernel and ``grid_plain`` can.

A closest-hit lane whose window ends above the miss sentinel BIG and that
hits nothing (a render's windows end at FLT_MAX) gets BIG and the id of a
prim it tested; the two test different prims, so such lanes may differ in
that id (or keep their incoming state in one of them), and every caller
reads them as misses.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pine_tpu_torch.accel.dense_traverse import LAUNCHES, _check, check_stack
from pine_tpu_torch.accel.sctree import tree_depth
from pine_tpu_torch.scene import shapes as S

STACK_DEPTH = 64  # entries of the kernel's per-ray stack (csrc/bvh_traverse.cu)


def bvh_layout(nodes, prim_aabbs, device):
    """The walk's tables on ``device`` from a group's SAH node arrays
    (``c_lower``, ``c_upper`` (M, 2, 3), ``c_node``, ``c_start``, ``c_count``
    (M, 2), as accel/bvh.sah_arrays returns them) and its leaf-order prim
    boxes (see module docstring)."""
    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    cnode = np.asarray(nodes["c_node"], np.int32).reshape(-1, 2)
    return dict(
        n_prims=len(prim_aabbs), prim_aabbs=prim_aabbs, depth=tree_depth(cnode),
        boxes=t(np.concatenate([np.asarray(nodes["c_lower"], np.float32).reshape(-1, 2, 3),
                                np.asarray(nodes["c_upper"], np.float32).reshape(-1, 2, 3)], -1),
                torch.float32),
        cnode=t(cnode, torch.int32),
        cstart=t(np.asarray(nodes["c_start"], np.int32).reshape(-1, 2), torch.int32),
        ccount=t(np.asarray(nodes["c_count"], np.int32).reshape(-1, 2), torch.int32),
    )


def _library():
    from pine_tpu_torch import cuda_build

    fn = cuda_build.load("bvh_traverse").pine_bvh_traverse
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 13
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bvh_cuda(tid, rows, bvh, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/bvh_traverse.cu on the current stream."""
    check_stack(bvh["depth"], STACK_DEPTH, f"BVH of depth {bvh['depth']}")
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    n_nodes = bvh["boxes"].shape[0]
    if rows.shape[0] < bvh["n_prims"]:
        raise ValueError(f"rows: {rows.shape[0]} rows for {bvh['n_prims']} prims")
    _check(rows, f32, (rows.shape[0], S.PARAM_WIDTH[tid]), dev, "rows")
    _check(bvh["boxes"], f32, (n_nodes, 2, 6), dev, "boxes")
    for k in ("cnode", "cstart", "ccount"):
        _check(bvh[k], i32, (n_nodes, 2), dev, k)
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), STACK_DEPTH, rows.data_ptr(), bvh["boxes"].data_ptr(),
        bvh["cnode"].data_ptr(), bvh["cstart"].data_ptr(), bvh["ccount"].data_ptr(),
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), best_t.data_ptr(),
        best_e.data_ptr(), out_t.data_ptr(), out_e.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["bvh.any_hit" if any_hit else "bvh.closest"] += 1
    return out_t, out_e
