"""BVH traversal of one prim group: host tables and the kernel wrapper.

Counterpart of pine_tpu/accel/pallas_traverse.py's BVH kernel
(``_make_bvh_kernel``, the kind "bvh" body of ``_compiled_call``, with the
node arrays of ``_group_smem_arrays``; here csrc/bvh_traverse.cu through
``bvh_cuda``).  ``pine_tpu`` runs it for a "bvh"-kind group (one of more than
DENSE_MAX prims, in SAH leaf order) when it is forced, and the port also for
every group over GRID_MAX_PRIMS_HBM prims, which ``pine_tpu`` leaves to its
XLA packet walk.  The tables (``bvh_layout``, uploaded once): ``nodes``
float32 (M, 16), the group's SAH node arrays from the C++ builder packed by
``pack_nodes``, one 64-byte record per node: its two child boxes (lo xyz,
hi xyz each), then one link per child, the child node (>= 0) or, for a
leaf child whose rows are ``start .. start + count`` (count at most
LEAF_MAX), ``~(start * 8 + count)`` (< 0), held as int32 bits, and two pad
words; ``depth``, the tree's node levels; ``n_prims`` and the leaf-order
``prim_aabbs``, kept on the host for the plain version.  ``unpack_nodes``
gives the node arrays back.  Each ray walks the tree from the root: a
node's two child boxes against (tmin, running best) (any-hit: (tmin,
tmax)), the nearer child reached next and the other pushed, a leaf's rows
tested (csrc/bvh_traverse.cu says in which order).  The contract is
``dense_traverse.group_query``'s; exact ties in t go to the lowest row
whatever the visit order.

The kernel sizes each ray's stack to the tree's depth at the launch (the
walk needs fewer entries), up to STACK_DEPTH: the wrapper refuses a deeper
tree (``pine_tpu``'s 48-entry stack drops pushes past 46 without a word),
and a group whose rows a leaf link cannot address (more than
LEAF_ROWS_MAX).

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

from pine_tpu_torch.accel.dense_traverse import (
    LAUNCHES, _aligned, _check, check_stack, padded_width,
)
from pine_tpu_torch.accel.sctree import tree_depth

STACK_DEPTH = 64  # the deepest tree the kernel's per-ray stack takes (csrc/bvh_traverse.cu)
NODE_WORDS = 16  # a node record: 12 box floats, 2 links, 2 pad words
NODE_DATA_WORDS = 12 + 2  # the words of a record the walk reads: boxes and links
COUNT_BITS = 3  # a leaf link's count field (LEAF_MAX = 4 rows)
LEAF_ROWS_MAX = 1 << (31 - COUNT_BITS)  # rows a leaf link can address


def check_rows(n_prims):
    """Refuse a group whose rows a leaf link cannot address."""
    if n_prims > LEAF_ROWS_MAX:
        raise NotImplementedError(
            f"a BVH leaf link holds rows below {LEAF_ROWS_MAX}; this group has {n_prims}")


def pack_nodes(nodes, n_prims):
    """The (M, 16) float32 node records (module docstring) of a group's SAH
    node arrays (``c_lower``, ``c_upper`` (M, 2, 3), ``c_node``, ``c_start``,
    ``c_count`` (M, 2), as accel/bvh.sah_arrays returns them) over
    ``n_prims`` rows; refuses a group whose leaves the links cannot hold."""
    check_rows(n_prims)
    cnode = np.asarray(nodes["c_node"], np.int64).reshape(-1, 2)
    cstart = np.asarray(nodes["c_start"], np.int64).reshape(-1, 2)
    ccount = np.asarray(nodes["c_count"], np.int64).reshape(-1, 2)
    leaf = cnode < 0
    if (leaf & (ccount >> COUNT_BITS != 0)).any():
        raise NotImplementedError(f"a BVH leaf link holds counts below {1 << COUNT_BITS}")
    rec = np.zeros((len(cnode), NODE_WORDS), np.float32)
    rec[:, :12] = np.concatenate([np.asarray(nodes["c_lower"], np.float32).reshape(-1, 2, 3),
                                  np.asarray(nodes["c_upper"], np.float32).reshape(-1, 2, 3)],
                                 -1).reshape(-1, 12)
    rec.view(np.int32)[:, 12:14] = np.where(leaf, ~((cstart << COUNT_BITS) | ccount), cnode)
    return rec


def unpack_nodes(rec):
    """The node arrays of (M, 16) node records, as torch tensors on their
    device: ``boxes`` (M, 2, 6) float32, ``cnode``, ``cstart``, ``ccount``
    (M, 2) int32 (the builder's convention: -1 for a leaf child, 0, 0 for an
    inner child's first row and count)."""
    link = rec.view(torch.int32)[:, 12:14]
    leaf = link < 0
    v = ~link
    zero = torch.zeros_like(link)
    return dict(boxes=rec[:, :12].reshape(-1, 2, 6),
                cnode=torch.where(leaf, -1, link),
                cstart=torch.where(leaf, v >> COUNT_BITS, zero),
                ccount=torch.where(leaf, v & ((1 << COUNT_BITS) - 1), zero))


def bvh_layout(nodes, prim_aabbs, device):
    """The walk's tables on ``device`` from a group's SAH node arrays (as
    ``pack_nodes`` takes them) and its leaf-order prim boxes (see module
    docstring)."""
    return dict(n_prims=len(prim_aabbs), prim_aabbs=prim_aabbs,
                depth=tree_depth(np.asarray(nodes["c_node"]).reshape(-1, 2)),
                nodes=torch.as_tensor(pack_nodes(nodes, len(prim_aabbs)), device=device))


def bind(fn):
    """Give a library's ``pine_bvh_traverse`` its C signature."""
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _library():
    from pine_tpu_torch import cuda_build

    return bind(cuda_build.load("bvh_traverse").pine_bvh_traverse)


def bvh_cuda(tid, rows, bvh, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """Launch csrc/bvh_traverse.cu on the current stream, over ``rows``
    padded as ``dense_traverse.dense_rows`` pads a group's."""
    check_stack(bvh["depth"], STACK_DEPTH, f"BVH of depth {bvh['depth']}")
    check_rows(bvh["n_prims"])
    n = ro.shape[0]
    dev = ro.device
    f32, i32 = torch.float32, torch.int32
    if rows.shape[0] < bvh["n_prims"]:
        raise ValueError(f"rows: {rows.shape[0]} rows for {bvh['n_prims']} prims")
    _check(rows, f32, (rows.shape[0], padded_width(tid)), dev, "rows")
    _aligned(rows, "rows")
    _check(bvh["nodes"], f32, (bvh["nodes"].shape[0], NODE_WORDS), dev, "nodes")
    _aligned(bvh["nodes"], "nodes")
    for x, name in ((ro, "ro"), (rd, "rd")):
        _check(x, f32, (n, 3), dev, name)
    for x, name in ((tmin, "tmin"), (tmax, "tmax"), (best_t, "best_t")):
        _check(x, f32, (n,), dev, name)
    _check(best_e, i32, (n,), dev, "best_e")
    out_t = torch.empty(n, dtype=f32, device=dev)
    out_e = torch.empty(n, dtype=i32, device=dev)
    err = _library()(
        tid, int(any_hit), bvh["depth"], bvh["nodes"].data_ptr(), rows.data_ptr(),
        rows.shape[1], ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        best_t.data_ptr(), best_e.data_ptr(), out_t.data_ptr(), out_e.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed: CUDA error {err}")
    LAUNCHES["bvh.any_hit" if any_hit else "bvh.closest"] += 1
    return out_t, out_e
