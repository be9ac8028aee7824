"""Supercell tree of a prim group: host tables for a SAH walk over supercells.

Counterpart of pine_tpu/accel/pallas_traverse.py::_sc_tree_layout and
``_tree_depth``.  The group's prims, in SAH leaf order, are cut into
128-prim supercells and 32-prim cells (as the grid traversal cuts them); a
second SAH tree, built by the C++ builder over the supercell boxes, orders
the supercells.  A walk descends that tree near-first, gates each supercell
of a leaf it reaches by its box, then each of its four cells, and tests the
prims of the cells that pass.  Both kernels that walk it do so a warp at a
time (csrc/tree_walk.cuh): the supercell-tree kernel
(accel/sctree_traverse.py, csrc/sctree_traverse.cu) over a group, the
two-level instanced kernel (accel/inst_traverse.py,
csrc/inst_traverse.cu) over the shared mesh of an instanced group in each
instance's frame.

Tables (``sc_tree_layout``), all uploaded once at compile():

- ``sc_boxes`` float32 (n_super, 6) and ``cell_boxes`` (n_super * 4, 6):
  lo xyz, hi xyz of each supercell and each cell; cells past the last prim
  are the empty box (1,1,1,-1,-1,-1);
- ``boxes`` float32 (M, 2, 6): each tree node's two child boxes;
  ``cnode`` int32 (M, 2): the child node, or -1 for a leaf child, whose
  supercells are ``sc_order[cstart : cstart + ccount]``;
- ``sc_order`` int32 (n_super + TREE_LEAF,): the supercells in tree-leaf
  order, then TREE_LEAF zero pad entries (as pine_tpu pads it);
- ``depth``: the tree's node levels (the root alone is depth 1); the walk
  needs at most that many stack entries.
"""
from __future__ import annotations

import numpy as np

from pine_tpu_torch.accel.bvh import LEAF_MAX, sah_arrays
from pine_tpu_torch.accel.grid_traverse import CELL, SUPER, _boxes

TREE_LEAF = LEAF_MAX  # supercells per tree leaf


def tree_depth(cnode):
    """Node levels of a (M, 2) child-index tree (< 0: a leaf child)."""
    cnode = np.asarray(cnode).reshape(-1, 2)
    depth, frontier = 0, np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        frontier = cnode[frontier].ravel()
        frontier = frontier[frontier >= 0]
    return depth


def sc_tree_layout(prim_aabbs):
    """The supercell tree of a group from its (E, 6) leaf-order prim boxes
    (see module docstring)."""
    boxes = np.asarray(prim_aabbs, np.float32)
    E = len(boxes)
    n_super = (E + SUPER - 1) // SUPER
    sb = _boxes(boxes, SUPER, n_super)
    order, c_lower, c_upper, c_node, c_start, c_count = sah_arrays(sb[:, 0:3], sb[:, 3:6])
    return dict(
        n_prims=E, n_super=n_super, sc_boxes=sb,
        cell_boxes=_boxes(boxes, CELL, n_super * (SUPER // CELL)),
        boxes=np.concatenate([c_lower, c_upper], axis=-1).astype(np.float32),
        cnode=np.asarray(c_node, np.int32), cstart=np.asarray(c_start, np.int32),
        ccount=np.asarray(c_count, np.int32),
        sc_order=np.concatenate([np.asarray(order, np.int32), np.zeros(TREE_LEAF, np.int32)]),
        depth=tree_depth(c_node),
    )
