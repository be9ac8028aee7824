"""Host-side binned-SAH BVH builders.

Counterpart of pine_tpu/accel/bvh.py (``_build_sah``, the numpy builder) and
pine_tpu/accel/unified.py (``sah_arrays``).  ``sah_arrays`` runs the C++
builder (csrc/bvh_builder.cpp through accel/native_build.py), as pine_tpu
does when its native library is built; groups over DENSE_MAX prims take its
leaf order.  ``_build_sah`` is kept as the reference the C++ builder's
algorithm follows (its leaf order differs in ties and bucket edges).
"""
from __future__ import annotations

import sys

import numpy as np

from pine_tpu_torch.accel.native_build import build_sah_native

LEAF_MAX = 4
N_BUCKETS = 16


def _surface_area(a, b):
    e = np.maximum(b - a, 0)
    return 2 * (e[0] * e[1]) + 2 * (e[0] * e[2] + e[1] * e[2])


def _build_sah(lo, hi, centroid):
    """Binned-SAH top-down build -> (prim order, node list)."""
    n = len(lo)
    order = []
    nodes = []

    def leaf_desc(ids):
        start = len(order)
        order.extend(ids.tolist())
        return dict(start=start, count=len(ids))

    def node_aabb(ids):
        return lo[ids].min(0), hi[ids].max(0)

    def split(ids):
        """-> (left_ids, right_ids), or None for a leaf."""
        if len(ids) <= LEAF_MAX:
            return None
        c = centroid[ids]
        cmin, cmax = c.min(0), c.max(0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            half = len(ids) // 2
            return ids[:half], ids[half:]
        t = (c[:, axis] - cmin[axis]) / ext[axis]
        bucket = np.minimum((t * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
        costs = np.full(N_BUCKETS - 1, np.inf)
        for b in range(N_BUCKETS - 1):
            left = bucket <= b
            nl = left.sum()
            nr = len(ids) - nl
            if nl == 0 or nr == 0:
                continue
            llo, lhi = lo[ids[left]].min(0), hi[ids[left]].max(0)
            rlo, rhi = lo[ids[~left]].min(0), hi[ids[~left]].max(0)
            costs[b] = _surface_area(llo, lhi) * nl + _surface_area(rlo, rhi) * nr
        b = int(np.argmin(costs))
        if not np.isfinite(costs[b]):
            half = len(ids) // 2
            ordered = ids[np.argsort(c[:, axis])]
            return ordered[:half], ordered[half:]
        left = bucket <= b
        return ids[left], ids[~left]

    def recurse(ids):
        me = len(nodes)
        nodes.append(None)
        desc = dict(lower=[None, None], upper=[None, None], is_leaf=[False, False],
                    start=[0, 0], count=[0, 0], child=[0, 0])
        for k, part in enumerate(split(ids)):
            desc["lower"][k], desc["upper"][k] = node_aabb(part)
            if len(part) <= LEAF_MAX or split(part) is None:
                d = leaf_desc(part)
                desc["is_leaf"][k] = True
                desc["start"][k] = d["start"]
                desc["count"][k] = d["count"]
            else:
                desc["child"][k] = recurse(part)
        nodes[me] = desc
        return me

    idx = np.arange(n)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        if n <= LEAF_MAX:
            d = leaf_desc(idx)
            l, u = node_aabb(idx)
            nodes.append(dict(lower=[l, l], upper=[u, u], is_leaf=[True, True],
                              start=[d["start"], 0], count=[d["count"], 0], child=[0, 0]))
        else:
            recurse(idx)
    finally:
        sys.setrecursionlimit(old_limit)
    return order, nodes


def sah_arrays(lo, hi):
    """SAH build -> (order, c_lower, c_upper, c_node, c_start, c_count)."""
    return build_sah_native(lo, hi)
