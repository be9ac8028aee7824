"""Adaptive path-guiding structures: a spatial octree of directional
quadtrees.  Counterpart of pine_tpu/integrators/guiding_tree.py (parity:
impl/integrator/spatial_tree.h:30-355, guidedpath.cpp:70-115).

- The host owns the trees (``GuidingTree``, numpy and Python objects, a copy
  of pine_tpu's): spatial leaves split at n_samples > threshold, quadtrees
  subdivide quadrants holding more than FLUX_SUBDIV of their tree's flux up
  to depth MAX_DDEPTH, the refined collector is snapshotted as the next
  iteration's frozen guide and then halved (the reference's moving
  average).
- The device reads them as flat int arenas (``schild``, ``dchild``: index
  of the first of 8 / 4 consecutive children, 0 for a leaf), exported level
  by level with power-of-two capacities, so the arrays compare whole with
  pine_tpu's.
- The lookups walk the arenas with gathers.  ``_export`` records both
  trees' depths (``arena_depths``), and each walk runs exactly that many
  levels (a lane at a leaf is held in place, so a longer walk, pine_tpu's
  fixed trip counts, gives the same result).
- The collector's sums (``dtree_add``) are made in float64 and rounded to
  float32, so that neither the order of the card's atomic adds nor the
  CPU's lane order shows in them (the rounded sum differs only where the
  exact sum lies within a float64 rounding of a float32 boundary).
"""
from __future__ import annotations

import numpy as np
import torch

MAX_DDEPTH = 16  # quadtree depth cap (spatial_tree.h:134 `depth < 16`)
MAX_SDEPTH = 20  # octree descent cap (8^20 leaves is far past any split)
FLUX_SUBDIV = 0.01  # subdivide quadrants holding >1% of total flux
_EPS = 1e-12
_ONE_MINUS = 1.0 - 1e-6
TREE_KEYS = ("schild", "sdroot", "dchild", "dflux", "dcoll", "scount")


# ---------------------------------------------------------------------------
# host-side tree (numpy): topology + refinement + arena export
# ---------------------------------------------------------------------------


class _QNode:
    __slots__ = ("flux", "children", "idx")

    def __init__(self, flux=0.0):
        self.flux = float(flux)
        self.children = None  # None | [_QNode x4]
        self.idx = 0  # arena index (assigned at export)


class _SNode:
    __slots__ = ("n_samples", "children", "collector", "guide", "idx")

    def __init__(self):
        self.n_samples = 0.0
        self.children = None  # None | [_SNode x8]
        self.collector = None  # _QNode root (leaves only)
        self.guide = None  # frozen _QNode snapshot (leaves only)
        self.idx = 0


def _qcopy(node):
    c = _QNode(node.flux)
    if node.children is not None:
        c.children = [_qcopy(k) for k in node.children]
    return c


def _qrefine(node, total, depth=0):
    """spatial_tree.h QuadNode::refine: subdivide heavy quadrants, collapse
    light ones."""
    if node.flux > total * FLUX_SUBDIV and depth < MAX_DDEPTH:
        if node.children is None:
            node.children = [_QNode(node.flux / 4) for _ in range(4)]
        for k in node.children:
            _qrefine(k, total, depth + 1)
    else:
        node.children = None


def _qhalve(node):
    node.flux /= 2
    if node.children is not None:
        for k in node.children:
            _qhalve(k)


class GuidingTree:
    """Host owner of the adaptive structures; the device reads them flat.

    Per training iteration:
        gstate = tree.device_state(device)
        ... the iteration adds into gstate["dcoll"] and gstate["scount"] ...
        tree.absorb(dcoll, scount)
        tree.refine(threshold)
    """

    def __init__(self, lo, hi, n_initial_samples, spatial_k=4000):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        diag = np.maximum(hi - lo, 1e-6)
        self.lo = lo - 1e-4
        self.inv_diag = (1.0 / (diag + 2e-4)).astype(np.float32)
        self.tight_lo, self.tight_hi = lo, hi  # add_sample jitter clamp
        # root footprint = smallest AABB extent (spatial_tree.h:325)
        self.footprint0 = float(diag.min())
        self.spatial_k = int(spatial_k)
        self.root = _SNode()
        self.root.collector = _QNode(1.0)  # prepare_for_initial_refine
        self.root.n_samples = float(n_initial_samples)
        self._refine_node(self.root, float(spatial_k))
        self._export()

    # -- refinement ---------------------------------------------------------

    def _refine_node(self, node, threshold):
        if node.children is None:
            if node.n_samples > threshold:
                node.children = [_SNode() for _ in range(8)]
                for k in node.children:
                    k.collector = _qcopy(node.collector)
                    k.n_samples = node.n_samples / 8
                    self._refine_node(k, threshold)
                node.collector = node.guide = None
            else:
                total = max(node.collector.flux, _EPS)
                _qrefine(node.collector, total)
                node.guide = _qcopy(node.collector)
                _qhalve(node.collector)
        else:
            for k in node.children:
                self._refine_node(k, threshold)
        node.n_samples = 0.0

    def refine(self, threshold):
        self._refine_node(self.root, float(threshold))
        self._export()

    # -- device <-> host ----------------------------------------------------

    def absorb(self, dcoll, scount):
        """Write one iteration's accumulation back into the host trees
        (dcoll: (T,) collector flux; scount: (S,) per-leaf sample counts)."""
        dcoll = np.asarray(dcoll)
        scount = np.asarray(scount)
        for q in self._qnodes:
            q.flux = float(dcoll[q.idx])
        for s in self._sleaves:
            s.n_samples += float(scount[s.idx])

    def arrays(self):
        """The flat arenas as numpy arrays (TREE_KEYS) and both trees' depths
        (``sdepth``, ``ddepth``)."""
        return dict(self._arrays, sdepth=self.sdepth, ddepth=self.ddepth)

    def device_state(self, device):
        """The arenas as tensors on ``device`` (convert.guide_state)."""
        from pine_tpu_torch.convert import guide_state

        return guide_state(self.arrays(), device)

    def _export(self):
        # children must be 8 consecutive arena slots: BFS by levels
        snodes = []
        queue = [self.root]
        while queue:
            nxt = []
            for n in queue:
                n.idx = len(snodes)
                snodes.append(n)
            for n in queue:
                if n.children is not None:
                    for k in n.children:
                        nxt.append(k)
            queue = nxt
        sleaves = [n for n in snodes if n.children is None]

        qnodes = [_QNode(0.0)]  # arena slot 0 reserved (0 == leaf sentinel)
        for leaf in sleaves:
            queue = [leaf.collector]
            while queue:
                nxt = []
                for q in queue:
                    q.idx = len(qnodes)
                    qnodes.append(q)
                for q in queue:
                    if q.children is not None:
                        nxt.extend(q.children)
                queue = nxt
        # guide snapshots share the collector topology: flux by parallel walk
        gflux = np.zeros(len(qnodes), np.float32)
        for leaf in sleaves:
            stack = [(leaf.collector, leaf.guide)]
            while stack:
                c, g = stack.pop()
                gflux[c.idx] = g.flux
                if c.children is not None:
                    stack.extend(zip(c.children, g.children))

        def cap(n, lo_cap=1024):
            c = lo_cap
            while c < n:
                c *= 2
            return c

        S, T = cap(len(snodes)), cap(len(qnodes))
        s_child = np.zeros(S, np.int32)
        s_droot = np.zeros(S, np.int32)
        cflux = np.zeros(T, np.float32)
        d_child = np.zeros(T, np.int32)
        for n in snodes:
            if n.children is not None:
                s_child[n.idx] = n.children[0].idx
            else:
                s_droot[n.idx] = n.collector.idx
        for q in qnodes:
            cflux[q.idx] = q.flux
            if q.children is not None:
                d_child[q.idx] = q.children[0].idx
        self._snodes, self._sleaves, self._qnodes = snodes, sleaves, qnodes[1:]
        self._arrays = dict(
            schild=s_child,
            sdroot=s_droot,
            dchild=d_child,
            dflux=_padto(gflux, T),
            dcoll=cflux,
            scount=np.zeros(S, np.float32),
        )
        self.sdepth, self.ddepth = arena_depths(s_child, s_droot, d_child)

    # -- introspection (tests) ----------------------------------------------

    def n_spatial_leaves(self):
        return len(self._sleaves)

    def n_quadtree_nodes(self):
        return len(self._qnodes)

    def host_lookup(self, p):
        """Pure-host octree descent (test oracle for the device loop)."""
        rel = np.clip((np.asarray(p, np.float32) - self.lo) * self.inv_diag,
                      0.0, _ONE_MINUS)
        node = self.root
        while node.children is not None:
            oct_i = 0
            q = np.empty(3, np.float32)
            for a in range(3):
                if rel[a] < 0.5:
                    q[a] = rel[a] * 2
                else:
                    q[a] = (rel[a] - 0.5) * 2
                    oct_i += 1 << a
            node = node.children[oct_i]
            rel = q
        return node.idx


def _padto(a, n):
    out = np.zeros(n, a.dtype)
    out[: len(a)] = a
    return out


def arena_depths(schild, sdroot, dchild):
    """(levels below the octree's root to its deepest leaf, the same for the
    deepest quadtree) of flat arenas, walked level by level from the roots."""
    schild, sdroot, dchild = (np.asarray(a) for a in (schild, sdroot, dchild))
    level, sdepth, leaves = np.zeros(1, np.int64), 0, []
    while True:
        c0 = schild[level]
        leaves.append(level[c0 == 0])
        level = (c0[c0 != 0][:, None] + np.arange(8)).ravel()
        if not level.size:
            break
        sdepth += 1
    level, ddepth = sdroot[np.concatenate(leaves)].astype(np.int64), 0
    while True:
        c0 = dchild[level]
        level = (c0[c0 != 0][:, None] + np.arange(4)).ravel()
        if not level.size:
            return sdepth, ddepth
        ddepth += 1


# ---------------------------------------------------------------------------
# device-side descents (tensors on the lanes' device)
# ---------------------------------------------------------------------------


def stree_lookup(schild, sdroot, lo, inv_diag, footprint0, p, levels=MAX_SDEPTH):
    """Per-lane octree descent -> (dtree root index, leaf index, footprint),
    the indices int64.  Each level halves the unit cube on all three axes
    (child bit i set where p[i] >= 0.5; spatial_tree.h SpatialNode::traverse),
    ``levels`` of them (at most MAX_SDEPTH)."""
    n = p.shape[0]
    rel = torch.clamp((p - lo) * inv_diag, 0.0, _ONE_MINUS)
    node = torch.zeros(n, dtype=torch.int64, device=p.device)
    foot = torch.full((n,), footprint0, dtype=torch.float32, device=p.device)
    for _ in range(min(levels, MAX_SDEPTH)):
        c0 = schild[node]
        leaf = c0 == 0
        hi = rel >= 0.5
        oct_i = hi[:, 0] + 2 * hi[:, 1].long() + 4 * hi[:, 2].long()
        node = torch.where(leaf, node, c0 + oct_i)
        rel = torch.where(leaf[:, None], rel, 2.0 * rel - hi.float())
        foot = torch.where(leaf, foot, 0.5 * foot)
    return sdroot[node], node, foot


def dtree_sample(dchild, dflux, root, u2, levels=MAX_DDEPTH):
    """Hierarchical sample warp (spatial_tree.h QuadNode::sample): descend by
    child-flux conditionals, remapping u, then place uniformly in the leaf
    square, ``levels`` levels (at most MAX_DDEPTH).  -> (square coords (N,2),
    pdf over the unit square, valid).  The caller maps square -> sphere
    (equal-area), dividing the pdf by 4 pi."""
    n, dev = root.shape[0], root.device
    u0, u1 = u2[:, 0], u2[:, 1]
    px = torch.zeros(n, device=dev)
    py = torch.zeros(n, device=dev)
    length = torch.ones(n, device=dev)
    pdf = torch.ones(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    invalid = torch.zeros(n, dtype=torch.bool, device=dev)
    node = root
    for _ in range(min(levels, MAX_DDEPTH)):
        c0 = dchild[node]
        leaf = c0 == 0
        f0, f1, f2, f3 = (dflux[c0 + k] for k in range(4))
        ftot = f0 + f1 + f2 + f3
        step = ~done & ~leaf
        zero = ftot <= 0.0
        invalid = invalid | (step & zero)
        fl = f0 + f2  # left column (children 0,2: sc.x < 0.5)
        rx = fl / torch.clamp_min(ftot, _EPS)
        gox = u0 >= rx
        px_prob = torch.where(gox, 1.0 - rx, rx)
        u0n = torch.clamp(torch.where(gox, (u0 - rx) / torch.clamp_min(1.0 - rx, _EPS),
                                      u0 / torch.clamp_min(rx, _EPS)), 0.0, _ONE_MINUS)
        fy0 = torch.where(gox, f1, f0)
        fyt = torch.where(gox, ftot - fl, fl)
        ry = fy0 / torch.clamp_min(fyt, _EPS)
        goy = u1 >= ry
        py_prob = torch.where(goy, 1.0 - ry, ry)
        u1n = torch.clamp(torch.where(goy, (u1 - ry) / torch.clamp_min(1.0 - ry, _EPS),
                                      u1 / torch.clamp_min(ry, _EPS)), 0.0, _ONE_MINUS)
        quad = gox.long() + 2 * goy.long()
        adv = step & ~zero
        node = torch.where(adv, c0 + quad, node)
        px = torch.where(adv & gox, px + 0.5 * length, px)
        py = torch.where(adv & goy, py + 0.5 * length, py)
        pdf = torch.where(adv, pdf * 4.0 * px_prob * py_prob, pdf)
        length = torch.where(adv, 0.5 * length, length)
        u0 = torch.where(adv, u0n, u0)
        u1 = torch.where(adv, u1n, u1)
        done = done | leaf | zero
    sq = torch.stack([px + u0 * length, py + u1 * length], -1)
    return sq, torch.where(invalid, 0.0, pdf), ~invalid


def _quadrant(sq):
    """-> (the quadrant of each square coordinate, the offsets (N,2) that map
    it into its quadrant's square as 2 sq - off)."""
    hi = sq >= 0.5
    return hi[:, 0].long() + 2 * hi[:, 1].long(), hi.float()


def dtree_pdf(dchild, dflux, root, sq, levels=MAX_DDEPTH):
    """pdf of the square coordinate under the tree distribution (QuadNode::pdf
    without the 1/(4 pi) sphere factor: the caller applies it), ``levels``
    levels (at most MAX_DDEPTH)."""
    pdf = torch.ones(root.shape[0], device=root.device)
    done = torch.zeros(root.shape[0], dtype=torch.bool, device=root.device)
    node = root
    for _ in range(min(levels, MAX_DDEPTH)):
        c0 = dchild[node]
        leaf = c0 == 0
        quad, off = _quadrant(sq)
        f0, f1, f2, f3 = (dflux[c0 + k] for k in range(4))
        ftot = f0 + f1 + f2 + f3
        fq = dflux[c0 + quad]
        step = ~done & ~leaf
        ratio = torch.where(ftot > 0.0, 4.0 * fq / torch.clamp_min(ftot, _EPS), 0.0)
        pdf = torch.where(step, pdf * ratio, pdf)
        node = torch.where(step, c0 + quad, node)
        sq = torch.where(step[:, None], 2.0 * sq - off, sq)
        done = done | leaf
    return pdf


def dtree_add(dcoll, dchild, root, sq, flux, mask, levels=MAX_DDEPTH):
    """``dcoll`` with ``flux`` added into every node on the root-to-leaf path
    of sq where ``mask`` (the unfiltered spatial_tree.h
    QuadNode::add_sample(sc, flux)), ``levels`` + 1 nodes deep at most, the
    sums by ``scatter_sum``."""
    val = torch.where(mask, flux, 0.0)
    active = mask & (val != 0.0)
    idx, keep = [], []
    node = root
    for _ in range(min(levels, MAX_DDEPTH) + 1):
        idx.append(node)
        keep.append(active)
        c0 = dchild[node]
        quad, off = _quadrant(sq)
        step = active & (c0 != 0)
        node = torch.where(step, c0 + quad, node)
        sq = torch.where(step[:, None], 2.0 * sq - off, sq)
        active = step
    return scatter_sum(dcoll, torch.stack(idx), val.expand(len(idx), -1), torch.stack(keep))


def scatter_sum(target, idx, val, keep):
    """``target`` (T,) float32 plus the sums of ``val`` at ``idx`` where
    ``keep`` (each (N,) or (levels, N)), made in float64 and rounded to
    float32 (module docstring).  A lane that adds nothing adds into a slot
    of its own past the target, so that no address takes the adds of every
    idle lane."""
    n, T = idx.shape[-1], target.shape[0]
    spare = T + torch.arange(n, device=idx.device)
    sums = torch.zeros(T + n, dtype=torch.float64, device=target.device)
    sums.index_add_(0, torch.where(keep, idx, spare).reshape(-1), val.double().reshape(-1))
    return (target.double() + sums[:T]).to(torch.float32)
