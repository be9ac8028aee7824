"""The guiding structures against pine_tpu, function by function (no render).

1. ``GuidingTree``'s arenas (schild, sdroot, dchild, dflux, dcoll, scount)
   bit for bit pine_tpu's after construction, and after rounds of
   ``absorb`` + ``refine`` from the same seeded collector flux and sample
   counts; the recorded depths (``arena_depths``) those of the host trees.
2. The device walks on 4,096 seeded lanes over a trained tree (295 spatial
   leaves, 99,919 quadtree nodes, depths 3 and 8) carried across by
   ``convert.guide_state``: ``stree_lookup``'s node ids exactly and its
   footprints bit for bit; ``dtree_sample``'s squares, pdfs and validity
   and ``dtree_pdf`` bit for bit (both packages evaluate the same float32
   operations in the same order; pine_tpu op by op, under
   ``jax.disable_jit``); ``dtree_add``'s collector to rtol 2e-6: the port
   sums in float64 and rounds once, pine_tpu adds in float32 lane by lane
   (measured: 488 of the 5,952 nodes it changes differ, by 2.5e-7 at
   most).  Each walk with the recorded depths bit for bit the same walk at
   pine_tpu's fixed trip counts.  ``scatter_sum`` bit for bit the same on
   the lanes in another order (the premise of the card's atomic adds).
3. ``dir_to_square``, ``square_to_dir`` and ``dir_bin`` on 4,096 seeded
   directions: squares and directions to 2 ulps of 1 (the port's atan2,
   sin and cos are float64 rounded, XLA's float32 approximations;
   measured: 1 ulp, 95.6 % of the squares bit for bit), bins equal but
   where a square lies within 1e-5 of a bin edge.  ``DirectionalGuide``'s
   ``sample`` and ``pdf`` over seeded histograms (a fifth of the cells
   empty): directions and pdfs to rtol 1e-4 on 99.5 % of lanes (the port's
   marginals and CDFs are float64 sums rounded once, pine_tpu's float32
   sums, so a lane whose u falls within an ulp of a CDF step picks the
   next bin; measured: every lane, directions within 6.4e-6, pdfs 2.8e-7),
   validity equal.
4. ``iterative_scheme`` equal for spp 1-64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.integrators import guidedpath as JG
from pine_tpu.integrators import guiding_tree as JT

from pine_tpu_torch.convert import guide_state
from pine_tpu_torch.integrators import guidedpath as PG
from pine_tpu_torch.integrators import guiding_tree as PT

torch.set_num_threads(2)

N_LANES = 4096
LO, HI = np.float32([-1, 0, -2]), np.float32([3, 2, 1])


def both_trees(n_initial, lo=LO, hi=HI):
    return JT.GuidingTree(lo, hi, n_initial), PT.GuidingTree(lo, hi, n_initial)


def assert_arenas_equal(jt, pt):
    got = pt.arrays()
    for k, want in jt._arrays.items():
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert (pt.n_spatial_leaves(), pt.n_quadtree_nodes()) == (jt.n_spatial_leaves(),
                                                               len(jt._qnodes))


def host_depths(tree):
    """(deepest octree leaf, deepest quadtree node) by walking the host nodes."""
    def sdepth(s):
        return 0 if s.children is None else 1 + max(sdepth(k) for k in s.children)

    def qdepth(q):
        return 0 if q.children is None else 1 + max(qdepth(k) for k in q.children)

    return sdepth(tree.root), max(qdepth(s.collector) for s in tree._sleaves)


def seeded_round(jt, pt, seed, threshold, n=4096):
    """One absorb + refine of the same seeded training into both: ``n``
    samples, each in a random spatial leaf (a tenth of the leaves take half
    of them) at a random square (70 % in one quadrant), its flux added along
    its quadtree path as dtree_add does; every sample counted 40 times."""
    rng = np.random.default_rng(seed)
    a = jt._arrays
    dcoll, scount = a["dcoll"].copy(), np.zeros_like(a["scount"])
    leaves = jt._sleaves
    hot = leaves[: max(len(leaves) // 10, 1)]
    for _ in range(n):
        pool = hot if rng.random() < 0.5 else leaves
        leaf = pool[rng.integers(len(pool))]
        x, y = rng.random(2)
        if rng.random() < 0.7:
            x, y = 0.5 + 0.5 * x, 0.5 * y
        f = np.float32(rng.exponential(1.0))
        q = leaf.collector
        while True:
            dcoll[q.idx] += f
            if q.children is None:
                break
            hx, hy = x >= 0.5, y >= 0.5
            q = q.children[int(hx) + 2 * int(hy)]
            x, y = 2 * x - hx, 2 * y - hy
        scount[leaf.idx] += 40.0
    for tree in (jt, pt):
        tree.absorb(dcoll, scount)
        tree.refine(threshold)


@pytest.mark.parametrize("n_initial, lo, hi", [
    (1000, LO, HI), (640 * 640, np.float32([0, 0, 0]), np.float32([1, 1, 1])),
    (40_000, np.float32([-0.5, 0, 0]), np.float32([0.5, 0.01, 3]))])
def test_arenas_after_construction_are_pine_tpus(n_initial, lo, hi):
    jt, pt = both_trees(n_initial, lo, hi)
    assert_arenas_equal(jt, pt)
    assert (pt.sdepth, pt.ddepth) == host_depths(pt)
    for k in ("lo", "inv_diag", "tight_lo", "tight_hi"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(jt, k))
    assert pt.footprint0 == jt.footprint0


def test_arenas_after_absorb_and_refine_are_pine_tpus():
    jt, pt = both_trees(40_000)
    for seed, threshold in enumerate((10_000.0, 3_000.0, 50_000.0, 1_000.0)):
        seeded_round(jt, pt, seed, threshold)
        assert_arenas_equal(jt, pt)
        assert (pt.sdepth, pt.ddepth) == host_depths(pt)
        assert PT.arena_depths(jt._arrays["schild"], jt._arrays["sdroot"],
                               jt._arrays["dchild"]) == (pt.sdepth, pt.ddepth)
    assert pt.sdepth >= 2 and pt.ddepth >= 4


@pytest.fixture(scope="module")
def trained():
    """pine_tpu's tree after three seeded rounds, its arrays carried to the
    port (guide_state), and 4,096 seeded lanes: points in and around the
    box, direction squares, u2 and collector flux."""
    jt, pt = both_trees(40_000)
    for seed, threshold in enumerate((10_000.0, 3_000.0, 1_000.0)):
        seeded_round(jt, pt, seed, threshold)
    rng = np.random.default_rng(42)
    lanes = dict(p=rng.uniform(LO - 0.2, HI + 0.2, (N_LANES, 3)).astype(np.float32),
                 sq=rng.random((N_LANES, 2)).astype(np.float32),
                 u2=rng.random((N_LANES, 2)).astype(np.float32),
                 flux=(rng.exponential(1.0, N_LANES) * (rng.random(N_LANES) < 0.8)).astype(
                     np.float32),
                 mask=rng.random(N_LANES) < 0.9)
    lanes["sq"][:64] = 0.5  # on the quadrant edges
    return jt, pt, guide_state(jt._arrays, "cpu"), lanes


def t(x):
    return torch.from_numpy(np.array(x))


def test_stree_lookup_matches(trained):
    jt, pt, st, lanes = trained
    with jax.disable_jit():
        want = JT.stree_lookup(jnp.asarray(jt._arrays["schild"]), jnp.asarray(jt._arrays["sdroot"]),
                               jt.lo, jt.inv_diag, jnp.float32(jt.footprint0),
                               jnp.asarray(lanes["p"]))
    args = (st["schild"], st["sdroot"], t(pt.lo), t(pt.inv_diag), pt.footprint0, t(lanes["p"]))
    got = PT.stree_lookup(*args, st["sdepth"])
    full = PT.stree_lookup(*args)
    for g, f, w in zip(got, full, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), f.numpy())
    assert len(np.unique(got[1].numpy())) > 100
    leaves = [jt.host_lookup(q) for q in lanes["p"][:256]]
    np.testing.assert_array_equal(got[1].numpy()[:256], leaves)


def test_dtree_walks_match(trained):
    jt, pt, st, lanes = trained
    ja = {k: jnp.asarray(v) for k, v in jt._arrays.items()}
    with jax.disable_jit():
        droot = JT.stree_lookup(ja["schild"], ja["sdroot"], jt.lo, jt.inv_diag,
                                jnp.float32(jt.footprint0), jnp.asarray(lanes["p"]))[0]
        want_s = JT.dtree_sample(ja["dchild"], ja["dflux"], droot, jnp.asarray(lanes["u2"]))
        want_p = JT.dtree_pdf(ja["dchild"], ja["dflux"], droot, jnp.asarray(lanes["sq"]))
        want_a = JT.dtree_add(ja["dcoll"], ja["dchild"], droot, jnp.asarray(lanes["sq"]),
                              jnp.asarray(lanes["flux"]), jnp.asarray(lanes["mask"]))
    root = t(np.asarray(droot)).long()
    dd = st["ddepth"]
    for levels in (dd, PT.MAX_DDEPTH):
        got_s = PT.dtree_sample(st["dchild"], st["dflux"], root, t(lanes["u2"]), levels)
        for g, w in zip(got_s, want_s):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        got_p = PT.dtree_pdf(st["dchild"], st["dflux"], root, t(lanes["sq"]), levels)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
        got_a = PT.dtree_add(st["dcoll"], st["dchild"], root, t(lanes["sq"]), t(lanes["flux"]),
                             t(lanes["mask"]), levels)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=2e-6, atol=0)
        if levels == dd:
            first = got_a
        else:
            np.testing.assert_array_equal(got_a.numpy(), first.numpy())
    assert bool(np.asarray(want_s[2]).all()) and np.asarray(want_p).std() > 0.1
    assert (got_a.numpy() != st["dcoll"].numpy()).sum() > 1000


def test_scatter_sum_ignores_lane_order(trained):
    _, _, st, lanes = trained
    rng = np.random.default_rng(3)
    idx = t(rng.integers(0, 200, (3, N_LANES)))
    val = t(rng.exponential(1.0, (3, N_LANES)).astype(np.float32))
    keep = t(rng.random((3, N_LANES)) < 0.7)
    want = PT.scatter_sum(st["dcoll"], idx, val, keep)
    perm = torch.from_numpy(rng.permutation(N_LANES))
    got = PT.scatter_sum(st["dcoll"], idx[:, perm], val[:, perm], keep[:, perm])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def directions(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [-1, -1e-7, 0], [-1, 1e-7, 0]]
    return w


def test_square_maps_match():
    w = directions(N_LANES, 7)
    sq = np.random.default_rng(8).random((N_LANES, 2)).astype(np.float32)
    with jax.disable_jit():
        want_sq = np.asarray(JG.dir_to_square(jnp.asarray(w)))
        want_w = np.asarray(JG.square_to_dir(jnp.asarray(sq)))
        want_bin = np.asarray(JG.dir_bin(jnp.asarray(w)))
    got_sq = PG.dir_to_square(t(w)).numpy()
    np.testing.assert_allclose(got_sq, want_sq, rtol=0, atol=2 * np.spacing(np.float32(1)))
    np.testing.assert_allclose(PG.square_to_dir(t(sq)).numpy(), want_w, rtol=0,
                               atol=2 * np.spacing(np.float32(1)))
    got_bin = PG.dir_bin(t(w)).numpy()
    near_edge = (np.abs(want_sq * PG.DIR_RES - np.round(want_sq * PG.DIR_RES)) < 1e-5 *
                 PG.DIR_RES).any(1)
    assert ((got_bin == want_bin) | near_edge).all()
    assert (got_bin == want_bin).mean() > 0.999


def test_directional_guide_matches():
    from pine_tpu.integrators.cachedpath import SpatialGrid as JGrid

    from pine_tpu_torch.integrators.cachedpath import SpatialGrid

    rng = np.random.default_rng(11)
    hist = (rng.exponential(1.0, (N_LANES, 256)) * (rng.random((N_LANES, 256)) < 0.25)).astype(
        np.float32)
    hist[rng.random(N_LANES) < 0.2] = 0.0
    hist[:4, :] = 0.0
    hist[4, 17] = 3.0  # one bin
    u2 = rng.random((N_LANES, 2)).astype(np.float32)
    u_def = rng.random(N_LANES).astype(np.float32)
    w = directions(N_LANES, 12)
    jguide = JG.DirectionalGuide(JGrid(LO, HI, 32))
    pguide = PG.DirectionalGuide(SpatialGrid(LO, HI, 32, "cpu"))
    with jax.disable_jit():
        want = [np.asarray(x) for x in jguide.sample(jnp.asarray(hist), jnp.asarray(u2),
                                                     jnp.asarray(u_def))]
        want_pdf = np.asarray(jguide.pdf(jnp.asarray(hist), jnp.asarray(w)))
    got = [x.numpy() for x in pguide.sample(t(hist), t(u2), t(u_def))]
    np.testing.assert_array_equal(got[2], want[2])
    close = (np.isclose(got[0], want[0], rtol=1e-4, atol=1e-5).all(1)
             & np.isclose(got[1], want[1], rtol=1e-4, atol=0))
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(pguide.pdf(t(hist), t(w)).numpy(), want_pdf, rtol=1e-5, atol=0)
    assert 0.1 < want[2].mean() < 0.9


def test_iterative_scheme_matches():
    for spp in range(1, 65):
        assert PG.iterative_scheme(spp) == JG.iterative_scheme(spp), spp
