"""The BVH traversal (pine_tpu_torch/accel/bvh_traverse.py) against pine_tpu.

On the CPU ``group_query`` runs ``grid_traverse.supercell_plain``, the plain
PyTorch version of the CUDA BVH kernel, for a group routed to "bvh": by
default every group of more than GRID_MAX_PRIMS_HBM (2,000,000) prims, and
a SAH-ordered group that ``CompiledScene.small_kernel`` or ``mesh_kernel``
sets to it.  It is held
against:

- pine_tpu's XLA packet walk (``PINE_TPU_PALLAS=0``) on triangle soups of
  700 and 3,000 triangles, closest-hit and any-hit, with the criteria of
  tests/test_pallas_tree.py: hit sets equal, t to rtol 2e-5 / atol 1e-6,
  ids equal on more than 99 % of the hit lanes, occlusion flags equal; the
  3,000-triangle soup takes the route by default, with GRID_MAX_PRIMS_HBM
  cut to 2,000; and on the 12x12 cone field of tests/test_torch_scdense.py
  (``small_kernel``, t to rtol 2e-4 as there);
- the dense sweep (``dense_plain``) on the same inputs with a prepared
  running best and occlusion: bit for bit (t, ids and flags);
- pine_tpu's own Pallas BVH kernel in interpret mode
  (``PINE_SMALL_KERNEL=bvh``, ``PINE_TPU_PALLAS=1``) on a soup of 300
  triangles, by the XLA-walk criteria with t to rtol 1e-4 (XLA's CPU
  backend fuses multiply-adds in interpret mode);
- the node arrays: the port's SAH tree of the reduced terrain's triangle
  group (grid 40, 3,042 triangles) equals pine_tpu's ``nodes_np``.

The kernel's own tables and walk, on the CPU: its 64-byte node records
(``pack_nodes``) decode back to the builder's arrays exactly; the wrapper
refuses a group whose rows a leaf link cannot address; and the kernel's
walk, emulated in PyTorch over the records alone (``packed_walk``), equals
``supercell_plain`` bit for bit on every lane where either finds a hit.

The GPU test holds the CUDA kernel to ``grid_traverse.supercell_plain`` on
the card (t to rtol 1e-5 / atol 1e-6, ids and flags equal) on all but 1e-4
of the lanes, where a cull may decide at a box face, and skips without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_grid_kernel import assert_closest_agree, rays
from test_torch_scdense import aimed_rays, both, cone_field, cone_rays, port_soup, query_both

from pine_tpu_torch.accel import bvh_traverse as BT
from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import grid_traverse as GT

torch.set_num_threads(2)

GRID_MISMATCH_SHARE = 1e-4  # lanes where a culling kernel may differ from its plain version


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_matches_xla_walk(n_tri, monkeypatch):
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    monkeypatch.setattr(DT, "GRID_MAX_PRIMS_HBM", 2000)
    jacc, pacc = both(n_tri, n_tri + 40, small_kernel="bvh" if n_tri < 2000 else None)
    g = pacc["groups"][0]
    assert g["variant"] == "bvh" and "grid" not in g and g["bvh"]["depth"] > 5
    assert "sc_boxes" not in g["bvh"]  # only the plain version builds supercell boxes
    (t_p, e_p, occ_p), (t_j, e_j, occ_j) = query_both(jacc, pacc, *rays(2048, n_tri + 41))
    assert_closest_agree(t_p, e_p, t_j, e_j)
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)


def test_plain_matches_xla_walk_on_cones(monkeypatch):
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    jacc, pacc = cone_field()
    DT.route(pacc["groups"], small_kernel="bvh")
    assert pacc["groups"][0]["variant"] == "bvh"
    (t_p, e_p, occ_p), (t_j, e_j, occ_j) = query_both(jacc, pacc, *cone_rays(2048, 5))
    assert_closest_agree(t_p, e_p, t_j, e_j, rtol=2e-4)
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_is_the_dense_sweep(n_tri):
    pacc = port_soup(n_tri, n_tri + 42)
    g = pacc["groups"][0]
    DT.prepare(g, "bvh")
    n_prims = len(g["prim_aabbs"])
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(2048, n_tri + 43))
    rng = np.random.default_rng(n_tri + 44)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        got = GT.supercell_plain(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        want = DT.dense_plain(g["tid"], g["rows"][:n_prims], g["gbox"], *args, any_hit)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_matches_pallas_bvh_interpret(monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK
    from pine_tpu.accel import pallas_traverse as PT

    from pine_tpu_torch.accel import packet as PPK

    monkeypatch.setenv("PINE_SMALL_KERNEL", "bvh")
    monkeypatch.setenv("PINE_TPU_PALLAS", "1")
    jacc, pacc = both(300, 45)
    assert PT._group_variant(jacc["groups"][0]) == "bvh"
    DT.route(pacc["groups"], small_kernel="bvh")
    ro, rd, tmin, tmax = aimed_rays(300, 45)
    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax)))
    hit = t_j < 1e29
    np.testing.assert_array_equal(t_p < 1e29, hit)
    assert hit.sum() > 500
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=1e-4, atol=1e-6)
    assert ((e_p == e_j) | ~hit).mean() > 0.99
    tmax2 = np.full(len(ro), 2.5, np.float32)
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    occ_p = PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy()
    assert occ_j.sum() > 200
    np.testing.assert_array_equal(occ_p, occ_j)


def test_node_arrays_match_pine_tpu():
    import bench_mesh
    from pine_tpu.accel import packet as JPK
    from test_torch_grid_kernel import _JaxMesh

    from pine_tpu_torch.accel import packet as PPK
    from pine_tpu_torch.convert import upload_group
    from pine_tpu_torch.scene import shapes as PS

    V, F = bench_mesh.make_terrain(40)
    (jg,) = JPK.build_packet_accel([], [(_JaxMesh(V, F), 0)])["groups"]
    (pg,) = PPK.build_packet_accel([], [(PS.Mesh(V, F), 0)])["groups"]
    assert len(pg["prim_aabbs"]) == 3042
    for k in ("c_lower", "c_upper", "c_node", "c_start", "c_count"):
        np.testing.assert_array_equal(pg[k], np.asarray(jg["nodes_np"][k]), err_msg=k)
    g = upload_group(pg, "cpu", small_kernel="bvh")
    assert g["bvh"]["nodes"].shape == (len(pg["c_node"]), BT.NODE_WORDS)
    assert (BT.unpack_nodes(g["bvh"]["nodes"])["ccount"].numpy() <= 4).all()
    assert g["bvh"]["depth"] <= BT.STACK_DEPTH
    print(f"reduced terrain: {len(pg['c_node'])} nodes, depth {g['bvh']['depth']}")


def test_wrapper_refuses_a_tree_deeper_than_its_stack():
    pacc = port_soup(700, 46)
    g = pacc["groups"][0]
    DT.prepare(g, "bvh")
    tree = dict(g["bvh"], depth=BT.STACK_DEPTH + 1)
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(16, 47))
    with pytest.raises(NotImplementedError, match="stack"):
        BT.bvh_cuda(g["tid"], g["rows"], tree, ro, rd, tmin, tmax, tmax,
                    torch.full((16,), -1, dtype=torch.int32), False)


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_packed_records_give_back_the_node_arrays(n_tri):
    """The kernel's 64-byte node records (``pack_nodes``), decoded on the CPU,
    give back the builder's boxes, children, first rows and counts exactly,
    and ``bvh_layout`` keeps them as its one node table."""
    g = port_soup(n_tri, n_tri + 51)["groups"][0]
    DT.prepare(g, "bvh")
    nodes = g["nodes"]
    assert set(g["bvh"]) == {"n_prims", "prim_aabbs", "depth", "nodes"}
    rec = g["bvh"]["nodes"]
    assert rec.dtype == torch.float32 and rec.shape == (len(nodes["c_node"]), BT.NODE_WORDS)
    got = BT.unpack_nodes(rec)
    boxes = np.concatenate([np.asarray(nodes["c_lower"]).reshape(-1, 2, 3),
                            np.asarray(nodes["c_upper"]).reshape(-1, 2, 3)], -1)
    np.testing.assert_array_equal(got["boxes"].numpy(), boxes)
    for k in ("cnode", "cstart", "ccount"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(nodes["c_" + k[1:]]).reshape(-1, 2), err_msg=k)
    assert (rec.view(torch.int32)[:, 14:] == 0).all()
    assert (got["cnode"] < 0).sum() > n_tri // 4 and got["ccount"].max() == 4


def test_wrapper_refuses_rows_the_leaf_links_cannot_hold():
    g = port_soup(700, 52)["groups"][0]
    DT.prepare(g, "bvh")
    with pytest.raises(NotImplementedError, match="leaf link"):
        BT.pack_nodes(g["nodes"], BT.LEAF_ROWS_MAX + 1)
    BT.pack_nodes(g["nodes"], BT.LEAF_ROWS_MAX)
    tree = dict(g["bvh"], n_prims=BT.LEAF_ROWS_MAX + 1)
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(16, 53))
    with pytest.raises(NotImplementedError, match="leaf link"):
        BT.bvh_cuda(g["tid"], g["rows"], tree, ro, rd, tmin, tmax, tmax,
                    torch.full((16,), -1, dtype=torch.int32), False)


DONE = 0x7FFFFFFF  # csrc/bvh_traverse.cu: no node left


def _slab_near(box, o, inv, tmin, lim):
    """The kernel's child-box test on (k, 6) boxes -> (hit, entry distance):
    minima and maxima that drop NaN (fminf / fmaxf), as the kernel takes
    them for the finite rays it walks."""
    t0 = [(box[:, a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(box[:, 3 + a] - o[a]) * inv[a] for a in range(3)]
    near = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]), torch.fmin(t0[1], t1[1])),
                      torch.fmax(torch.fmin(t0[2], t1[2]), tmin))
    far = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]), torch.fmax(t0[1], t1[1])),
                     torch.fmin(torch.fmax(t0[2], t1[2]), lim))
    return near <= far, near


def packed_walk(tid, rows, bvh, ro, rd, tmin, tmax, best_t, best_e, any_hit):
    """csrc/bvh_traverse.cu's walk emulated in PyTorch, all lanes a step at a
    time, over the packed node records alone: at each node both child boxes
    against (tmin, running best) (any-hit: (tmin, tmax)); of its inner
    children the nearer next and the farther pushed (neither: a pop); then
    its leaf children's rows, the nearer leaf first; any-hit leaves a lane
    at its first hit.  -> (outputs, the most stack entries a lane held)."""
    n = ro.shape[0]
    rec, words = bvh["nodes"], bvh["nodes"].view(torch.int32)
    o = [ro[:, a] for a in range(3)]
    d = [rd[:, a] for a in range(3)]
    inv = [DT._safe_inv(rd[:, a]) for a in range(3)]
    limit = tmax if any_hit else best_t  # the prim tests' window, whatever the order
    live = ((best_e == 0) & (tmax > tmin)) if any_hit else best_t > tmin
    live &= torch.isfinite(ro).all(1) & torch.isfinite(rd).all(1)
    cur_t, cur_e = limit.clone(), torch.full((n,), -1, dtype=torch.int64)
    occluded = torch.zeros(n, dtype=torch.bool)
    stack = torch.zeros((n, BT.STACK_DEPTH), dtype=torch.int64)
    sp = torch.zeros(n, dtype=torch.int64)
    node = torch.where(live, 0, DONE).to(torch.int64)
    most = 0

    def test_leaf(k, link):
        v = ~link
        start, count = v >> 3, v & 7
        for j in range(int(count.max()) if count.numel() else 0):
            sel = (count > j) & ~occluded[k]
            kk, e = k[sel], (start + j)[sel]
            t = DT.PRIM_TESTS[tid](lambda c: rows[e, c], [x[kk] for x in o],
                                   [x[kk] for x in d], tmin[kk], limit[kk])
            if any_hit:
                occluded[kk] |= t < DT.BIG
            else:
                better = (t < cur_t[kk]) | ((t == cur_t[kk]) & (e < cur_e[kk]))
                cur_t[kk] = torch.where(better, t, cur_t[kk])
                cur_e[kk] = torch.where(better, e, cur_e[kk])

    while (node != DONE).any():
        k = torch.nonzero(node != DONE).squeeze(1)
        r, w = rec[node[k]], words[node[k]]
        lim = tmax[k] if any_hit else cur_t[k]
        oi, ii = [x[k] for x in o], [x[k] for x in inv]
        h0, n0 = _slab_near(r[:, 0:6], oi, ii, tmin[k], lim)
        h1, n1 = _slab_near(r[:, 6:12], oi, ii, tmin[k], lim)
        c0, c1 = w[:, 12].long(), w[:, 13].long()
        near0 = n0 <= n1
        cn, cf = torch.where(near0, c0, c1), torch.where(near0, c1, c0)
        hn, hf = torch.where(near0, h0, h1), torch.where(near0, h1, h0)
        inner_n, inner_f = hn & (cn >= 0), hf & (cf >= 0)
        both_ = inner_n & inner_f
        stack[k[both_], sp[k[both_]]] = cf[both_]
        sp[k[both_]] += 1
        most = max(most, int(sp.max()))
        popping = ~inner_n & ~inner_f
        kp = k[popping]
        top = stack[kp, (sp[kp] - 1).clamp(min=0)]
        popped = torch.full_like(cn, DONE)
        popped[popping] = torch.where(sp[kp] > 0, top, DONE)
        sp[kp] = (sp[kp] - 1).clamp(min=0)
        nxt = torch.where(inner_n, cn, torch.where(inner_f, cf, popped))
        for h, c in ((hn, cn), (hf, cf)):  # the leaf children, the nearer first
            leaf = h & (c < 0)
            test_leaf(k[leaf], c[leaf])
        node[k] = torch.where(occluded[k], DONE, nxt)
    if any_hit:
        return (best_t, torch.where(occluded, 1, best_e)), most
    hit = cur_e >= 0
    return (torch.where(hit, cur_t, best_t), torch.where(hit, cur_e, best_e).to(torch.int32)), most


def non_finite(ro, rd):
    """Give 18 lanes of (ro, rd) a NaN, +inf or -inf in one coordinate of the
    origin or of the direction, each value on each axis; -> those lanes."""
    lanes = torch.arange(18, device=ro.device) * 97
    for j, lane in enumerate(lanes.tolist()):
        (ro if j < 9 else rd)[lane, j % 3] = (float("nan"), float("inf"), -float("inf"))[j // 3 % 3]
    return lanes


def assert_passed_through(out, best_t, best_e, lanes):
    """``out`` holds the incoming (best_t, best_e) on ``lanes``, bit for bit."""
    assert torch.equal(out[0][lanes].view(torch.int32), best_t[lanes].view(torch.int32))
    assert torch.equal(out[1][lanes], best_e[lanes])


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_packed_walk_matches_plain(n_tri):
    """The kernel's walk over the packed records (``packed_walk``, in its
    visit order) equals ``supercell_plain``:
    closest-hit bit for bit on every lane where either has a hit, any-hit
    flags on every lane; its stack never holds more than the tree's depth.
    A ray with a NaN or infinite coordinate, which the kernel passes through
    before its walk, keeps its incoming state in ``supercell_plain`` too."""
    g = port_soup(n_tri, n_tri + 54)["groups"][0]
    DT.prepare(g, "bvh")
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(2048, n_tri + 55))
    bad = non_finite(ro, rd)
    rng = np.random.default_rng(n_tri + 56)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        (t_w, e_w), most = packed_walk(g["tid"], DT.kernel_rows(g, "bvh"), g["bvh"], *args, any_hit)
        t_p, e_p = GT.supercell_plain(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        assert 1 < most <= g["bvh"]["depth"]
        assert_passed_through((t_p, e_p), *args[4:6], bad)
        assert_passed_through((t_w, e_w), *args[4:6], bad)
        if any_hit:
            assert torch.equal(e_w, e_p) and int((e_p != occ).sum()) > 100
            continue
        hit = (t_w < DT.BIG) | (t_p < DT.BIG)
        assert int(hit.sum()) > 200
        assert torch.equal(t_w[hit].view(torch.int32), t_p[hit].view(torch.int32))
        assert torch.equal(e_w[hit], e_p[hit])


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri", [700, 3000])
def test_kernel_matches_plain_on_card(n_tri):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    pacc = port_soup(n_tri, n_tri + 48, dev)
    g = pacc["groups"][0]
    DT.prepare(g, "bvh")
    ro, rd, tmin, tmax = (torch.from_numpy(x).to(dev) for x in rays(8192, n_tri + 49))
    bad = non_finite(ro, rd)
    rng = np.random.default_rng(n_tri + 50)
    held = torch.from_numpy(rng.uniform(size=8192) < 0.3).to(dev)
    bt = torch.where(held, 1.5, tmax)
    be = torch.where(held, 3, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=8192) < 0.2).astype(np.int32)).to(dev)
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        t_k, e_k = BT.bvh_cuda(g["tid"], DT.kernel_rows(g, "bvh"), g["bvh"], *args, any_hit)
        t_p, e_p = GT.supercell_plain(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        torch.cuda.synchronize()
        assert_passed_through((t_k, e_k), *args[4:6], bad)
        close = torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) & (e_k == e_p)
        assert int((~close).sum()) <= GRID_MISMATCH_SHARE * 8192
