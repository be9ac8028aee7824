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
    assert g["bvh"]["boxes"].shape == (len(pg["c_node"]), 2, 6)
    assert (g["bvh"]["ccount"].numpy() <= 4).all() and g["bvh"]["depth"] <= BT.STACK_DEPTH
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
    rng = np.random.default_rng(n_tri + 50)
    held = torch.from_numpy(rng.uniform(size=8192) < 0.3).to(dev)
    bt = torch.where(held, 1.5, tmax)
    be = torch.where(held, 3, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=8192) < 0.2).astype(np.int32)).to(dev)
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        t_k, e_k = BT.bvh_cuda(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        t_p, e_p = GT.supercell_plain(g["tid"], g["rows"], g["bvh"], *args, any_hit)
        torch.cuda.synchronize()
        close = torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) & (e_k == e_p)
        assert int((~close).sum()) <= GRID_MISMATCH_SHARE * 8192
