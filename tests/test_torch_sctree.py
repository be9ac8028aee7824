"""The supercell-tree traversal (pine_tpu_torch/accel/sctree_traverse.py)
against pine_tpu.

On the CPU ``group_query`` runs ``grid_traverse.supercell_plain``, the plain
PyTorch version of the CUDA supercell-tree kernel, for a group routed to
"sctree" (``CompiledScene.mesh_kernel``, pine_tpu's
``PINE_MESH_KERNEL=sctree``; here with ``GRID_MAX_PRIMS`` cut to 512, as
tests/test_pallas_tree.py cuts pine_tpu's, so that the soups are
mesh-scale).  It is held against:

- pine_tpu's XLA packet walk (``PINE_TPU_PALLAS=0``) on triangle soups of
  700 and 3,000 triangles and on the 12x12 cone field of
  tests/test_torch_scdense.py (``small_kernel``), closest-hit and any-hit,
  with the criteria of tests/test_pallas_tree.py: hit sets equal, t to rtol
  2e-5 / atol 1e-6 (the cones, as there, 2e-4), ids equal on more than 99 %
  of the hit lanes, occlusion flags equal;
- the dense sweep (``dense_plain``) on the same inputs with a prepared
  running best and occlusion: bit for bit (t, ids and flags);
- the host tables: ``sc_tree_layout`` equals pine_tpu's ``_sc_tree_layout``.

No case runs pine_tpu's Pallas supercell-tree kernel in interpret mode: one
closest-hit query of 1,024 rays over the 700-triangle soup took 191 s on the
CPU (timed under a 240 s limit, beside two other interpret runs), over the
60 s a case may take.

The GPU tests hold the CUDA kernel to ``grid_traverse.supercell_plain`` on
the card (t to rtol 1e-5 / atol 1e-6, ids and flags equal) on all but 1e-4
of the lanes, where a cull may decide at a box face: on random rays over two
soups, and on ray sets that drive its warp-level walk and leaf schedules
(tests/test_torch_grid_kernel.py's ``schedule_rays``: one live lane per
warp, full warps, any-hit rays occluded mid-cell, the house's shadow rays),
and skip without a card.  A CPU test checks that the wrapper refuses rows
the kernel cannot stage (not on a 16-byte boundary).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_grid_kernel import assert_closest_agree, card_schedule_case, rays
from test_torch_scdense import both, cone_field, cone_rays, port_soup, query_both

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import grid_traverse as GT
from pine_tpu_torch.accel import sctree_traverse as ST

torch.set_num_threads(2)

GRID_MISMATCH_SHARE = 1e-4  # lanes where a culling kernel may differ from its plain version


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_matches_xla_walk(n_tri, monkeypatch):
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    monkeypatch.setattr(DT, "GRID_MAX_PRIMS", 512)
    jacc, pacc = both(n_tri, n_tri + 20, mesh_kernel="sctree")
    assert pacc["groups"][0]["variant"] == "sctree" and "grid" not in pacc["groups"][0]
    (t_p, e_p, occ_p), (t_j, e_j, occ_j) = query_both(jacc, pacc, *rays(2048, n_tri + 21))
    assert_closest_agree(t_p, e_p, t_j, e_j)
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)


def test_plain_matches_xla_walk_on_cones(monkeypatch):
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    jacc, pacc = cone_field()
    DT.route(pacc["groups"], small_kernel="sctree")
    assert pacc["groups"][0]["variant"] == "sctree"
    (t_p, e_p, occ_p), (t_j, e_j, occ_j) = query_both(jacc, pacc, *cone_rays(2048, 5))
    assert_closest_agree(t_p, e_p, t_j, e_j, rtol=2e-4)
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_is_the_dense_sweep(n_tri):
    pacc = port_soup(n_tri, n_tri + 22)
    g = pacc["groups"][0]
    DT.prepare(g, "sctree")
    n_prims = len(g["prim_aabbs"])
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(2048, n_tri + 23))
    rng = np.random.default_rng(n_tri + 24)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        got = GT.supercell_plain(g["tid"], g["rows"], g["sctree"], *args, any_hit)
        want = DT.dense_plain(g["tid"], g["rows"][:n_prims], g["gbox"], *args, any_hit)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tables_match_pine_tpu(monkeypatch):
    from pine_tpu.accel import pallas_traverse as PT

    monkeypatch.setattr(PT, "GRID_MAX_PRIMS", 64)
    jacc, pacc = both(3000, 25)
    g = pacc["groups"][0]
    DT.prepare(g, "sctree")
    jt, pt = PT._sc_tree_layout(jacc["groups"][0]), g["sctree"]
    for k in ("boxes", "cnode", "cstart", "ccount", "sc_order"):
        np.testing.assert_array_equal(pt[k].numpy().ravel(), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_array_equal(pt["cell_boxes"].numpy().ravel(),
                                  np.asarray(jt["cell_boxes"])[: pt["cell_boxes"].numel()])
    assert pt["depth"] == jt["depth"] and pt["n_prims"] == jt["n_prims"] == 3000


def test_wrapper_refuses_a_tree_deeper_than_its_stack():
    pacc = port_soup(700, 26)
    g = pacc["groups"][0]
    DT.prepare(g, "sctree")
    sct = dict(g["sctree"], depth=ST.STACK_DEPTH + 1)
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(16, 27))
    with pytest.raises(NotImplementedError, match="stack"):
        ST.sctree_cuda(g["tid"], g["rows"], sct, ro, rd, tmin, tmax, tmax,
                       torch.full((16,), -1, dtype=torch.int32), False)


def test_wrapper_refuses_unaligned_rows():
    pacc = port_soup(700, 26)
    g = pacc["groups"][0]
    DT.prepare(g, "sctree")
    rows = g["rows"]
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype)[1:].view(rows.shape)
    shifted.copy_(rows)
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(16, 27))
    with pytest.raises(ValueError, match="16-byte"):
        ST.sctree_cuda(g["tid"], shifted, g["sctree"], ro, rd, tmin, tmax, tmax,
                       torch.full((16,), -1, dtype=torch.int32), False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one live lane", "full warps", "mid-cell occluders",
                                  "shadow rays"])
def test_warp_walk_schedules_match_plain_on_card(case):
    card_schedule_case(case, "sctree")


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri", [700, 3000])
def test_kernel_matches_plain_on_card(n_tri):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    pacc = port_soup(n_tri, n_tri + 28, dev)
    g = pacc["groups"][0]
    DT.prepare(g, "sctree")
    ro, rd, tmin, tmax = (torch.from_numpy(x).to(dev) for x in rays(8192, n_tri + 29))
    rng = np.random.default_rng(n_tri + 30)
    held = torch.from_numpy(rng.uniform(size=8192) < 0.3).to(dev)
    bt = torch.where(held, 1.5, tmax)
    be = torch.where(held, 3, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=8192) < 0.2).astype(np.int32)).to(dev)
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        t_k, e_k = ST.sctree_cuda(g["tid"], g["rows"], g["sctree"], *args, any_hit)
        t_p, e_p = GT.supercell_plain(g["tid"], g["rows"], g["sctree"], *args, any_hit)
        torch.cuda.synchronize()
        close = torch.isclose(t_k, t_p, rtol=1e-5, atol=1e-6) & (e_k == e_p)
        assert int((~close).sum()) <= GRID_MISMATCH_SHARE * 8192
