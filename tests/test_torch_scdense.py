"""The supercell-culled dense traversal (pine_tpu_torch/accel/scdense_traverse.py)
against pine_tpu.

On the CPU ``group_query`` runs ``scdense_plain``, the plain PyTorch version
of the CUDA scdense kernel, for a group routed to "scdense"
(``CompiledScene.small_kernel``, pine_tpu's ``PINE_SMALL_KERNEL=scdense``).
It is held against:

- pine_tpu's XLA packet walk (its CPU default, ``PINE_TPU_PALLAS=0``) on
  triangle soups of 700 and 3,000 triangles and on a 12x12 field of cones,
  closest-hit and any-hit, with the criteria of tests/test_pallas_tree.py:
  hit sets equal, t to rtol 2e-5 / atol 1e-6, ids equal on more than 99 %
  of the hit lanes (the two order the rows differently), occlusion flags
  equal.  On the cones t is held to rtol 2e-4: their quadratic cancels for
  rays that graze a cone, and XLA's CPU backend fuses multiply-adds, so the
  two packages round differently there (measured: 22 of 1,152 hit lanes
  beyond 2e-5, at most 9.7e-5, each as far from a float64 evaluation as
  pine_tpu's t); the port's default route, the dense sweep, gives the same t
  as scdense on every lane;
- the dense sweep (``dense_plain``) on the same inputs with a prepared
  running best and occlusion: bit for bit (t, ids and flags), since the
  culls only skip work;
- pine_tpu's own Pallas scdense kernel in interpret mode
  (``PINE_SMALL_KERNEL=scdense``, ``PINE_TPU_PALLAS=1``) on a soup of 100
  triangles, closest-hit and any-hit, by the XLA-walk criteria with t to
  rtol 1e-4 (XLA's CPU backend fuses multiply-adds in interpret mode);
- the host tables: the 16-prim cell boxes equal ``_grid_layout``'s
  ``scd_cell_boxes`` and the supercell boxes its ``sc_boxes``.

The premise of the kernel's compaction is held here too: a lane whose
incoming window reaches no supercell box gets its input state back from
``scdense_plain`` bit for bit.

The GPU test holds the CUDA kernel (over the padded rows it reads) to
``scdense_plain`` on the card bit for bit (t, ids and flags) and skips
without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_grid_kernel import _JaxMesh, assert_closest_agree, rays, soup

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.accel import scdense_traverse as SD
from pine_tpu_torch.convert import upload_group
from pine_tpu_torch.scene import shapes as PS

torch.set_num_threads(2)


def port_soup(n_tri, seed, device="cpu", **kernels):
    """soup(n_tri, seed) as the port's accel, its one group uploaded to
    ``device`` and routed under the settings ``kernels`` (small_kernel,
    mesh_kernel)."""
    V, F = soup(n_tri, seed)
    pacc = PPK.build_packet_accel([], [(PS.Mesh(V, F), 0)])
    pacc["groups"] = [upload_group(pacc["groups"][0], device, **kernels)]
    pacc["ent_gidx"] = torch.as_tensor(pacc["ent_gidx"], device=device)
    return pacc


def both(n_tri, seed, device="cpu", **kernels):
    """The same triangle soup in both packages: (pine_tpu accel, port_soup)."""
    from pine_tpu.accel import packet as JPK

    V, F = soup(n_tri, seed)
    jacc = JPK.build_packet_accel([], [(_JaxMesh(V, F), 0)])
    pacc = port_soup(n_tri, seed, device, **kernels)
    np.testing.assert_array_equal(pacc["groups"][0]["rows"].cpu().numpy(),
                                  jacc["groups"][0]["rows_np"])
    return jacc, pacc


def cone_prims(S):
    """A 12x12 field of cones (a lattice group of 148 rows) as prims of the
    shapes module ``S`` of either package."""
    prims = []
    for i in range(12):
        for j in range(12):
            c = S.Cone([-1.2 + 0.2 * j, 0.0, -1.2 + 0.2 * i], [0, 1, 0], 0.08, 0.3)
            prims.append((c.type_id, c.params(), len(prims), c.get_aabb()))
    return prims


def port_cones(device="cpu"):
    pacc = PPK.build_packet_accel(cone_prims(PS))
    pacc["groups"] = [upload_group(pacc["groups"][0], device)]
    pacc["ent_gidx"] = torch.as_tensor(pacc["ent_gidx"], device=device)
    return pacc


def cone_field():
    """The cone field in both packages: (pine_tpu accel, port_cones())."""
    from pine_tpu.accel import packet as JPK
    from pine_tpu.scene import shapes as JS

    return JPK.build_packet_accel(cone_prims(JS), []), port_cones()


def cone_rays(n, seed):
    """Rays from above the cone field, aimed at it, and grazing ones."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform([-1.3, 0.0, -1.3], [1.3, 0.3, 1.3], (n, 3))
    ro = tgt + rng.uniform([-1.5, 0.3, -1.5], [1.5, 2.5, 1.5], (n, 3))
    ro[::5, 1] = rng.uniform(0.0, 0.2, len(ro[::5]))
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::9] = -1.0
    return ro.astype(np.float32), rd.astype(np.float32), np.zeros(n, np.float32), tmax


CASES = {"soup700": lambda: both(700, 700), "soup3000": lambda: both(3000, 3000),
         "cones12x12": cone_field}


def query_both(jacc, pacc, ro, rd, tmin, tmax):
    """Closest hits (t and the hit geometry) and occlusion (window to 2.5) of
    both packages: the geometry, as the two SAH builds may order the rows of
    a lattice differently (ROADMAP.md, section 3)."""
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK

    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax)))
    tmax2 = np.where(tmax > 0, 2.5, -1.0).astype(np.float32)
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    occ_p = PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy()
    g_j = np.asarray(jacc["ent_gidx"])[e_j]
    g_p = pacc["ent_gidx"].numpy()[e_p]
    return (t_p, g_p, occ_p), (t_j, g_j, occ_j)


def aimed_rays(n_tri, seed, n=1024):
    """Rays from around soup(n_tri, seed) aimed at its triangles' centroids,
    so that most of them hit."""
    V, F = soup(n_tri, seed)
    rng = np.random.default_rng(seed + 1)
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = V[F].mean(1)[rng.integers(0, len(F), n)] - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd.astype(np.float32), np.zeros(n, np.float32), np.full(n, 1e30, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_walk(case, monkeypatch):
    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    jacc, pacc = CASES[case]()
    DT.route(pacc["groups"], small_kernel="scdense")
    assert pacc["groups"][0]["variant"] == "scdense"
    cones = case.startswith("cones")
    ro, rd, tmin, tmax = cone_rays(2048, 5) if cones else rays(2048, 9)
    (t_p, e_p, occ_p), (t_j, e_j, occ_j) = query_both(jacc, pacc, ro, rd, tmin, tmax)
    assert_closest_agree(t_p, e_p, t_j, e_j, rtol=2e-4 if cones else 2e-5)
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)
    DT.route(pacc["groups"])  # the default route gives the same hits
    (t_d, e_d, occ_d), _ = query_both(jacc, pacc, ro, rd, tmin, tmax)
    assert np.array_equal(t_d, t_p) and np.array_equal(e_d, e_p) and np.array_equal(occ_d, occ_p)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_is_the_dense_sweep(case):
    """Culls only skip work: scdense_plain equals the dense sweep over the
    rows in order, bit for bit, against a prepared running best and
    occlusion, and never tests the group's pad rows."""
    _, pacc = CASES[case]()
    g = pacc["groups"][0]
    DT.prepare(g, "scdense")
    n_prims = len(g["prim_aabbs"])
    assert g["scd"]["n_prims"] == n_prims == g["rows"].shape[0] - 4
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in (
        cone_rays(2048, 6) if case.startswith("cones") else rays(2048, 10)))
    rng = np.random.default_rng(11)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        got = SD.scdense_plain(g["tid"], g["rows"], g["scd"], *args, any_hit)
        want = DT.dense_plain(g["tid"], g["rows"][:n_prims], g["gbox"], *args, any_hit)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert any_hit or int((got[1] != be).sum()) > 100


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanes_that_reach_no_supercell_pass_through(case):
    """The premise of the kernel's compaction (csrc/scdense_traverse.cu): a
    lane whose incoming window (closest-hit: (tmin, best_t); any-hit: (tmin,
    tmax), none once occluded) reaches no supercell box gets its input state
    back from scdense_plain bit for bit, so the kernel writes it back and
    sweeps only the others."""
    from pine_tpu_torch.accel.grid_traverse import _slab

    _, pacc = CASES[case]()
    g = pacc["groups"][0]
    DT.prepare(g, "scdense")
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in (
        cone_rays(2048, 14) if case.startswith("cones") else rays(2048, 15)))
    rng = np.random.default_rng(16)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    o = [ro[:, a] for a in range(3)]
    inv = [DT._safe_inv(rd[:, a]) for a in range(3)]
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        window = args[3] if any_hit else bt
        reach = torch.stack([_slab(box, o, inv, tmin, window) for box in g["scd"]["sc_boxes"]])
        live = reach.any(0) & (((occ == 0) & (args[3] > tmin)) if any_hit else True)
        t, e = SD.scdense_plain(g["tid"], g["rows"], g["scd"], *args, any_hit)
        assert int((~live).sum()) > 100 and int(live.sum()) > 100
        assert torch.equal(t[~live].view(torch.int32), state[0][~live].view(torch.int32))
        assert torch.equal(e[~live], state[1][~live])
        assert int((e[live] != state[1][live]).sum()) > 50


def test_tables_match_pine_tpu():
    from pine_tpu.accel import pallas_traverse as PT

    jacc, pacc = both(3000, 3000)
    (jg,), g = jacc["groups"], pacc["groups"][0]
    DT.prepare(g, "scdense")
    jl, scd = PT._grid_layout(jg), g["scd"]
    assert (scd["n_prims"], scd["n_super"]) == (3000, 24)
    np.testing.assert_array_equal(scd["cell_boxes"].numpy(),
                                  np.asarray(jl["scd_cell_boxes"]).reshape(-1, 6)[: 24 * 8])
    np.testing.assert_array_equal(scd["sc_boxes"].numpy(),
                                  np.asarray(jl["sc_boxes"]).reshape(-1, 6)[:24])
    # the last supercell holds 56 prims: cells 4..7 of it are the empty box
    last = scd["cell_boxes"][23 * 8:].numpy()
    assert (last[4:, :3] > last[4:, 3:]).all() and (last[:4, :3] <= last[:4, 3:]).all()


def test_plain_matches_pallas_scdense_interpret(monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK
    from pine_tpu.accel import pallas_traverse as PT

    monkeypatch.setenv("PINE_SMALL_KERNEL", "scdense")
    monkeypatch.setenv("PINE_TPU_PALLAS", "1")
    jacc, pacc = both(100, 13)
    assert PT._group_variant(jacc["groups"][0]) == "scdense"
    DT.route(pacc["groups"], small_kernel="scdense")
    ro, rd, tmin, tmax = aimed_rays(100, 13)
    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax)))
    hit = t_j < 1e29
    np.testing.assert_array_equal(t_p < 1e29, hit)
    assert hit.sum() > 500
    np.testing.assert_allclose(t_p[hit], t_j[hit], rtol=1e-4, atol=1e-6)
    assert ((e_p == e_j) | ~hit).mean() > 0.99
    tmax2 = np.where(tmax > 0, 2.5, -1.0).astype(np.float32)
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    occ_p = PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy()
    assert occ_j.sum() > 200
    np.testing.assert_array_equal(occ_p, occ_j)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    if case.startswith("cones"):
        pacc = port_cones(dev)
        ro, rd, tmin, tmax = cone_rays(8192, 7)
    else:
        pacc = port_soup(int(case[4:]), 3, dev)
        ro, rd, tmin, tmax = rays(8192, 8)
    g = pacc["groups"][0]
    DT.prepare(g, "scdense")
    ro, rd, tmin, tmax = (torch.from_numpy(x).to(dev) for x in (ro, rd, tmin, tmax))
    rng = np.random.default_rng(9)
    held = torch.from_numpy(rng.uniform(size=8192) < 0.3).to(dev)
    bt = torch.where(held, 1.5, tmax)
    be = torch.where(held, 3, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=8192) < 0.2).astype(np.int32)).to(dev)
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        t_k, e_k = SD.scdense_cuda(g["tid"], DT.kernel_rows(g, "scdense"), g["scd"], *args, any_hit)
        t_p, e_p = SD.scdense_plain(g["tid"], g["rows"], g["scd"], *args, any_hit)
        torch.cuda.synchronize()
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(e_k, e_p)
