"""The grid traversal (pine_tpu_torch/accel/grid_traverse.py) against pine_tpu.

On the CPU ``group_query`` runs ``grid_plain``, the plain PyTorch version of
the CUDA grid kernel, for every non-lattice group of more than 512 prims.
It is held against:

- pine_tpu's XLA packet walk (its CPU default, ``PINE_TPU_PALLAS=0``) on
  triangle soups of 700 (no coarse level) and 3,000 triangles (coarse level),
  closest-hit and any-hit, with the criteria of tests/test_pallas_tree.py:
  hit sets equal, t to rtol 2e-5 / atol 1e-6, entity ids equal on more than
  99 % of the hit lanes (the two walk different trees, so exact ties may
  break differently), occlusion flags equal;
- pine_tpu's own Pallas grid kernel in interpret mode (``_make_grid_kernel``
  with ``PINE_MESH_KERNEL=grid``, ``PINE_TPU_PALLAS=1`` and
  ``GRID_MAX_PRIMS`` cut to 64, so the 3,000-triangle soup takes its HBM
  mode with the coarse level, octant order and cell culls), closest-hit, on
  the same criteria; and the port's host tables (``grid_layout``) equal
  pine_tpu's ``_grid_layout`` where both define them.

``grid_plain`` and the dense sweep are the same function: on the soups they
agree bit for bit (t, ids and flags).  The GPU tests hold the CUDA kernel to
``grid_plain`` on the card (t to rtol 1e-5 / atol 1e-6, ids and flags
equal) and skip without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.accel import grid_traverse as GT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.convert import upload_group
from pine_tpu_torch.scene import shapes as PS

torch.set_num_threads(2)

BIG = 1e30


def soup(n_tri, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    tris = c[:, None, :] + rng.uniform(-0.2, 0.2, (n_tri, 3, 3)).astype(np.float32)
    return tris.reshape(-1, 3), np.arange(3 * n_tri, dtype=np.uint32).reshape(-1, 3)


class _JaxMesh:
    def __init__(self, V, F):
        self.vertices, self.indices = V, F
        self.normals = self.texcoords = None


def both(n_tri, seed, device="cpu"):
    """The same soup in both packages: (pine_tpu accel, port accel with its
    one group uploaded to ``device``)."""
    from pine_tpu.accel import packet as JPK

    V, F = soup(n_tri, seed)
    jacc = JPK.build_packet_accel([], [(_JaxMesh(V, F), 0)])
    pacc = PPK.build_packet_accel([], [(PS.Mesh(V, F), 0)])
    (jg,) = jacc["groups"]
    (pg,) = pacc["groups"]
    np.testing.assert_array_equal(pg["rows"], jg["rows_np"])
    pacc["groups"] = [upload_group(pg, device)]
    pacc["ent_gidx"] = torch.as_tensor(pacc["ent_gidx"], device=device)
    assert DT.group_variant(pacc["groups"][0]) == "grid"
    return jacc, pacc


def rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::9] = -1.0  # dead lanes
    return ro, rd, tmin, tmax


def assert_closest_agree(t_p, e_p, t_j, e_j):
    hit_j, hit_p = t_j < 1e29, t_p < 1e29
    np.testing.assert_array_equal(hit_p, hit_j)
    assert hit_j.sum() > 100, "the soup must actually be hit"
    np.testing.assert_allclose(t_p[hit_j], t_j[hit_j], rtol=2e-5, atol=1e-6)
    assert ((e_p == e_j) | ~hit_j).mean() > 0.99


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_matches_xla_walk(n_tri, monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK

    monkeypatch.setenv("PINE_TPU_PALLAS", "0")
    jacc, pacc = both(n_tri, seed=n_tri)
    assert pacc["groups"][0]["grid"]["use_coarse"] == (n_tri > 16 * GT.SUPER)
    ro, rd, tmin, tmax = rays(2048, seed=n_tri + 1)
    j = [jnp.asarray(x) for x in (ro, rd, tmin)]
    p = [torch.from_numpy(x) for x in (ro, rd, tmin)]
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(jacc, *j, jnp.asarray(tmax)))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(pacc, *p, torch.from_numpy(tmax)))
    assert_closest_agree(t_p, e_p, t_j, e_j)

    tmax2 = np.where(tmax > 0, 2.5, -1.0).astype(np.float32)
    occ_j = np.asarray(JPK.packet_any_hit(jacc, *j, jnp.asarray(tmax2)))
    occ_p = PPK.packet_any_hit(pacc, *p, torch.from_numpy(tmax2)).numpy()
    assert occ_j.sum() > 50
    np.testing.assert_array_equal(occ_p, occ_j)


@pytest.mark.parametrize("n_tri", [700, 3000])
def test_plain_is_the_dense_sweep(n_tri):
    """Culls only skip work: grid_plain equals the dense sweep over the rows in
    order, bit for bit, against a prepared running best and occlusion."""
    _, pacc = both(n_tri, seed=n_tri + 2)
    g = pacc["groups"][0]
    ro, rd, tmin, tmax = (torch.from_numpy(x) for x in rays(2048, seed=n_tri + 3))
    rng = np.random.default_rng(n_tri + 4)
    held = torch.from_numpy(rng.uniform(size=2048) < 0.3)
    bt = torch.where(held, torch.from_numpy(rng.uniform(0.5, 4, 2048).astype(np.float32)), tmax)
    be = torch.where(held, 7, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=2048) < 0.2).astype(np.int32))
    rows = g["rows"][:n_tri]
    for any_hit, state in ((False, (bt, be)), (True, (tmax, occ))):
        got = GT.grid_plain(g["tid"], g["rows"], g["grid"], ro, rd, tmin, tmax, *state, any_hit)
        want = DT.dense_plain(g["tid"], rows, g["gbox"], ro, rd, tmin, tmax, *state, any_hit)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_matches_pallas_grid_interpret(monkeypatch):
    import jax.numpy as jnp
    from pine_tpu.accel import packet as JPK
    from pine_tpu.accel import pallas_traverse as PT

    monkeypatch.setattr(PT, "GRID_MAX_PRIMS", 64)
    monkeypatch.setenv("PINE_MESH_KERNEL", "grid")
    monkeypatch.setenv("PINE_TPU_PALLAS", "1")
    jacc, pacc = both(3000, seed=7)
    (jg,) = jacc["groups"]
    assert PT._group_variant(jg) == "grid" and PT._grid_hbm(jg)

    # the host tables: boxes and near-first orders are pine_tpu's
    jl, pl = PT._grid_layout(jg), pacc["groups"][0]["grid"]
    n_super = pl["n_super"]
    assert pl["use_coarse"] and jl["e_pad"] // PT.SUPER > 16
    np.testing.assert_array_equal(pl["coarse_boxes"].numpy().ravel(),
                                  np.asarray(jl["coarse_boxes"]))
    sc = np.asarray(jl["sc_boxes"]).reshape(-1, 6)
    np.testing.assert_array_equal(pl["sc_boxes"].numpy(), sc[: len(pl["sc_boxes"])])
    cells = np.asarray(jl["cell32_boxes"]).reshape(-1, 6)
    np.testing.assert_array_equal(pl["cell_boxes"].numpy(), cells[: n_super * 4])
    np.testing.assert_array_equal(pl["c_order8"].numpy().ravel(), np.asarray(jl["c_order8"]))
    np.testing.assert_array_equal(pl["s_order8"].numpy().ravel(), np.asarray(jl["s_order8"]))

    # one (8,128) ray block through the kernel, against the plain version
    ro, rd, tmin, tmax = rays(1024, seed=3)
    t_j, e_j = (np.asarray(x) for x in JPK.packet_intersect(
        jacc, *(jnp.asarray(x) for x in (ro, rd, tmin, tmax))))
    t_p, e_p = (x.numpy() for x in PPK.packet_intersect(
        pacc, *(torch.from_numpy(x) for x in (ro, rd, tmin, tmax))))
    assert_closest_agree(t_p, e_p, t_j, e_j)


def test_grid_variant_and_layout_shapes():
    """Groups over 512 rows that are not lattices take the grid; the tables
    cover every prim, empty boxes pad the last coarse box."""
    _, pacc = both(3000, seed=11)
    g = pacc["groups"][0]["grid"]
    assert (g["n_prims"], g["n_super"], g["n_coarse"]) == (3000, 24, 2)
    assert g["sc_boxes"].shape == (32, 6) and g["cell_boxes"].shape == (96, 6)
    assert (g["sc_boxes"][24:, :3] > g["sc_boxes"][24:, 3:]).all()
    for o in range(8):  # per coarse box its own supercells, the padding last
        s = g["s_order8"][o].numpy()
        assert sorted(s[:16]) == list(range(16)) and sorted(s[16:]) == list(range(16, 32))
        assert list(s[24:]) == list(range(24, 32))
    lay = GT.grid_layout(np.asarray(pacc["groups"][0]["prim_aabbs"])[:300])
    assert not lay["use_coarse"] and lay["n_coarse"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_tri", [700, 3000])
def test_kernel_matches_plain_on_card(n_tri):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    V, F = soup(n_tri, n_tri)
    (g,) = PPK.build_packet_accel([], [(PS.Mesh(V, F), 0)])["groups"]
    g = upload_group(g, dev)
    ro, rd, tmin, tmax = (torch.from_numpy(x).to(dev) for x in rays(8192, seed=n_tri + 5))
    rng = np.random.default_rng(n_tri + 6)
    held = torch.from_numpy(rng.uniform(size=8192) < 0.3).to(dev)
    bt = torch.where(held, 1.5, tmax)
    be = torch.where(held, 3, -1).to(torch.int32)
    occ = torch.from_numpy((rng.uniform(size=8192) < 0.2).astype(np.int32)).to(dev)
    for any_hit, state in ((False, (bt, be)), (True, (torch.where(tmax > 0, 2.5, -1.0), occ))):
        args = (ro, rd, tmin, state[0] if any_hit else tmax, *state)
        t_k, e_k = GT.grid_cuda(g["tid"], g["rows"], g["grid"], *args, any_hit)
        t_p, e_p = GT.grid_plain(g["tid"], g["rows"], g["grid"], *args, any_hit)
        torch.cuda.synchronize()
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
        assert torch.equal(e_k, e_p)
