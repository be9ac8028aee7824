"""pine_tpu_torch's mesh modules against pine_tpu's, on the CPU.

- The host SAH builder (csrc/bvh_builder.cpp through accel/native_build.py)
  gives pine_tpu's native builder's leaf order and nodes, array for array, on
  a 2,000-triangle soup and on ``scenes.terrain(grid=48)`` (4,418
  triangles); the numpy builder kept as the reference gives pine_tpu's numpy
  builder's order and nodes on the soup.
- The mesh branch of ``build_packet_accel`` (the triangle group, entity ids,
  entity rows and the shading attribute tables) equals pine_tpu's, with a
  mesh that has vertex normals and texcoords and one that has neither.
- ``unified_surface_info_triangle`` against pine_tpu's at points on and near
  the triangles: rtol 1e-5, atol 1e-6 (float32 sums and a square root).
- The coherence sort ``_ray_sort_perm`` gives pine_tpu's permutation, lane
  for lane, on 8,192 random rays with dead lanes; a sorted traversal gives
  the unsorted per-lane results bit for bit.
- The mesh shapes (area, triangle areas, heightmaps) and the emissive-mesh
  light (sampling and the pdf at a hit) against pine_tpu's: rtol 1e-5,
  atol 1e-6, but a sampled pdf to rtol 1e-4: it divides by the cosine at
  the light, which cancels near grazing (4 of 4,096 samples differ by 5e-5).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.accel import packet as JPK
from pine_tpu.scene import shapes as JS
from pine_tpu_torch import scenes
from pine_tpu_torch.accel import bvh as Pbvh
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.scene import shapes as PS

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def soup(n_tri, seed, half=0.2):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    tris = c[:, None, :] + rng.uniform(-half, half, (n_tri, 3, 3)).astype(np.float32)
    return tris.reshape(-1, 3), np.arange(3 * n_tri, dtype=np.uint32).reshape(-1, 3)


def tri_boxes(V, F):
    v = V[F.astype(np.int64)]
    return v.min(1).astype(np.float32), v.max(1).astype(np.float32)


@pytest.mark.parametrize("which", ["soup2000", "terrain48"])
def test_native_builder_matches_pine_tpu(which):
    from pine_tpu.accel.native_build import build_sah_native as jbuild

    V, F = soup(2000, 1) if which == "soup2000" else scenes.make_terrain(48)
    lo, hi = tri_boxes(V, F)
    want = jbuild(lo, hi)
    assert want is not None, "pine_tpu's native builder did not build"
    got = Pbvh.sah_arrays(lo, hi)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_numpy_builder_matches_pine_tpu():
    from pine_tpu.accel import bvh as Jbvh

    lo, hi = tri_boxes(*soup(2000, 1))
    j_order, j_nodes = Jbvh._build_sah(lo, hi, (lo + hi) * 0.5)
    p_order, p_nodes = Pbvh._build_sah(lo, hi, (lo + hi) * 0.5)
    assert p_order == j_order
    assert len(p_nodes) == len(j_nodes)
    for pn, jn in zip(p_nodes, j_nodes):
        for k in ("is_leaf", "start", "count", "child"):
            assert pn[k] == jn[k]
        np.testing.assert_array_equal(np.stack(pn["lower"]), np.stack(jn["lower"]))
        np.testing.assert_array_equal(np.stack(pn["upper"]), np.stack(jn["upper"]))


def _meshes():
    """Two meshes in both packages: one with vertex normals and texcoords."""
    rng = np.random.default_rng(3)
    V1, F1 = soup(300, 2, half=0.4)
    N1 = rng.normal(size=V1.shape).astype(np.float32)
    N1[::5] = 0.0  # a zero normal falls back to the geometric one
    T1 = rng.uniform(size=(len(V1), 2)).astype(np.float32)
    V2, F2 = scenes.make_terrain(12)
    j = [JS.Mesh(V1, F1, T1, N1), JS.Mesh(V2, F2)]
    p = [PS.Mesh(V1, F1, T1, N1), PS.Mesh(V2, F2)]
    return j, p


def _analytic(rng, n=20):
    prims = []
    for i in range(n):
        s = PS.Sphere(rng.uniform(-2, 2, 3), rng.uniform(0.05, 0.2))
        prims.append((s.type_id, s.params(), i, s.get_aabb()))
    return prims


def _both_accels():
    jm, pm = _meshes()
    prims = _analytic(np.random.default_rng(4))
    n = len(prims)
    jacc = JPK.build_packet_accel(prims, [(m, n + k) for k, m in enumerate(jm)])
    pacc = PPK.build_packet_accel(prims, [(m, n + k) for k, m in enumerate(pm)])
    return jacc, pacc


def test_packet_accel_mesh_branch_matches_pine_tpu():
    jacc, pacc = _both_accels()
    assert [(g["tid"], g["kind"]) for g in pacc["groups"]] == [(0, "bvh"), (6, "bvh")]
    assert len(jacc["groups"]) == len(pacc["groups"])
    for jg, pg in zip(jacc["groups"], pacc["groups"]):
        assert (pg["tid"], pg["kind"], pg["base"]) == (jg["tid"], jg["kind"], jg["base"])
        np.testing.assert_array_equal(pg["rows"], jg["rows_np"])
        np.testing.assert_array_equal(pg["prim_aabbs"], jg["_prim_aabbs"])
        assert pg["lattice"] == (jg.get("lattice") is not None)
    for k in ("ent_gidx", "ent_param", "geom_n", "tri_n", "tri_t", "tri_has_n", "tri_has_t"):
        np.testing.assert_array_equal(pacc[k], np.asarray(jacc[k]), err_msg=k)
    assert pacc["tri_has_n"].any() and pacc["tri_has_t"].any() and not pacc["tri_has_n"].all()


def test_surface_info_triangle_matches_pine_tpu():
    from pine_tpu.accel.unified import unified_surface_info_triangle as jinfo

    from pine_tpu_torch.accel.unified import unified_surface_info_triangle as pinfo

    jacc, pacc = _both_accels()
    rng = np.random.default_rng(5)
    g = pacc["groups"][1]
    ent = (g["base"] + rng.integers(0, len(g["prim_aabbs"]), 4096)).astype(np.int32)
    rows = pacc["ent_param"][ent]
    w = rng.dirichlet([1, 1, 1], 4096).astype(np.float32)
    p = (w[:, 0:1] * rows[:, 0:3] + w[:, 1:2] * rows[:, 3:6] + w[:, 2:3] * rows[:, 6:9]
         + rng.normal(scale=0.01, size=(4096, 3))).astype(np.float32)
    want = jinfo(jacc, jnp.asarray(ent), jnp.asarray(p))
    dev = {k: torch.from_numpy(np.asarray(v)) for k, v in pacc.items() if k != "groups"}
    got = pinfo(dev, torch.from_numpy(ent), torch.from_numpy(p))
    for gv, wv, what in zip(got, want, ("p", "n", "uv")):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL, atol=ATOL, err_msg=what)


def test_ray_sort_perm_matches_pine_tpu():
    from pine_tpu.scene.scene import _ray_sort_perm as jsort

    from pine_tpu_torch.scene.scene import _ray_sort_perm as psort

    rng = np.random.default_rng(6)
    n = 8192
    ro = rng.uniform(-5, 9, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.3, -1.0, 1.0).astype(np.float32)
    lo, span = np.array([-4.0, -1.5, 0.0], np.float32), 8.0
    jp, ji = jsort(*map(jnp.asarray, (ro, rd, tmin, tmax)), lo, span)
    pp, pi = psort(*map(torch.from_numpy, (ro, rd, tmin, tmax)), torch.from_numpy(lo), span)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (tmax[pp.numpy()[-int((tmax < 0).sum()):]] < 0).all()  # dead lanes last


def test_sorted_traversal_is_a_pure_permutation():
    sc = scenes.terrain((16, 16), 24)
    cs = sc.compile("cpu")
    rng = np.random.default_rng(8)
    n = 2048
    ro = torch.from_numpy(rng.uniform([-4, -1, 0], [4, 2, 8], (n, 3)).astype(np.float32))
    rd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)))
    dead = torch.from_numpy(rng.uniform(size=n) < 0.2)
    tmin = torch.zeros(n)
    tmax = torch.where(dead, -1.0, 3.4e38)
    from pine_tpu_torch.scene.scene import _ray_sort_perm

    perm = _ray_sort_perm(ro, rd, tmin, tmax, cs.world_lo, cs.world_span)
    plain = cs.intersect(ro, rd, tmin, tmax)
    srt = cs.intersect(ro, rd, tmin, tmax, sort_perm=perm)
    assert plain[2].sum() > 100
    for a, b in zip(plain, srt):
        assert torch.equal(a, b)
    occ = cs.any_hit(ro, rd, tmin, torch.where(dead, -1.0, 2.0))
    assert torch.equal(occ, cs.any_hit(ro, rd, tmin, torch.where(dead, -1.0, 2.0), sort_perm=perm))


def test_mesh_shapes_match_pine_tpu():
    rng = np.random.default_rng(9)
    hm = rng.uniform(size=(9, 6))
    jm, pm = JS.heightmap_from_array(hm), PS.heightmap_from_array(hm)
    np.testing.assert_array_equal(pm.vertices, jm.vertices)
    np.testing.assert_array_equal(pm.indices, jm.indices)
    assert pm.num_triangles() == jm.num_triangles()
    assert pm.area() == jm.area()
    np.testing.assert_array_equal(PS.triangle_areas(pm.triangles()), jm.triangle_areas())
    for a, b in zip(pm.get_aabb(), jm.get_aabb()):
        np.testing.assert_array_equal(a, b)


def test_mesh_light_matches_pine_tpu():
    from pine_tpu.scene import lights as JL
    from pine_tpu.scene import materials as JM

    from pine_tpu_torch.scene import lights as PL

    V, F = scenes.make_terrain(10)
    V = V * np.float32(0.3) + np.float32([0.0, 3.0, 0.0])
    color = np.float32([5.0, 4.0, 3.0])
    jl = JL.AreaLight(JS.Mesh(V, F), JM.Emissive(color), 2)
    pl = PL.MeshLight(PS.Mesh(V, F).triangles(), 2, torch.from_numpy(color), "cpu")
    rng = np.random.default_rng(10)
    n = 4096
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    u1 = rng.uniform(size=n).astype(np.float32)
    ctx = dict(p=jnp.asarray(p), n=jnp.zeros((n, 3)), uv=jnp.zeros((n, 2)))
    want = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u1), ctx)
    got = pl.sample(*map(torch.from_numpy, (p, u2, u1)))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any() and not got["valid"].all()
    for k in ("le", "wo", "distance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the pdf divides by |cos| at the light, a cancellation near grazing
    np.testing.assert_allclose(got["pdf"].numpy(), np.asarray(want["pdf"]), rtol=1e-4)
    assert pl.area == jl.shape.area()


def test_light_pdf_at_an_emissive_mesh_matches_pine_tpu():
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene.scene import Scene as JScene

    from pine_tpu_torch.scene import materials as PM
    from pine_tpu_torch.scene.scene import Scene

    V, F = scenes.make_terrain(10)
    js, ps = JScene(), Scene()
    js.add(JS.Sphere([0, 0, 0], 1.0), JM.Diffuse([0.5, 0.5, 0.5]))
    js.add(JS.Mesh(V, F), JM.Emissive([4.0, 4.0, 4.0]))
    ps.add(PS.Sphere([0, 0, 0], 1.0), PM.Diffuse([0.5, 0.5, 0.5]))
    ps.add(PS.Mesh(V, F), PM.Emissive([4.0, 4.0, 4.0]))
    jcs, pcs = js.compile(), ps.compile("cpu")
    rng = np.random.default_rng(11)
    n = 1024
    gidx = rng.integers(0, 2, n).astype(np.int32)
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t = rng.uniform(0.1, 4, n).astype(np.float32)
    ns = rng.normal(size=(n, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=1, keepdims=True)
    want = jcs.light_pdf_at_hit(*map(jnp.asarray, (gidx, ro, rd, t, ns)))
    got = pcs.light_pdf_at_hit(*map(torch.from_numpy, (gidx, ro, rd, t, ns)))
    assert (np.asarray(want)[gidx == 1] > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
