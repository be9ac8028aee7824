"""Lazy instancing in pine_tpu_torch against pine_tpu, on the CPU.

- Scene model: ``Scene.add(InstancedShape)`` flattens or stays lazy where
  pine_tpu does (FLATTEN_LIMIT, monkeypatched as tests/test_instancing.py
  does; emissive instances always flatten); a lazy group stores the mesh
  once (T + 4 rows) and one geometry per instance; the flattened and the
  lazy form of one scene give the same hits (t to rtol/atol 2e-4, as
  tests/test_instancing.py, normals to a dot of 0.999) and occlusion.
- Build: the instanced group (vbase, stride, rows in leaf order, instance
  tree, iboxes, minv, m, gidx in its order, attribute tables), the
  supercell tree of accel/sctree.py against ``_sc_tree_layout`` on the
  4,802-triangle rock, and the stack need against ``_stack_need`` (81 and
  117 on the benchmark's 32x32 and 101x101 fields): all equal.
- Decoding: ``ent_to_gidx`` equal; ``instanced_surface_info`` normals to a
  dot of 0.999, uvs to atol 1e-4 (float32 sums in another order).
- The origin-mode coherence sort gives pine_tpu's permutation lane for lane;
  with ``origin_sort`` set the scene picks it where pine_tpu does (it is off
  by default: on the H100 it cost more than it saved); a render with it
  equals the unsorted render bit for bit, depth 0 unsorted.
- ``scenes.instanced`` is ``bench_instanced.build_scene`` to the bit.
- Render: a reduced rock field (3x3 instances of ``make_rock(12)``, 242
  triangles) at 64x64, BlueSampler(4), depth 3, through pine_tpu's compiled
  scene carried across by convert and through the port's own Scene API,
  each against pine_tpu's render, with tests/test_torch_render.py's
  criteria.  Measured: 100 % of pixels agree, the means are equal and so are
  the traced rays (40,160), both ways.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pine_tpu.scene.scene as jscene_mod
from pine_tpu.accel import packet as JPK
from pine_tpu.scene import materials as JM
from pine_tpu.scene import shapes as JS
from pine_tpu_torch import scenes
from pine_tpu_torch.accel import inst_traverse as IT
from pine_tpu_torch.accel import packet as PPK
from pine_tpu_torch.scene import materials as PM
from pine_tpu_torch.scene import scene as pscene_mod
from pine_tpu_torch.scene import shapes as PS
from test_torch_render import assert_renders_agree, jax_inst_group, jax_scene_arrays

torch.set_num_threads(2)

SIDE, ROCK = 3, 12  # the reduced field: 9 instances of a 242-triangle rock


def jax_field(size, n_side=SIDE, rock_grid=ROCK, emissive=False):
    """bench_instanced.build_scene's field, cut, through pine_tpu's Scene."""
    import bench_instanced
    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film

    V, F = bench_instanced.make_rock(rock_grid)
    sc = jscene_mod.Scene()
    sc.add(JS.Plane([0, -0.1, 0], [0, 1, 0]), JM.Diffuse([0.55, 0.5, 0.45]))
    inst = JS.InstancedShape(JS.Mesh(V, F))
    mat = JM.Emissive([1.0, 1.0, 1.0]) if emissive else JM.Diffuse([0.6, 0.55, 0.5])
    for m in scenes.rock_transforms(n_side):
        inst.add(m, mat)
    sc.add(inst)
    sc.add(JS.Rect([0, 30, 20], [6, 0, 0], [0, 0, 6]),
           JM.Emissive(np.asarray([400.0, 390.0, 360.0], np.float32)))
    sc.set(ThinLenCamera(Film([size, size], "uncharted2"), [0.0, 6.0, -6.0], [0.0, 0.5, 14.0], 0.7))
    return sc


@pytest.fixture
def lazy(monkeypatch):
    """Both packages keep every mesh instancing lazy."""
    monkeypatch.setattr(jscene_mod, "FLATTEN_LIMIT", 0)
    monkeypatch.setattr(pscene_mod, "FLATTEN_LIMIT", 0)


@pytest.fixture(scope="module")
def jax_render():
    """pine_tpu's reduced field at 64x64, 4 spp, depth 3 on its CPU path ->
    (compiled scene, camera, image, traced rays)."""
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront

    mp = pytest.MonkeyPatch()
    mp.setattr(jscene_mod, "FLATTEN_LIMIT", 0)
    try:
        sc = jax_field(64)
        jcs = sc.compile()
    finally:
        mp.undo()
    img, stats = render_wavefront(jcs, sc.camera, 64, 64, JBlue(4), 4, 3, return_stats=True)
    return jcs, sc.camera, np.asarray(img), float(stats["traced_rays"])


@pytest.mark.parametrize("limit, emissive, want_lazy", [
    (0, False, True), (10**9, False, False), (0, True, False)])
def test_flatten_or_lazy_as_pine_tpu(limit, emissive, want_lazy, monkeypatch):
    monkeypatch.setattr(jscene_mod, "FLATTEN_LIMIT", limit)
    monkeypatch.setattr(pscene_mod, "FLATTEN_LIMIT", limit)
    js = jax_field(8, emissive=emissive)
    ps = scenes.instanced((8, 8), SIDE, ROCK)
    if emissive:
        ps = pscene_mod.Scene()
        inst = PS.InstancedShape(PS.Mesh(*scenes.make_rock(ROCK)))
        for m in scenes.rock_transforms(SIDE):
            inst.add(m, PM.Emissive([1.0, 1.0, 1.0]))
        ps.add(inst)
    assert bool(js.instancings) == bool(ps.instancings) == want_lazy
    n_mesh = sum(isinstance(s, PS.Mesh) for s, _ in ps.geometries)
    assert n_mesh == sum(isinstance(s, JS.Mesh) for s, _ in js.geometries) == (
        0 if want_lazy else SIDE * SIDE)
    if not want_lazy:  # flattened: the instances' transformed meshes, bit for bit
        jm = [s for s, _ in js.geometries if isinstance(s, JS.Mesh)]
        pm = [s for s, _ in ps.geometries if isinstance(s, PS.Mesh)]
        for a, b in zip(pm, jm):
            np.testing.assert_array_equal(a.vertices, b.vertices)


def test_lazy_memory_is_o_mesh(lazy):
    cs = scenes.instanced((8, 8), 10, ROCK).compile("cpu")
    (g,) = cs.unified["inst_groups"]
    assert (g["n_inst"], g["n_tris"], g["rows"].shape[0]) == (100, 242, 242 + 4)
    assert [(x["kind"], x["tid"]) for x in cs.unified["groups"]] == [("dense", 1), ("dense", 3)]
    assert cs.n_global == 100 + 2 and cs.unified["ent_gidx"].shape[0] == 2 + 4
    assert (cs.g_type[2:] == PS.MESH_TYPE).all() and (cs.g_local[2:] == 0).all()
    assert not cs.heavy_traversal and cs.inst_traversal


def test_flattened_and_lazy_hit_the_same(monkeypatch):
    rng = np.random.default_rng(3)
    n = 2048
    ro = torch.from_numpy(np.tile([[0.0, 3.0, -4.0]], (n, 1)).astype(np.float32))
    tgt = np.stack([rng.uniform(-3.5, 2, n), rng.uniform(-0.2, 0.8, n), rng.uniform(1, 6, n)], -1)
    rd = torch.nn.functional.normalize(torch.from_numpy(tgt.astype(np.float32)) - ro)
    tmin, tmax = torch.zeros(n), torch.full((n,), 3.4e38)
    out = {}
    for limit in (10**9, 0):
        monkeypatch.setattr(pscene_mod, "FLATTEN_LIMIT", limit)
        cs = scenes.instanced((8, 8), SIDE, ROCK).compile("cpu")
        assert bool(cs.unified["inst_groups"]) == (limit == 0)
        t, g, hit, tri = cs.intersect(ro, rd, tmin, tmax)
        _, nrm, _ = cs.surface_info(g, ro + torch.where(hit, t, 1.0)[:, None] * rd, tri)
        occ = cs.any_hit(ro, rd, tmin, torch.where(hit, t + 1.0, 3.4e38))
        out[limit] = (t, hit, nrm, occ)
    (t_f, h_f, n_f, o_f), (t_l, h_l, n_l, o_l) = out[10**9], out[0]
    assert torch.equal(h_f, h_l) and h_f.sum() > 500
    torch.testing.assert_close(t_l[h_f], t_f[h_f], rtol=2e-4, atol=2e-4)
    assert ((n_f * n_l).sum(-1)[h_f] > 0.999).all()
    assert torch.equal(o_f, o_l)


def test_build_matches_pine_tpu(lazy, jax_render):
    """The port's own scene arrays equal pine_tpu's compiled reduced field."""
    from pine_tpu_torch.convert import scene_arrays

    jcs, cam, _, _ = jax_render
    a = scene_arrays(scenes.instanced((64, 64), SIDE, ROCK))
    want = jax_scene_arrays(jcs, cam)
    assert int(a["n_inst_groups"]) == 1 and int(a["n_groups"]) == 2
    for k in ("g_type", "g_local", "g_mat", "ent_gidx", "world_lo", "world_span"):
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    for k, v in jax_inst_group(jcs.unified["inst_groups"][0]).items():
        np.testing.assert_array_equal(a[f"inst.0.{k}"], v, err_msg=k)
    assert int(a["inst.0.vbase"]) == 2 + 4 and int(a["inst.0.stride"]) == 242 + 4


def test_sctree_layout_matches_pine_tpu(lazy):
    """accel/sctree.py on the benchmark's 4,802-triangle rock, fed pine_tpu's
    leaf-order prim boxes, against _sc_tree_layout."""
    from pine_tpu.accel import pallas_traverse as PT

    from pine_tpu_torch.accel.sctree import sc_tree_layout

    (g,) = jax_field(8, 2, 50).compile().unified["inst_groups"]
    want = PT._sc_tree_layout(g["mesh"])
    got = sc_tree_layout(g["mesh"]["_prim_aabbs"])
    assert (got["n_prims"], got["n_super"], got["depth"]) == (4802, 38, want["depth"]) == (
        4802, 38, 5)
    for k in ("boxes", "cnode", "cstart", "ccount", "sc_order", "cell_boxes"):
        np.testing.assert_array_equal(got[k].ravel(), np.asarray(want[k]), err_msg=k)
    sc = np.asarray(PT._grid_layout(g["mesh"])["sc_boxes"]).reshape(-1, 6)
    np.testing.assert_array_equal(got["sc_boxes"], sc[:38])


@pytest.mark.parametrize("n_side, need", [(32, 81), (101, 117)])
def test_stack_need_matches_pine_tpu(n_side, need):
    """The benchmark's fields (its rock, its transforms) in both packages'
    accel builders: the same instance tree, the same need."""
    from pine_tpu.accel.instanced_kernel import _stack_need

    V, F = scenes.make_rock()
    rec = PPK.instancing_record(PS.Mesh(V, F), scenes.rock_transforms(n_side),
                                np.arange(n_side * n_side))
    (jg,) = JPK.build_packet_accel([], [], instanced=[dict(rec, mesh=JS.Mesh(V, F))])["groups"]
    (pg,) = PPK.build_packet_accel([], [], [rec])["inst_groups"]
    np.testing.assert_array_equal(pg["ic_node"], jg["inst_np"]["ic_node"])
    g = IT.upload_inst_group(pg, "cpu")
    assert g["need"] == _stack_need(jg) == need <= IT.STACK_DEPTH
    assert g["vbase"] + g["n_inst"] * g["stride"] < 2**31


def test_decoding_matches_pine_tpu():
    """ent_to_gidx and instanced_surface_info on hits spread over a field of
    a rock with vertex normals and texcoords, with regular ids mixed in."""
    from pine_tpu.accel.packet import ent_to_gidx as jgidx
    from pine_tpu.accel.packet import instanced_surface_info as jinfo

    rng = np.random.default_rng(4)
    V, F = scenes.make_rock(ROCK)
    N = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    T = rng.uniform(size=(len(V), 2)).astype(np.float32)
    rec = PPK.instancing_record(PS.Mesh(V, F, T, N), scenes.rock_transforms(SIDE),
                                np.arange(3, 3 + SIDE * SIDE))
    sphere = PS.Sphere([0, 5, 0], 1.0)
    prims = [(0, sphere.params(), 0, sphere.get_aabb())]
    jacc = JPK.build_packet_accel(prims, [], instanced=[dict(rec, mesh=JS.Mesh(V, F, T, N))])
    pacc = PPK.build_packet_accel(prims, [], [rec])
    jg = jacc["inst_groups"][0]
    for k, v in jax_inst_group(jg).items():
        np.testing.assert_array_equal(pacc["inst_groups"][0][k], v, err_msg=k)
    g = IT.upload_inst_group(pacc["inst_groups"][0], "cpu")
    dev = dict(inst_groups=[g], ent_gidx=torch.as_tensor(pacc["ent_gidx"]))
    n = 4096
    inst = rng.integers(0, g["n_inst"], n)
    tri = rng.integers(0, g["n_tris"], n)
    ent = (g["vbase"] + inst * g["stride"] + tri).astype(np.int32)
    ent[::7] = 0  # the sphere
    rows = pacc["inst_groups"][0]["rows"][tri]
    m = pacc["inst_groups"][0]["m"][inst].reshape(-1, 3, 4)
    w = rng.dirichlet([1, 1, 1], n)
    loc = w[:, 0:1] * rows[:, 0:3] + w[:, 1:2] * rows[:, 3:6] + w[:, 2:3] * rows[:, 6:9]
    p = (np.einsum("pab,pb->pa", m[:, :, :3], loc) + m[:, :, 3]).astype(np.float32)
    np.testing.assert_array_equal(PPK.ent_to_gidx(dev, torch.from_numpy(ent)).numpy(),
                                  np.asarray(jgidx(jacc, jnp.asarray(ent))))
    z3, z2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    _, n_j, uv_j = (np.asarray(x) for x in jinfo(jacc, jnp.asarray(ent), jnp.asarray(p),
                                                 jnp.asarray(p), jnp.asarray(z3), jnp.asarray(z2)))
    _, n_p, uv_p = (x.numpy() for x in PPK.instanced_surface_info(
        dev, torch.from_numpy(ent), torch.from_numpy(p), torch.from_numpy(p),
        torch.from_numpy(z3), torch.from_numpy(z2)))
    on = ent != 0
    assert ((n_j * n_p).sum(-1)[on] >= 0.999).all()
    np.testing.assert_array_equal(n_p[~on], 0.0)
    np.testing.assert_allclose(uv_p, uv_j, atol=1e-4)


def test_origin_sort_matches_pine_tpu():
    from pine_tpu.scene.scene import _ray_sort_perm as jsort

    from pine_tpu_torch.scene.scene import _ray_sort_perm as psort

    rng = np.random.default_rng(6)
    n = 8192
    ro = rng.uniform([-30, -1, 0], [30, 3, 60], (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.3, -1.0, 1.0).astype(np.float32)
    lo, span = np.array([-100.0, -100.1, -100.0], np.float32), 200.0
    jp, ji = jsort(*map(jnp.asarray, (ro, rd, tmin, tmax)), lo, span, mode="origin")
    pp, pi = psort(*map(torch.from_numpy, (ro, rd, tmin, tmax)), torch.from_numpy(lo), span,
                   "origin")
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (tmax[pp.numpy()[-int((tmax < 0).sum()):]] < 0).all()  # dead lanes last


def test_sort_mode_and_sorted_render(lazy, jax_render, monkeypatch):
    """The scene's flags and sort mode follow pine_tpu's; a render whose
    bounces run in origin-sort order equals the unsorted render bit for bit,
    and depth 0 is never sorted."""
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    jcs = jax_render[0]
    sc = scenes.instanced((16, 16), SIDE, ROCK)
    cs = sc.compile("cpu")
    assert (cs.heavy_traversal, cs.inst_traversal) == (jcs.heavy_traversal, jcs.inst_traversal) \
        == (False, True)
    assert cs.sort_mode(8192, True) is None  # off by default on the card (PERF.md, PR 3)
    cs.origin_sort = True
    assert [cs.sort_mode(n, card) for n, card in ((8192, True), (4095, True), (8192, False))] == [
        "origin", None, None]
    want = render_wavefront(cs, sc.camera, 16, 16, BlueSampler(1), 1, 3)
    seen = []
    real_mode, real_intersect = cs.sort_mode, cs.intersect
    monkeypatch.setattr(cs, "sort_mode", lambda n, on_card: real_mode(4096, True))

    def intersect(ro, rd, tmin, tmax, sort_perm=None):
        seen.append(sort_perm is not None)
        return real_intersect(ro, rd, tmin, tmax, sort_perm)

    monkeypatch.setattr(cs, "intersect", intersect)
    got = render_wavefront(cs, sc.camera, 16, 16, BlueSampler(1), 1, 3)
    assert seen == [False, True, True]
    assert torch.equal(got, want)
    heavy = scenes.terrain((8, 8), 80).compile("cpu")  # 12,482 triangles
    assert heavy.sort_mode(8192, True) == "octant" and not heavy.inst_traversal


def test_scene_matches_bench_instanced(lazy):
    import bench_instanced

    js, n_tris, n_inst = bench_instanced.build_scene(4)
    ps = scenes.instanced((512, 512), 4)
    (ji,), (pi,) = js.instancings, ps.instancings
    assert (n_tris, n_inst) == (pi.shape.num_triangles(), len(pi.instances)) == (4802, 16)
    np.testing.assert_array_equal(pi.shape.vertices, ji.shape.vertices)
    np.testing.assert_array_equal(pi.shape.indices, ji.shape.indices)
    for (mp, _), (mj, _) in zip(pi.instances, ji.instances):
        np.testing.assert_array_equal(mp, mj)
    for (sp, mp), (sj, mj) in zip(ps.geometries, js.geometries):
        np.testing.assert_array_equal(sp.params(), sj.params())
    cp, cj = ps.camera, js.camera
    for k in ("position", "c2w", "fov2d"):
        np.testing.assert_array_equal(getattr(cp, k), getattr(cj, k))
    assert cp.film.width == 512


def test_reduced_field_matches_pine_tpu(jax_render):
    """pine_tpu's compiled field carried across by convert, rendered by the
    port on the CPU (inst_plain)."""
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    jcs, cam, want, rays_want = jax_render
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, cam), "cpu")
    assert [g["n_inst"] for g in pcs.unified["inst_groups"]] == [9]
    got, st = render_wavefront(pcs, None, 64, 64, BlueSampler(4), 4, 3, return_stats=True)
    assert_renders_agree(got.numpy(), want, st["traced_rays"], rays_want)


def test_field_scene_api_matches_pine_tpu(lazy, jax_render):
    """The same field through the port's own Scene API and PathIntegrator."""
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import PathIntegrator, render_wavefront

    _, _, want, rays_want = jax_render
    sc = scenes.instanced((64, 64), SIDE, ROCK)
    cs = sc.compile("cpu")
    got, st = render_wavefront(cs, sc.camera, 64, 64, BlueSampler(4), 4, 3, return_stats=True)
    assert_renders_agree(got.numpy(), want, st["traced_rays"], rays_want)
    film = PathIntegrator(BlueSampler(1), 2).render(scenes.instanced((8, 8), 2, 8), device="cpu")
    assert np.isfinite(film.pixels).all() and film.pixels[..., :3].mean() > 0
