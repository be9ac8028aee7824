"""The slice as a whole: pine_tpu_torch renders what pine_tpu renders.

1. The reduced benchmark box (bench.py's script with the cone loops cut to
   x in -0.3 ~ 0.1 ~ 0.3, z in 0.5 ~ 0.1 ~ 1.0: 36 cones, 44 prims, the same
   three groups as the full box: dense rect, dense OBB, a 40-row cone lattice)
   at 32x32, BlueSampler(4), depth 4.  pine_tpu renders it on the JAX CPU
   path; the port renders pine_tpu's compiled scene, carried across by
   pine_tpu_torch.convert, on the CPU (the plain traversal).
   Measured: 99.6 % of pixels agree to 1e-3 relative or 1e-4 absolute, the
   image means differ by 1e-4 relative, traced rays by 2 in 20,782.
   Held to: 97 % of pixels, means to 1 %, traced rays to 0.5 %.
2. The reduced mesh benchmark (bench_mesh.py's terrain at grid 40: 3,042
   triangles, the grid traversal with its coarse level, plus the rect light)
   at 32x32, BlueSampler(4), depth 4: pine_tpu's compiled scene carried
   across by convert, and the port's own Scene API (scenes.terrain), each
   against pine_tpu's render.  Measured: 100 % of pixels agree and the
   traced rays are equal (12,736) both ways.  The same criteria.
3. The reduced cone forest (``scenes.CONE_FOREST_PRL`` with its loops cut to
   24 x 24 = 576 cones in the middle of the floor, ``scenes.REDUCED_FOREST``:
   still one lattice group over 512 rows, so the lattice traversal) at
   48x48, BlueSampler(4), depth 3, each package running the script through
   its own PRL interpreter.  Measured: 98.9 % of pixels agree, the means
   differ by 4e-5 relative, traced rays by 1 in 36,704.  The same criteria.
   The same field at the floor's front edge agrees on 96.7 %, and 484 cones
   at that edge, which take no lattice traversal in either package, on
   97.1 %: the differing pixels lie in the bottom eighth of the image, whose
   rays meet the floor between its front edge and z = 1.3, whichever
   traversal the port takes there
   (``test_front_edge_differences_are_not_the_lattice``).
4. A scene of 24 or fewer prims (no accel: each prim type's table one group
   on the dense route, ``dense_plain`` on the CPU) through
   each package's own Scene API and PathIntegrator, with a point light and
   every ported material; the same criteria.  Measured: 99.8 % of pixels
   agree, the means differ by 4e-4 relative.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REDUCED = ((-0.3, 0.1, 0.3), (0.5, 0.1, 1.0))


def differing(got, want):
    """Mask of the pixels whose three channels do not all agree to 1e-3
    relative or 1e-4 absolute."""
    d = np.abs(got - want)
    return ~((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1)


def agreement(got, want):
    """Share of pixels whose three channels agree to 1e-3 relative or 1e-4 absolute."""
    return 1.0 - float(differing(got, want).mean())


def assert_renders_agree(got, want, rays_got=None, rays_want=None):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert agreement(got, want) >= 0.97, agreement(got, want)
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    if rays_want is not None:
        assert abs(rays_got - rays_want) <= 0.005 * rays_want


def jax_inst_group(g):
    """One of pine_tpu's lazy instanced groups in pine_tpu_torch.convert's
    ``inst.<i>.*`` format: its mesh rows, leaf order, instance tree and
    instance order as they are."""
    npz = g["inst_np"]
    out = {k: np.asarray(g[k]) for k in ("tid", "vbase", "stride", "n_tris", "n_inst", "tri_n",
                                          "tri_t", "tri_has_n", "tri_has_t")}
    out.update({k: np.asarray(npz[k]) for k in ("ic_lower", "ic_upper", "ic_node", "ic_start",
                                                 "ic_count", "iboxes")})
    out.update(rows=g["mesh"]["rows_np"], prim_aabbs=g["mesh"]["_prim_aabbs"],
               minv=np.asarray(g["inst_minv"]), m=np.asarray(g["inst_m"]),
               gidx=np.asarray(g["inst_gidx"]))
    return out


def jax_scene_arrays(cs, cam):
    """pine_tpu's CompiledScene flattened to pine_tpu_torch.convert's format:
    the same rows in the same (native SAH) order, the mesh attribute tables,
    lazy instanced groups, materials (their node trees and images), lights
    (mesh, spot and environment lights too), camera and world bounds."""
    from pine_tpu.scene import lights as JL
    from pine_tpu.scene import shapes as JS

    from pine_tpu_torch.convert import carry_lattice, light_record, material_record, param_record

    a = dict(g_type=cs.g_type, g_local=cs.g_local, g_mat=cs.g_mat)
    for tid, table in cs.tables.items():
        a[f"table.{tid}"] = np.asarray(table)
        a[f"type_global.{tid}"] = np.asarray(cs.type_global[tid])
    groups = [g for g in cs.unified["groups"] if g["kind"] != "instanced"] if cs.unified else []
    a["n_groups"] = np.asarray(len(groups))
    for i, g in enumerate(groups):
        a.update({
            f"group.{i}.tid": np.asarray(g["tid"]), f"group.{i}.kind": np.asarray(g["kind"]),
            f"group.{i}.base": np.asarray(g["base"]), f"group.{i}.rows": g["rows_np"],
            f"group.{i}.prim_aabbs": g["_prim_aabbs"],
            f"group.{i}.lattice": carry_lattice(g.get("lattice")),
        })
        if g["kind"] == "bvh":  # the SAH tree, which the BVH walk reads
            a.update({f"group.{i}.{k}": np.asarray(v) for k, v in g["nodes_np"].items()})
    inst_groups = cs.unified.get("inst_groups", []) if cs.unified else []
    a["n_inst_groups"] = np.asarray(len(inst_groups))
    for i, g in enumerate(inst_groups):
        a.update({f"inst.{i}.{k}": v for k, v in jax_inst_group(g).items()})
    if cs.unified:
        a["ent_gidx"] = np.asarray(cs.unified["ent_gidx"])
        for k in ("ent_param", "geom_n", "tri_n", "tri_t", "tri_has_n", "tri_has_t"):
            if k in cs.unified and cs.meshes:
                a[k] = np.asarray(cs.unified[k])
    a["world_lo"] = np.asarray(cs.world_lo, np.float32)
    a["world_span"] = np.asarray(cs.world_span)
    a["n_materials"] = np.asarray(len(cs.materials))
    images = []
    for i, m in enumerate(cs.materials):
        a.update({f"mat.{i}.{k}": v for k, v in material_record(m, images).items()})
    a["n_lights"] = np.asarray(len(cs.lights))
    for i, li in enumerate(cs.lights):
        if isinstance(li, JL.AreaLight) and isinstance(li.shape, JS.Mesh):
            f = li.shape.indices.astype(np.int64)
            a.update({
                f"light.{i}.kind": np.asarray("mesh"),
                f"light.{i}.tris": np.concatenate([li.shape.vertices[f[:, k]] for k in range(3)], 1),
                f"light.{i}.gidx": np.asarray(li.global_idx),
                **{f"light.{i}.{k}": v
                   for k, v in param_record("color", li.material.color, images).items()},
            })
        elif isinstance(li, JL.AreaLight):
            a.update({
                f"light.{i}.kind": np.asarray("area"),
                f"light.{i}.tid": np.asarray(li.shape.type_id),
                f"light.{i}.params": li.shape.params(),
                f"light.{i}.gidx": np.asarray(li.global_idx),
                **{f"light.{i}.{k}": v
                   for k, v in param_record("color", li.material.color, images).items()},
            })
        else:  # point, spot, directional and environment lights
            a.update({f"light.{i}.{k}": np.asarray(v) for k, v in light_record(li).items()})
    a["n_images"] = np.asarray(len(images))
    a.update({f"image.{k}": im for k, im in enumerate(images)})
    cp = cam.params()
    for k in ("position", "rot", "fov2d", "len_radius", "focus_distance"):
        a[f"cam.{k}"] = np.asarray(cp[k])
    return a


def test_reduced_cbox_matches_pine_tpu():
    import bench
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    (x0, dx, x1), (z0, dz, z1) = REDUCED
    src = (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}")
           .replace("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}"))
    itp = Interpreter()
    itp.run(src, "<reduced cbox>")
    scene = itp.get_var("scene")
    jcs = scene.compile()
    assert jcs.n_global == 44
    assert [(g["tid"], g["kind"], g["rows_np"].shape[0], g.get("lattice") is not None)
            for g in jcs.unified["groups"]] == [(1, "dense", 6, False), (5, "dense", 2, False),
                                                (7, "bvh", 40, True)]
    want, jstats = jax_render(jcs, scene.camera, 32, 32, JBlue(4), 4, 4, return_stats=True)

    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, scene.camera), "cpu")
    got, pstats = render_wavefront(pcs, None, 32, 32, BlueSampler(4), 4, 4, return_stats=True)
    assert_renders_agree(got.numpy(), np.asarray(want),
                         pstats["traced_rays"], float(jstats["traced_rays"]))


@pytest.fixture(scope="module")
def jax_terrain():
    """bench_mesh's terrain cut to grid 40 (3,042 triangles, so the triangle
    group takes the grid traversal with its coarse level) built through
    pine_tpu's Scene API, and pine_tpu's render of it at 32x32, 4 spp, depth
    4 -> (scene, compiled scene, image, traced rays)."""
    import bench_mesh
    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene import shapes as JS
    from pine_tpu.scene.scene import Scene

    V, F = bench_mesh.make_terrain(40)
    scene = Scene()
    scene.add("ground", JM.Diffuse([0.75, 0.7, 0.6]))
    scene.add(JS.Mesh(V, F), "ground")
    scene.add(JS.Rect([0.0, 6.0, 4.0], [1.5, 0, 0], [0, 0, 1.5]),
              JM.Emissive(np.asarray([300.0, 290.0, 260.0], np.float32)))
    hmax = float(V[:, 1].max())
    scene.set(ThinLenCamera(Film([32, 32], "uncharted2"), [0.0, hmax * 0.55, 0.8],
                            [0.5, 0.2, 5.5], 0.7))
    jcs = scene.compile()
    img, stats = jax_render(jcs, scene.camera, 32, 32, JBlue(4), 4, 4, return_stats=True)
    return scene, jcs, np.asarray(img), float(stats["traced_rays"])


def test_reduced_terrain_matches_pine_tpu(jax_terrain):
    """pine_tpu's compiled terrain carried across by convert: the same rows in
    the same order, rendered by the port on the CPU (grid_plain)."""
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene, jcs, want, rays_want = jax_terrain
    a = jax_scene_arrays(jcs, scene.camera)
    assert [(int(a[f"group.{i}.tid"]), a[f"group.{i}.rows"].shape[0]) for i in range(2)] == [
        (1, 1), (6, 3046)]
    pcs = compiled_scene_from_arrays(a, "cpu")
    assert "grid" in pcs.unified["groups"][1] and pcs.unified["groups"][1]["grid"]["use_coarse"]
    got, pstats = render_wavefront(pcs, None, 32, 32, BlueSampler(4), 4, 4, return_stats=True)
    assert_renders_agree(got.numpy(), want, pstats["traced_rays"], rays_want)


def test_reduced_terrain_forced_bvh_matches_pine_tpu(jax_terrain, monkeypatch):
    """pine_tpu's compiled terrain carried across by convert, rows and SAH
    tree, its triangle group forced onto the BVH walk (``mesh_kernel``, with
    GRID_MAX_PRIMS cut so that its 3,042 triangles are mesh-scale) and
    rendered by the port on the CPU (supercell_plain) against pine_tpu's
    render."""
    from pine_tpu_torch.accel import dense_traverse as DT
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene, jcs, want, rays_want = jax_terrain
    monkeypatch.setattr(DT, "GRID_MAX_PRIMS", 1024)
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, scene.camera), "cpu",
                                     mesh_kernel="bvh")
    assert [g["variant"] for g in pcs.unified["groups"]] == ["dense", "bvh"]
    nodes = jcs.unified["groups"][1]["nodes_np"]
    assert pcs.unified["groups"][1]["bvh"]["nodes"].shape[0] == len(nodes["c_node"])
    got, pstats = render_wavefront(pcs, None, 32, 32, BlueSampler(4), 4, 4, return_stats=True)
    assert_renders_agree(got.numpy(), want, pstats["traced_rays"], rays_want)


def test_terrain_scene_api_matches_pine_tpu(jax_terrain):
    """The same terrain through the port's own Scene API (scenes.terrain, the
    port's SAH builder) against pine_tpu's render."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import PathIntegrator, render_wavefront

    _, jcs, want, rays_want = jax_terrain
    scene = scenes.terrain((32, 32), 40)
    cs = scene.compile("cpu")
    np.testing.assert_array_equal(cs.unified["ent_gidx"].numpy(),
                                  np.asarray(jcs.unified["ent_gidx"]))
    got, pstats = render_wavefront(cs, scene.camera, 32, 32, BlueSampler(4), 4, 4,
                                   return_stats=True)
    assert_renders_agree(got.numpy(), want, pstats["traced_rays"], rays_want)
    film = PathIntegrator(BlueSampler(1), 2).render(scenes.terrain((8, 8), 12), device="cpu")
    assert np.isfinite(film.pixels).all() and film.pixels[..., :3].mean() > 0


def forest_renders(field, offset=0, size=48):
    """A reduced cone forest (``scenes.cone_forest_prl`` over ``field``),
    each package running the script through its own PRL interpreter:
    pine_tpu's render at BlueSampler(4), depth 3, from sample ``offset`` ->
    (image, traced rays, the port's compiled scene, a function rendering it
    the same way -> (image, stats))."""
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    src = scenes.cone_forest_prl(*field, size=size)
    itp = Interpreter()
    itp.run(src, "<reduced cone forest>")
    jscene = itp.get_var("scene")
    want, jstats = jax_render(jscene.compile(), jscene.camera, size, size, JBlue(4), 4, 3,
                              return_stats=True, sample_offset=offset)
    scene = scenes.prl_scene(src)
    cs = scene.compile("cpu")

    def render():
        img, stats = render_wavefront(cs, scene.camera, size, size, BlueSampler(4), 4, 3,
                                      return_stats=True, sample_offset=offset)
        return img.numpy(), stats

    return np.asarray(want), float(jstats["traced_rays"]), cs, render


def group_variants(cs):
    return [(g["tid"], g["rows"].shape[0], g["variant"]) for g in cs.unified["groups"]]


def test_reduced_cone_forest_matches_pine_tpu():
    from pine_tpu_torch import scenes

    want, rays_want, cs, render = forest_renders(scenes.REDUCED_FOREST)
    assert group_variants(cs) == [(1, 6, "dense"), (5, 2, "dense"), (7, 580, "lattice")]
    got, pstats = render()
    assert_renders_agree(got, want, pstats["traced_rays"], rays_want)


# the reduced forest moved to the floor's front edge (its first row of cones
# at z = 0, the floor rect's edge), and 22 x 22 = 484 cones at the same edge,
# which take the dense traversal in both packages
FRONT_EDGE = ((-0.6, 0.05, 0.56), (0.0, 0.05, 1.16))
FRONT_EDGE_DENSE = ((-0.5, 0.05, 0.56), (0.0, 0.05, 1.06))


@pytest.mark.parametrize("offset", [0, 4])
def test_front_edge_differences_are_not_the_lattice(offset):
    """At the floor's front edge the port and pine_tpu agree on fewer pixels
    than the 97 % gate of the cases above, and not because of the lattice
    traversal.  The port's lattice and dense routes give the same image, so
    the same pixels differ from pine_tpu's render either way; and 484 cones at
    the same edge, which no package sends to the lattice traversal, differ
    from pine_tpu on as many pixels.  (pine_tpu's CPU render has no lattice
    route: its XLA packet walk sweeps the group's stored rows.)  Measured at
    sample offsets 0 / 4: the lattice field 96.66 / 96.57 % of pixels, the
    dense one 97.14 / 97.09 %, the differing pixels nearly all in the bottom
    eighth of the image, whose rays meet the floor between its front edge
    and z = 1.3.
    Held to: the two routes agree on every pixel with equal traced rays,
    differ from pine_tpu on the same pixels, the two fields' shares within 1 %
    of each other and over 95 %, means to 1 %, traced rays to 0.5 %."""
    want, rays_want, cs, render = forest_renders(FRONT_EDGE, offset)
    assert group_variants(cs) == [(1, 6, "dense"), (5, 2, "dense"), (7, 580, "lattice")]
    lat, lat_stats = render()
    cs.small_kernel = "dense"  # pine_tpu's PINE_SMALL_KERNEL=dense
    assert group_variants(cs) == [(1, 6, "dense"), (5, 2, "dense"), (7, 580, "dense")]
    dense, dense_stats = render()
    assert agreement(lat, dense) == 1.0 and lat_stats == dense_stats
    np.testing.assert_array_equal(differing(lat, want), differing(dense, want))
    assert abs(lat.mean() - want.mean()) <= 0.01 * abs(want.mean())
    assert abs(lat_stats["traced_rays"] - rays_want) <= 0.005 * rays_want

    want_d, rays_want_d, cs_d, render_d = forest_renders(FRONT_EDGE_DENSE, offset)
    assert group_variants(cs_d) == [(1, 6, "dense"), (5, 2, "dense"), (7, 488, "dense")]
    got_d, stats_d = render_d()
    shares = agreement(lat, want), agreement(got_d, want_d)
    # image row 0 is the bottom of the frame
    low = [float(m[: m.shape[0] // 8].sum() / m.sum())
           for m in (differing(lat, want), differing(got_d, want_d))]
    print(f"front edge, offset {offset}: lattice field {shares[0]:.4f}, dense field "
          f"{shares[1]:.4f} of pixels agree with pine_tpu; of those differing, "
          f"{low[0]:.3f} and {low[1]:.3f} in the bottom eighth")
    assert min(shares) >= 0.95 and abs(shares[0] - shares[1]) <= 0.01
    assert min(low) >= 0.9
    assert abs(got_d.mean() - want_d.mean()) <= 0.01 * abs(want_d.mean())
    assert abs(stats_d["traced_rays"] - rays_want_d) <= 0.005 * rays_want_d


def _small_scene(S, M, L, Scene, Camera, Film):
    scene = Scene()
    scene.add("white", M.Diffuse([0.8, 0.8, 0.8]))
    scene.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "white")
    scene.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "white")
    scene.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), M.Diffuse([0.9, 0.1, 0.05]))
    scene.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), M.Diffuse([0.2, 0.9, 0.05]))
    scene.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "white")
    scene.add(S.Sphere([-0.4, 0.35, 1.2], 0.35), M.Glass([1, 1, 1], 0.0, 1.5))
    scene.add(S.Sphere([0.45, 0.3, 0.9], 0.3), M.Metal([0.9, 0.8, 0.6], 0.3))
    scene.add(S.Disk([0.0, 0.01, 0.5], [0, 1, 0], 0.2), M.Glossy([0.5, 0.5, 0.5], 0.2))
    scene.add(S.Cylinder([0.6, 0, 1.5], [0.6, 0.6, 1.5], 0.1), "white")
    scene.add(S.Rect([0.0, 1.95, 1.0], [0.3, 0, 0], [0, 0, 0.3]), M.Emissive([12.0, 10.0, 8.0]))
    scene.add(L.PointLight([0.0, 1.5, 0.2], [1.0, 1.0, 1.0]))
    scene.set(Camera(Film([24, 24]), [0, 1, -3], [0, 1, 0], 0.35))
    return scene


def test_small_scene_path_integrator_matches_pine_tpu():
    from pine_tpu.core.camera import ThinLenCamera as JCam
    from pine_tpu.core.film import Film as JFilm
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.integrators.path import PathIntegrator as JPath
    from pine_tpu.scene import lights as JL
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene import shapes as JS
    from pine_tpu.scene.scene import Scene as JScene

    from pine_tpu_torch.core.camera import ThinLenCamera
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.scene import lights as L
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    jscene = _small_scene(JS, JM, JL, JScene, JCam, JFilm)
    assert jscene.compile().unified is None
    want = JPath(JUniform(4), 3).render(jscene).pixels[..., :3]
    pscene = _small_scene(S, M, L, Scene, ThinLenCamera, Film)
    film = PathIntegrator(UniformSampler(4), 3).render(pscene, device="cpu")
    assert pscene.compile("cpu").unified is None
    assert_renders_agree(film.pixels[..., :3], want)


def test_film_saves_png(tmp_path):
    from PIL import Image

    from pine_tpu_torch.core.film import Film

    film = Film([8, 4])
    rgb = torch.linspace(0, 2, 8 * 4 * 3).reshape(4, 8, 3)
    film.set_rgb(rgb)
    film.save(str(tmp_path / "f.png"))
    img = np.asarray(Image.open(tmp_path / "f.png"))
    assert img.shape == (4, 8, 3)
    want = np.clip(film.finalized(), 0, 1) ** (1 / 2.2) * 255 + 0.5
    np.testing.assert_array_equal(img, want.astype(np.uint8)[::-1])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from pine_tpu_torch import scenes

    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenes.cbox((8, 8)).compile()


def test_unported_features_are_refused():
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    def compile_with(shape, mat):
        scene = Scene()
        scene.add(shape, mat)
        return scene.compile("cpu")

    sphere = S.Sphere([0, 0, 0], 1.0)
    # Subsurface is ported now: it compiles into a material record of its own tag
    cs = compile_with(sphere, M.Subsurface([1, 1, 1], 0.0, 40.0))
    assert cs.materials[0]["tag"] == M.SUBSURFACE and cs.has_subsurface
    # Uber is ported now: it compiles into a material record of its own tag
    assert compile_with(sphere, M.Uber([1, 1, 1], 0.5)).materials[0]["tag"] == M.UBER
    # media, CSG trees and SDFs are ported now: they compile into lists of their own
    from pine_tpu_torch.scene import media as Med

    scene = Scene()
    scene.add(sphere - S.BoxAABB([0, 0, 0], [1, 1, 1]), M.Diffuse([1, 1, 1]))
    scene.add(S.SDFShape([0, 0, 0], [1, 1, 1], lambda p: p.norm(dim=-1) - 0.5),
              M.Diffuse([1, 1, 1]))
    scene.add(Med.HomogeneousMedium(S.Sphere([0, 0, 0], 2.0), Med.HgPhaseFunction(0.3), [0.1] * 3,
                                    [0.2] * 3))
    scene.add(Med.GridMedium(np.ones((8, 8, 8), np.float32), np.eye(4), Med.HgPhaseFunction(0.0),
                             0.5, 1.0))
    cs = scene.compile("cpu")
    assert [len(x) for x in (cs.csg_shapes, cs.sdf_shapes, cs.media, cs.grid_media)] == [1] * 4
    with pytest.raises(TypeError, match="Scene.add"):  # instancing is ported too
        Scene().add(object())
    with pytest.raises(TypeError, match="interval"):  # a CSG child with no interval test
        compile_with(sphere + S.Disk([0, 0, 0], [0, 1, 0], 1.0), M.Diffuse([1, 1, 1]))
    # meshes are ported now: a one-triangle mesh compiles into a triangle group
    tri = S.Mesh(np.eye(3, dtype=np.float32), [[0, 1, 2]])
    groups = compile_with(tri, M.Diffuse([1, 1, 1])).unified["groups"]
    assert [(g["tid"], g["kind"]) for g in groups] == [(S.TRIANGLE, "dense")]
    # script functions as nodes are ported: a callable is a Function node, as
    # pine_tpu's Function of the same callable
    from pine_tpu.scene import nodes as JN
    from test_torch_lambdas import values_agree

    values_agree(M.Diffuse(lambda ctx: ctx["p"][..., 0] * 0.5).albedo,
                 JN.Function(lambda ctx: ctx["p"][..., 0] * 0.5))
    with pytest.raises(TypeError, match="Scene.set"):  # environment lights are ported now
        Scene().set(object())
