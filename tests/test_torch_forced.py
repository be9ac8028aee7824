"""Forced traversal kernels: ``CompiledScene.small_kernel`` and ``mesh_kernel``
(pine_tpu_torch/accel/dense_traverse.group_variant and route), the port's
counterparts of pine_tpu's ``PINE_SMALL_KERNEL`` and ``PINE_MESH_KERNEL``.

- With both settings None every group of the bench box, the terrain, the
  rock field and the cone forest takes the kernel it took before the
  settings existed.
- For each value ("dense", "scdense", "lattice", "grid", "sctree", "bvh",
  "mxu", "mxup") and each setting, the route of a table of groups (a small
  dense-kind group, a lattice over 512 rows, a mid-size group, a group over
  GRID_MAX_PRIMS and one over GRID_MAX_PRIMS_HBM, the limits cut in both
  packages) equals pine_tpu's ``_group_variant`` under the matching
  environment variable, followed by ``pallas_group_query``'s rewrites: a
  forced "lattice" on a group that is no lattice takes the size default,
  and a forced "mxu" or "mxup" stays itself on a group of at most
  GRID_MAX_PRIMS prims of a type with a coefficient table and is the grid
  kernel's MXU form, the port's "grid_mxu", on a mesh-scale one; pine_tpu's
  mesh default "mxu", where no setting reaches the group, is the port's
  default "grid"; "bvh" on a dense-kind group, which has no node arrays,
  raises.
- "mxu" and "mxup" resolve so on a soup too, a type with no table (AABB)
  takes the size default, and an unknown value is refused.
- A refused setting changes no route; ``compile()`` builds the tables of
  the routes taken and no others.
- Two renders of one scene compile it once; an ``add`` between them makes
  the next render compile it again; a compiled scene re-routed through a
  setter is not handed out for its old settings.
- Reduced renders through each forced kernel on the CPU (the reduced box
  with "scdense"; the reduced terrain with ``mesh_kernel`` "sctree" and
  "bvh", GRID_MAX_PRIMS cut so that its 3,042 triangles are mesh-scale)
  against the port's default render of the same scene, by the render
  criteria of tests/test_torch_render.py (97 % of pixels, means to 1 %,
  traced rays to 0.5 %); tests/test_torch_render.py holds the forced BVH
  walk's terrain against pine_tpu's render.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_render import REDUCED, assert_renders_agree
from test_torch_scdense import both, cone_field, port_soup

from pine_tpu_torch import scenes
from pine_tpu_torch.accel import dense_traverse as DT
from pine_tpu_torch.convert import GROUP_KEYS, scene_arrays

torch.set_num_threads(2)


def host_routes(scene, **kernels):
    """The routes of a scene's prim groups, from its host arrays."""
    a = scene_arrays(scene)
    groups = [{k: a[f"group.{i}.{k}"] for k in GROUP_KEYS} for i in range(int(a["n_groups"]))]
    return [DT.group_variant(g, **kernels) for g in groups]


def test_default_routes_unchanged():
    assert host_routes(scenes.cbox()) == ["dense", "dense", "dense"]
    assert host_routes(scenes.terrain()) == ["dense", "grid"]
    assert host_routes(scenes.instanced()) == ["dense", "dense"]
    assert host_routes(scenes.prl_scene(scenes.CONE_FOREST_PRL)) == ["dense", "dense", "lattice"]
    cs = scenes.cbox((32, 32), *REDUCED).compile("cpu")
    assert (cs.small_kernel, cs.mesh_kernel) == (None, None)
    assert [g["variant"] for g in cs.unified["groups"]] == ["dense", "dense", "dense"]


def route_table():
    """[(name, pine_tpu group, port group, limits to cut in both packages)]."""
    def soup(n, seed):
        jacc, pacc = both(n, seed)
        return jacc["groups"][0], pacc["groups"][0]

    jacc, pacc = cone_field()
    table = [("small", *soup(10, 1), {}),
             ("lattice 12x12", jacc["groups"][0], pacc["groups"][0], {}),
             ("mid-size", *soup(700, 2), {}),
             ("over GRID_MAX_PRIMS", *soup(3000, 3), {"GRID_MAX_PRIMS": 2048}),
             ("over GRID_MAX_PRIMS_HBM", *soup(3000, 4), {"GRID_MAX_PRIMS_HBM": 2500})]
    assert [pg["kind"] for _, _, pg, _ in table] == ["dense", "bvh", "bvh", "bvh", "bvh"]
    assert table[1][2]["lattice"] and table[1][2]["rows"].shape[0] == 148
    return table


def test_forced_routes_match_pine_tpu(monkeypatch):
    from pine_tpu.accel import pallas_traverse as PT

    table = route_table()
    seen = set()
    for setting, env in (("small_kernel", "PINE_SMALL_KERNEL"), ("mesh_kernel", "PINE_MESH_KERNEL")):
        for value in DT.VARIANTS:
            for name, jg, pg, cut in table:
                with monkeypatch.context() as m:
                    for k, v in cut.items():
                        m.setattr(PT, k, v)
                        m.setattr(DT, k, v)
                    m.setenv(env, value)
                    want = pine_route(PT, jg, pg, reaches(pg, setting))
                    if value == "bvh" and want == "bvh" and pg["kind"] != "bvh":
                        with pytest.raises(ValueError, match="node arrays"):
                            DT.group_variant(pg, **{setting: value})
                        seen.add((name, "raises"))
                        continue
                    got = DT.group_variant(pg, **{setting: value})
                    assert got == want, (setting, value, name, got, want)
                    seen.add((name, got))
    # every group took a forced route, and the large ones their defaults too
    assert {("small", "raises"), ("lattice 12x12", "lattice"), ("mid-size", "sctree"),
            ("over GRID_MAX_PRIMS", "scdense"), ("over GRID_MAX_PRIMS", "grid"),
            ("over GRID_MAX_PRIMS_HBM", "bvh"), ("small", "mxup"), ("lattice 12x12", "mxu"),
            ("mid-size", "mxup"), ("over GRID_MAX_PRIMS", "grid_mxu")} <= seen
    assert {got for name, got in seen if name == "over GRID_MAX_PRIMS_HBM"} == {"bvh"}


def reaches(pg, setting):
    """Whether ``setting`` reaches the group (the module docstring of
    accel/dense_traverse.py), as the matching variable reaches pine_tpu's."""
    n = len(pg["prim_aabbs"])
    eligible = n <= DT.GRID_MAX_PRIMS_HBM
    if eligible and n > DT.GRID_MAX_PRIMS:
        return setting == "mesh_kernel"
    return setting == "small_kernel" and (eligible or bool(pg["lattice"]))


def pine_route(PT, jg, pg, forced):
    """pine_tpu's route of a group under the environment: ``_group_variant``,
    then ``pallas_group_query``'s rewrites (pallas_traverse.py:1756-1777)
    in the port's names; its mesh default "mxu" (no variable ``forced`` on
    the group) is the port's "grid"."""
    from pine_tpu.accel import mxu_sweep as JM

    want = PT._group_variant(jg)
    size_default = "dense" if pg["rows"].shape[0] <= DT.DENSE_DEFAULT_MAX else "grid"
    if want in ("mxu", "mxup"):
        if not forced:
            return "grid"
        if JM.supports(jg["tid"]) and not PT._grid_hbm(jg):
            return want
        if JM.supports(jg["tid"]) and PT._grid_eligible(jg):
            return "grid_mxu"
        return size_default
    if want == "lattice" and not pg["lattice"]:
        return size_default
    return want


def test_mxu_routes_and_unknown_values_are_refused(monkeypatch):
    """"mxu" and "mxup" resolve as pine_tpu's pallas_group_query rewrites
    them; an unknown value is refused."""
    from pine_tpu_torch.accel import packet as PPK
    from pine_tpu_torch.convert import upload_group
    from pine_tpu_torch.scene import shapes as PS

    g = port_soup(700, 5)["groups"][0]
    assert DT.group_variant(g) == "grid"
    for value in ("mxu", "mxup"):
        assert DT.group_variant(g, small_kernel=value) == value
        assert DT.group_variant(g, mesh_kernel=value) == "grid"  # mesh_kernel: not mesh-scale
    with monkeypatch.context() as m:
        m.setattr(DT, "GRID_MAX_PRIMS", 512)  # the soup is mesh-scale now
        for value in ("mxu", "mxup"):
            assert DT.group_variant(g, mesh_kernel=value) == "grid_mxu"
            assert DT.group_variant(g, small_kernel=value) == "grid"
        m.setattr(DT, "GRID_MAX_PRIMS_HBM", 600)  # above it: the default, whatever is set
        assert DT.group_variant(g, small_kernel="mxu", mesh_kernel="mxup") == "bvh"
    # a type with no coefficient table: the size default
    for n, want in ((30, "dense"), (600, "grid")):
        rng = np.random.default_rng(n)
        prims = []
        for i in range(n):
            lo = rng.uniform(-2, 2, 3)
            box = PS.BoxAABB(lo, lo + rng.uniform(0.05, 0.3, 3))
            prims.append((box.type_id, box.params(), i, box.get_aabb()))
        (ga,) = PPK.build_packet_accel(prims)["groups"]
        ga = upload_group(ga, "cpu")
        for value in ("mxu", "mxup"):
            assert DT.group_variant(ga, small_kernel=value) == want
    with pytest.raises(ValueError, match="unknown"):
        DT.group_variant(g, small_kernel="octree")


def test_render_compiles_once_and_add_recompiles(monkeypatch):
    from pine_tpu_torch import convert
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.scene import lights as PL
    from pine_tpu_torch.scene import materials as PM
    from pine_tpu_torch.scene import shapes as PS

    builds = []
    real = convert.compiled_scene_from_arrays

    def counted(*a, **k):
        builds.append(a[1:])
        return real(*a, **k)

    monkeypatch.setattr(convert, "compiled_scene_from_arrays", counted)
    scene = scenes.cbox((8, 8), *REDUCED)
    integrator = PathIntegrator(BlueSampler(1), 2)
    for _ in range(2):
        integrator.render(scene, device="cpu")
    assert len(builds) == 1
    scene.add(PS.Sphere([0.0, 0.5, 1.0], 0.1), PM.Diffuse([0.5, 0.5, 0.5]))
    for _ in range(2):
        integrator.render(scene, device="cpu")
    assert len(builds) == 2
    for change in (lambda: scene.add("grey", PM.Diffuse([0.3, 0.3, 0.3])),
                   lambda: scene.add(PL.PointLight([0.0, 1.5, 0.5], [1.0, 1.0, 1.0]))):
        change()
        integrator.render(scene, device="cpu")
    assert len(builds) == 4
    cs = scene.compile("cpu")
    assert len(builds) == 4 and scene.compile("cpu", small_kernel="scdense") is not cs
    assert len(builds) == 5 and scene.compile("cpu") is cs
    cs.small_kernel = "dense"  # re-routed: no longer the scene of the default settings
    fresh = scene.compile("cpu")
    assert fresh is not cs and len(builds) == 6 and fresh.small_kernel is None
    assert {g["variant"] for g in fresh.unified["groups"]} == {"dense"}


def test_refused_setting_changes_nothing():
    cs = scenes.cbox((32, 32), *REDUCED).compile("cpu", small_kernel="scdense")
    assert [g["variant"] for g in cs.unified["groups"]] == ["scdense"] * 3
    with pytest.raises(ValueError, match="node arrays"):
        cs.small_kernel = "bvh"  # the rect group has 6 prims: no SAH tree
    assert cs.small_kernel == "scdense"
    assert [g["variant"] for g in cs.unified["groups"]] == ["scdense"] * 3
    cs.small_kernel = None
    assert [g["variant"] for g in cs.unified["groups"]] == ["dense"] * 3


def test_compile_builds_only_the_route_tables(monkeypatch):
    def tables(cs):
        return [sorted(k for k in ("grid", "scd", "sctree", "bvh") if k in g)
                for g in cs.unified["groups"]]

    scene = scenes.terrain((16, 16), 40)
    assert tables(scene.compile("cpu")) == [[], ["grid"]]
    monkeypatch.setattr(DT, "GRID_MAX_PRIMS", 1024)
    assert tables(scene.compile("cpu", mesh_kernel="sctree")) == [[], ["sctree"]]
    monkeypatch.setattr(DT, "GRID_MAX_PRIMS_HBM", 2000)
    # a new scene: compile() caches per settings, and the limits are no setting
    cs = scenes.terrain((16, 16), 40).compile("cpu")
    assert [g["variant"] for g in cs.unified["groups"]] == ["dense", "bvh"]
    assert tables(cs) == [[], ["bvh"]]


def render(scene, **kernels):
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    cs = scene.compile("cpu", **kernels)
    img, stats = render_wavefront(cs, scene.camera, 32, 32, BlueSampler(4), 4, 4,
                                  return_stats=True)
    return img.numpy(), stats["traced_rays"], [g["variant"] for g in cs.unified["groups"]]


@pytest.mark.parametrize("case", ["box scdense", "terrain sctree", "terrain bvh"])
def test_forced_render_matches_default(case, monkeypatch):
    what, kernel = case.split()
    if what == "box":
        scene, kernels = scenes.cbox((32, 32), *REDUCED), dict(small_kernel=kernel)
    else:
        monkeypatch.setattr(DT, "GRID_MAX_PRIMS", 1024)
        scene, kernels = scenes.terrain((32, 32), 40), dict(mesh_kernel=kernel)
    want, rays_want, routes = render(scene)
    got, rays_got, forced = render(scene, **kernels)
    assert routes == (["dense"] * 3 if what == "box" else ["dense", "grid"])
    assert forced == ([kernel] * 3 if what == "box" else ["dense", kernel])
    assert_renders_agree(got, want, rays_got, rays_want)
