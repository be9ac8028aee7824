"""Forced traversal kernels: ``CompiledScene.small_kernel`` and ``mesh_kernel``
(pine_tpu_torch/accel/dense_traverse.group_variant and route), the port's
counterparts of pine_tpu's ``PINE_SMALL_KERNEL`` and ``PINE_MESH_KERNEL``.

- With both settings None every group of the bench box, the terrain, the
  rock field and the cone forest takes the kernel it took before the
  settings existed.
- For each value ("dense", "scdense", "lattice", "grid", "sctree", "bvh")
  and each setting, the route of a table of groups (a small dense-kind
  group, a lattice over 512 rows, a mid-size group, a group over
  GRID_MAX_PRIMS and one over GRID_MAX_PRIMS_HBM, the limits cut in both
  packages) equals pine_tpu's ``_group_variant`` under the matching
  environment variable, with pine_tpu's own fallback of a forced "lattice"
  on a group that is no lattice, and its mesh default "mxu" read as the
  port's "grid" (the MXU form is not ported); "bvh" on a dense-kind group,
  which has no node arrays, raises; the MXU routes raise.
- A refused setting changes no route; ``compile()`` builds the tables of
  the routes taken and no others.
- Reduced renders through each forced kernel on the CPU (the reduced box
  with "scdense"; the reduced terrain with ``mesh_kernel`` "sctree" and
  "bvh", GRID_MAX_PRIMS cut so that its 3,042 triangles are mesh-scale)
  against the port's default render of the same scene, by the render
  criteria of tests/test_torch_render.py (97 % of pixels, means to 1 %,
  traced rays to 0.5 %); tests/test_torch_render.py holds the forced BVH
  walk's terrain against pine_tpu's render.
"""
from __future__ import annotations

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
                    want = PT._group_variant(jg)
                    lattice = bool(pg["lattice"])
                    if want == "lattice" and not lattice:  # pallas_group_query's fallback
                        want = "dense" if pg["rows"].shape[0] <= DT.DENSE_DEFAULT_MAX else "grid"
                    want = "grid" if want == "mxu" else want
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
            ("over GRID_MAX_PRIMS_HBM", "bvh")} <= seen
    assert {got for name, got in seen if name == "over GRID_MAX_PRIMS_HBM"} == {"bvh"}


def test_mxu_routes_and_unknown_values_are_refused():
    pacc = port_soup(700, 5)
    g = pacc["groups"][0]
    for value in ("mxu", "mxup"):
        with pytest.raises(NotImplementedError, match="kernel 7"):
            DT.group_variant(g, small_kernel=value)
    with pytest.raises(ValueError, match="unknown"):
        DT.group_variant(g, small_kernel="octree")


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
    cs = scene.compile("cpu")
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
