"""CSG shapes against pine_tpu: the interval walk, and the fog box's renders.

1. ``intervals_of``, ``csg_intersect`` and ``csg_normal`` of
   pine_tpu_torch/scene/csg_intersect.py against pine_tpu's (evaluated op by
   op) for union, intersection and difference over each pair of the five
   child types (sphere, AABB, OBB, cone, cylinder), nested trees of three
   levels, and rays that start inside the shapes: 4,096 rays a tree, the
   port's shapes built by its own constructors from the same arguments.
   Held to: t to rtol 1e-5 / atol 1e-6 (intervals: every slot; hits: where
   both hit), hit masks equal; normals to 2e-3 (NORMAL_ATOL: a central
   difference at eps 1e-4 of distances whose last bits differ, since XLA
   fuses and associates the sums of squares of ``jnp.linalg.norm``
   otherwise than the port's written-out sums; within 1e-4 on 53-100 % of
   the lanes of a tree, at most 1.18e-3 apart).  Measured: intervals and
   hits within 1e-5 of each other.
2. The port's PRL interpreter composes shapes with + * - as pine_tpu's does
   (the same tree of the same leaves), and ``convert.carry`` carries
   pine_tpu's trees, leaf attributes bit for bit.
3. The CSG fog box (``scenes.CSG_FOG_PRL`` at 16x16: the box's walls and
   light, four CSG shapes, a homogeneous fog over a box minus a sphere),
   BlueSampler(2), by the path integrator (depth 3) and the cached one
   (depth 2, grid 16): pine_tpu's compiled scene carried across by convert
   and rendered by the port on the CPU, against pine_tpu's jitted render.
   Held to test_torch_render's rule: 97 % of pixels to 1e-3 relative or
   1e-4 absolute, means to 1 % (and traced rays to 0.5 %, path).
   Measured: 99.2 % of pixels, both.
"""
from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import assert_renders_agree, jax_scene_arrays

torch.set_num_threads(2)

N = 4096
TYPES = ("sphere", "aabb", "obb", "cone", "cylinder")
OPS = ("union", "intersection", "difference")
SIZE, SPP, DEPTH = 16, 2, 3
CACHED_DEPTH = 2  # pine_tpu's jitted cached render compiles for about a minute at depth 3
# the normals' central differences at eps 1e-4 divide a few ulps of two
# distances of magnitude ~1 by their difference of ~2e-4: ~1e-3 is float32's
# floor for that formula (measured: up to 1.18e-3 between the packages)
NORMAL_ATOL = 2e-3


def leaf(S, kind, rng):
    """A random leaf of ``kind`` near the origin, from the shapes module ``S``
    (pine_tpu's or the port's); the same draws give the same shape."""
    c = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    if kind == "sphere":
        return S.Sphere(c, float(rng.uniform(0.4, 0.9)))
    if kind == "aabb":
        h = rng.uniform(0.3, 0.8, 3).astype(np.float32)
        return S.BoxAABB(c - h, c + h)
    if kind == "obb":
        a = float(rng.uniform(0, np.pi))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = (np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                     * rng.uniform(0.6, 1.4, 3)).astype(np.float32)
        m[:3, 3] = c
        return S.BoxOBB(S.BoxAABB([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]), m)
    n = rng.normal(size=3)
    if kind == "cone":
        return S.Cone(c - 0.4 * n / np.linalg.norm(n), n, float(rng.uniform(0.3, 0.7)),
                      float(rng.uniform(0.5, 1.0)))
    return S.Cylinder(c - 0.5 * n / np.linalg.norm(n), c + 0.5 * n / np.linalg.norm(n),
                      float(rng.uniform(0.2, 0.5)))


def combine(S, op, a, b):
    return {"union": a + b, "intersection": a * b, "difference": a - b}[op]


def tree_pair(spec, seed):
    """(pine_tpu's tree, the port's) of ``spec``: a leaf kind, or (op, spec, spec)."""
    from pine_tpu.scene import shapes as JS

    from pine_tpu_torch.scene import shapes as PS

    out = []
    for S in (JS, PS):
        rng = np.random.default_rng(seed)

        def build(sp):
            if isinstance(sp, str):
                return leaf(S, sp, rng)
            return combine(S, sp[0], build(sp[1]), build(sp[2]))

        out.append(build(spec))
    return out


def rays(seed, inside_share=0.3):
    """Rays aimed through the shapes' region; a share start at its centre."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    k = int(N * inside_share)
    ro[:k] = rng.uniform(-0.3, 0.3, (k, 3))
    rd = (rng.uniform(-0.6, 0.6, (N, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd.astype(np.float32)


SPECS = ([(op, a, b) for op in OPS for a in TYPES for b in TYPES if a <= b]
         + [("difference", ("union", "sphere", "cone"), ("intersection", "aabb", "cylinder")),
            ("intersection", ("difference", "obb", "sphere"), ("union", "cylinder", "aabb")),
            ("union", ("difference", ("union", "sphere", "obb"), "cone"), "cylinder")])


def spec_id(sp):
    return sp if isinstance(sp, str) else f"{sp[0]}({spec_id(sp[1])},{spec_id(sp[2])})"


@pytest.mark.parametrize("spec", SPECS, ids=[spec_id(s) for s in SPECS])
def test_interval_walk_matches(spec):
    from pine_tpu.scene import csg_intersect as JC

    from pine_tpu_torch.scene import csg_intersect as PC

    seed = zlib.crc32(spec_id(spec).encode()) % 1000
    ro, rd = rays(seed)
    jro, jrd = jnp.asarray(ro), jnp.asarray(rd)
    pro, prd = torch.from_numpy(ro), torch.from_numpy(rd)
    jt, pt = tree_pair(spec, seed)
    while not np.asarray(JC.csg_intersect(jt, jro, jrd, jnp.zeros(N), jnp.full(N, 1e30))[1]).any():
        seed += 1000  # a draw whose tree is empty (b swallows a): the next one
        jt, pt = tree_pair(spec, seed)
    for got, want in zip(PC.intervals_of(pt, pro, prd), JC.intervals_of(jt, jro, jrd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    tmin = np.where(np.arange(N) % 3 == 0, 0.5, 0.0).astype(np.float32)
    tmax = np.where(np.arange(N) % 5 == 0, 2.0, 1e30).astype(np.float32)
    t_p, hit_p = PC.csg_intersect(pt, pro, prd, torch.from_numpy(tmin), torch.from_numpy(tmax))
    t_j, hit_j = JC.csg_intersect(jt, jro, jrd, jnp.asarray(tmin), jnp.asarray(tmax))
    hit_j = np.asarray(hit_j)
    assert hit_j.any() and (~hit_j).any()
    np.testing.assert_array_equal(hit_p.numpy(), hit_j)
    np.testing.assert_allclose(t_p.numpy()[hit_j], np.asarray(t_j)[hit_j], rtol=1e-5, atol=1e-6)
    # normals at the hit points: the central differences at eps 1e-4 turn the
    # distances' last bits (XLA associates and fuses the sums of squares of
    # jnp.linalg.norm otherwise than the port's written-out sums) into up to
    # 5e-4 of a normal
    p = (ro + np.where(hit_j, np.asarray(t_j), 1.0)[:, None] * rd).astype(np.float32)
    n_j = np.asarray(JC.csg_normal(jt, jnp.asarray(p)))[hit_j]
    n_p = PC.csg_normal(pt, torch.from_numpy(p)).numpy()[hit_j]
    np.testing.assert_allclose(n_p, n_j, atol=NORMAL_ATOL)


def test_prl_operators_compose_the_same_tree():
    from pine_tpu.prl.interp import Interpreter as JInterp

    from pine_tpu_torch.convert import carry
    from pine_tpu_torch.prl.interp import Interpreter
    from pine_tpu_torch.scene import csg as PCSG

    src = ("s := (Sphere([0, 0, 0], 1.0) * Sphere([0, 0, 0.5], 1.0)) - AABB([0, 0, 0], [1, 1, 1])"
           " + Cone([0, 0, 0], Y, 0.5, 1.0) + Box(AABB([0, 0, 0], [1, 1, 1]), rotate_y(0.3))"
           " - Cylinder([0, 0, 0], [0, 1, 0], 0.2);")
    ji, pi = JInterp(), Interpreter(device="cpu")
    ji.run(src)
    pi.run(src)

    def same(p, j, c):
        assert type(p).__name__ == type(j).__name__ == type(c).__name__
        if isinstance(p, PCSG.CSGShape):
            for k in ("a", "b"):
                same(getattr(p, k), getattr(j, k), getattr(c, k))
            return
        for k, v in vars(j).items():
            if k == "base":
                same(p.base, v, c.base)
            else:
                np.testing.assert_array_equal(np.asarray(getattr(p, k)), np.asarray(v), err_msg=k)
                np.testing.assert_array_equal(np.asarray(getattr(c, k)), np.asarray(v), err_msg=k)

    j = ji.get_var("s")
    same(pi.get_var("s"), j, carry(j))
    assert np.allclose(pi.get_var("s").get_aabb(), j.get_aabb())


def carried_arrays(jcs, cam):
    """jax_scene_arrays plus the SDFs (their ``fn`` kept), CSG trees and
    media, carried by convert.carry."""
    from pine_tpu_torch.convert import carry

    a = jax_scene_arrays(jcs, cam)
    for name, listed in (("csg", jcs.csg_shapes), ("sdf", jcs.sdf_shapes)):
        a[f"n_{name}"] = np.asarray(len(listed))
        for i, (shape, g) in enumerate(listed):
            a[f"{name}.{i}"], a[f"{name}.{i}.gidx"] = carry(shape), np.asarray(g)
    media = list(jcs.media) + list(jcs.grid_media)
    a["n_media"] = np.asarray(len(media))
    for i, m in enumerate(media):
        a[f"medium.{i}"] = carry(m)
    return a


@pytest.fixture(scope="module")
def fog():
    from pine_tpu.prl.interp import Interpreter as JInterp

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import compiled_scene_from_arrays

    itp = JInterp()
    itp.run(scenes.csg_fog_prl(SIZE, integrator=None, save=None), "<csg fog>")
    scene = itp.get_var("scene")
    jcs = scene.compile()
    assert jcs.unified is None and len(jcs.csg_shapes) == 4 and len(jcs.media) == 1
    pcs = compiled_scene_from_arrays(carried_arrays(jcs, scene.camera), "cpu")
    assert [g["variant"] for g in pcs.type_groups] == ["dense"] and len(pcs.csg_shapes) == 4
    return scene, jcs, pcs


def test_fog_box_path_render_matches_pine_tpu(fog):
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene, jcs, pcs = fog
    want, jst = jax_render(jcs, scene.camera, SIZE, SIZE, JBlue(SPP), SPP, DEPTH,
                           return_stats=True)
    got, pst = render_wavefront(pcs, None, SIZE, SIZE, BlueSampler(SPP), SPP, DEPTH,
                                return_stats=True)
    assert_renders_agree(got.numpy(), np.asarray(want), pst["traced_rays"],
                         float(jst["traced_rays"]))


def test_fog_box_cached_render_matches_pine_tpu(fog):
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.cachedpath import render_cached as jax_cached

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.cachedpath import render_cached

    scene, jcs, pcs = fog
    want = np.asarray(jax_cached(jcs, scene.camera, SIZE, SIZE, JBlue(SPP), SPP, CACHED_DEPTH,
                                 16))
    got = render_cached(pcs, None, SIZE, SIZE, BlueSampler(SPP), SPP, CACHED_DEPTH,
                        scene.get_aabb(), 16).numpy()
    assert_renders_agree(got, want)
