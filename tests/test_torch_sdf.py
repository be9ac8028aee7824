"""Signed-distance shapes against pine_tpu: the march, its normals, a render.

1. ``_sdf_march`` and ``_sdf_normal`` of pine_tpu_torch/scene/scene.py
   against pine_tpu's (``jax.numpy``, op by op), on ``scenes.torus_sdf`` and
   a jnp function written the same way, 4,096 rays aimed at the torus's box
   (some grazing, some starting inside the box, some with a short tmax).
   Held to: hit masks equal on 99.9 % of the lanes, t to rtol 1e-4 (atol
   1e-6, for the lanes that start a hair from the surface) where both hit;
   normals to 1e-3 (their central difference at 1e-4 of two distances of
   magnitude ~1: about float32's floor for that formula, as in
   tests/test_torch_csg.py).  Measured: every hit mask equal, t within
   1.0e-5 (rtol 3e-4 at t = 1e-4, 1e-4 elsewhere), normals within 1.5e-4,
   99.4 % of them within 1e-4.
2. The march's compaction to the marching lanes and its early end
   (scene.EXIT_CHECK) are exact: with them and without them (every lane
   through every one of SDF_STEPS steps) the port returns the same t, bit
   for bit.
3. The CSG fog box with the torus added through the Python API
   (``scenes.csg_fog_sdf`` at 16x16, BlueSampler(2), depth 3): pine_tpu's
   compiled scene (its torus an SDFShape of the jnp function) carried
   across by convert, the port's torus the torch function; held to
   test_torch_render's rule.  Measured: 99.2 % of pixels.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_csg import carried_arrays
from test_torch_render import assert_renders_agree

torch.set_num_threads(2)

N = 4096
SIZE, SPP, DEPTH = 16, 2, 3


def jax_torus(p):
    """scenes.torus_sdf in jax.numpy, written the same way."""
    from pine_tpu_torch.scenes import TORUS

    c, R, r = TORUS["center"], TORUS["major"], TORUS["minor"]
    x, y, z = p[:, 0] - c[0], p[:, 1] - c[1], p[:, 2] - c[2]
    q = jnp.sqrt(x * x + z * z) - R
    return jnp.sqrt(q * q + y * y) - r


def shapes():
    from pine_tpu.scene import shapes as JS

    from pine_tpu_torch import scenes

    p = scenes.torus_shape()
    return JS.SDFShape(p.center, p.half, jax_torus), p


def torus_rays(seed=0):
    from pine_tpu_torch.scenes import TORUS

    rng = np.random.default_rng(seed)
    c = np.float32(TORUS["center"])
    ro = (c + rng.normal(size=(N, 3)) * 1.2).astype(np.float32)
    ro[: N // 8] = c + rng.uniform(-0.25, 0.25, (N // 8, 3))  # inside the box
    aim = c + rng.uniform(-0.3, 0.3, (N, 3)) * np.float32([1, 0.3, 1])
    rd = (aim - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.zeros(N, np.float32)
    tmax = np.where(np.arange(N) % 7 == 0, 0.8, np.finfo(np.float32).max).astype(np.float32)
    return ro, rd.astype(np.float32), tmin, tmax


def test_march_and_normals_match_pine_tpu():
    from pine_tpu.scene import scene as JSc

    from pine_tpu_torch.scene import scene as PSc

    js, ps = shapes()
    ro, rd, tmin, tmax = torus_rays()
    t_j = np.asarray(JSc._sdf_march(js, *map(jnp.asarray, (ro, rd, tmin, tmax))))
    t_p = PSc._sdf_march(ps, *map(torch.from_numpy, (ro, rd, tmin, tmax))).numpy()
    hit_j, hit_p = t_j < 1e30, t_p < 1e30
    assert 0.2 < hit_j.mean() < 0.9
    assert (hit_j == hit_p).mean() >= 0.999, (hit_j != hit_p).sum()
    both = hit_j & hit_p
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-4, atol=1e-6)
    p = (ro + np.where(both, t_j, 1.0)[:, None] * rd).astype(np.float32)
    n_j = np.asarray(JSc._sdf_normal(js, jnp.asarray(p)))[both]
    n_p = PSc._sdf_normal(ps, torch.from_numpy(p)).numpy()[both]
    np.testing.assert_allclose(n_p, n_j, atol=1e-3)


def test_early_end_of_the_march_is_exact(monkeypatch):
    from pine_tpu_torch.scene import scene as PSc

    _, ps = shapes()
    args = tuple(map(torch.from_numpy, torus_rays(1)))
    early = PSc._sdf_march(ps, *args)
    monkeypatch.setattr(PSc, "EXIT_CHECK", PSc.SDF_STEPS + 1)  # never ends early
    full = PSc._sdf_march(ps, *args)
    assert torch.equal(early, full) and (early < 1e30).any()


def test_sdf_shape_compiles_into_its_list():
    from pine_tpu_torch import scenes
    from pine_tpu_torch.scene import shapes as S

    scene = scenes.csg_fog_sdf(8)
    cs = scene.compile("cpu")
    (sdf, g), = cs.sdf_shapes
    assert isinstance(sdf, S.SDFShape) and int(cs.g_type[g]) == S.SDF_TYPE
    # the scene's box takes the torus's
    np.testing.assert_array_less(scene.get_aabb()[0], sdf.get_aabb()[0] + 1e-6)


@pytest.fixture(scope="module")
def fog_sdf():
    from pine_tpu.prl.interp import Interpreter as JInterp
    from pine_tpu.scene import materials as JM

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import compiled_scene_from_arrays

    itp = JInterp()
    itp.run(scenes.csg_fog_prl(SIZE, integrator=None, save=None), "<csg fog>")
    scene = itp.get_var("scene")
    scene.add(shapes()[0], JM.Diffuse([0.85, 0.55, 0.2]))
    jcs = scene.compile()
    a = carried_arrays(jcs, scene.camera)
    a["sdf.0"].fn = scenes.torus_sdf  # the port's distance function
    return scene, jcs, compiled_scene_from_arrays(a, "cpu")


def test_fog_box_with_torus_matches_pine_tpu(fog_sdf):
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene, jcs, pcs = fog_sdf
    assert len(pcs.sdf_shapes) == 1 and len(pcs.csg_shapes) == 4
    want, jst = jax_render(jcs, scene.camera, SIZE, SIZE, JBlue(SPP), SPP, DEPTH,
                           return_stats=True)
    got, pst = render_wavefront(pcs, None, SIZE, SIZE, BlueSampler(SPP), SPP, DEPTH,
                                return_stats=True)
    assert_renders_agree(got.numpy(), np.asarray(want), pst["traced_rays"],
                         float(jst["traced_rays"]))
