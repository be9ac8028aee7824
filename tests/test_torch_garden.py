"""The garden slice as a whole, and its subsurface walk, against pine_tpu.

1. ``bssrdf_walk`` against pine_tpu's on a seeded state: 4,096 lanes on a
   Subsurface sphere standing on a ground rect beside a fence of lines (a
   scene of 24 prims: no accel in either package, pine_tpu's brute force
   and the port's per-type groups), most
   lanes on the BSSRDF lobe, sigma_s from 4 to 60, SobolSampler dims of
   depth 1 of a depth-5 path.  The walk's exit decision, ``t_surf <
   t_med``, may flip on a lane whose t differs in the last ulp between XLA
   (which fuses multiply-adds) and the port; every other lane holds its
   exit point, normal, direction and channel weight to rtol 1e-4 / atol
   1e-5, and flips are at most 0.5 % of the lanes.
2. The reduced garden (``scenes.garden_prl`` at 32x32, SobolSampler(4)):
   pine_tpu's compiled scene, carried across by pine_tpu_torch.convert (the
   Atmosphere's map, the SpotLight, the line group, the Subsurface material
   and the node trees), rendered by both path integrators (the cached
   integrators in test_torch_garden_cached.py, the other skies in
   test_torch_garden_skies.py).  Held to test_torch_render's rule: 97 % of pixels to
   1e-3 relative or 1e-4 absolute, means to 1 %, traced rays to 0.5 %.
   Depth 2, not the slice's reduced depth 3: XLA compiles pine_tpu's jitted
   render of this scene for about a minute at depth 2 and nearly three at
   depth 3 on the CPU (its subsurface walk is eight more scene intersects
   per depth), and at depth 3 its fused multiply-adds flip 3.7 % of the
   pixels' paths (1.6 % on the cone floor's grazing rays, whose float32
   discriminant sits near zero, ROADMAP.md §3), where evaluated op by op
   (``jax.disable_jit``) it agrees with the port on all but 1 of 4,096
   lane-samples.  The port's own reduced renders run at depth 3 in
   chip_smoke.py's phase 3 (card against CPU).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import assert_renders_agree, jax_scene_arrays

torch.set_num_threads(2)

SIZE, SPP, DEPTH = 32, 4, 2


@pytest.fixture(scope="module")
def walk_scenes():
    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene import shapes as JS
    from pine_tpu.scene.scene import Scene as JScene

    from pine_tpu_torch.convert import compiled_scene_from_arrays

    js = JScene()
    skin = JM.Subsurface([0.9, 0.6, 0.5], 0.0, 40.0)
    js.add(JS.Sphere([0.0, 0.35, 0.0], 0.35), skin)
    js.add(JS.Rect([0, 0, 0], [4, 0, 0], [0, 0, 4]), JM.Diffuse([0.5, 0.5, 0.5]))
    wood = JM.Diffuse([0.45, 0.3, 0.18])
    for i in range(22):
        x = -1.1 + 0.1 * i
        js.add(JS.Line([x, 0, 0.5], [x, 0.8, 0.5], 0.02), wood)
    cam = ThinLenCamera(Film((8, 8)), [0, 1, -2], [0, 0.3, 0], 0.4)
    jcs = js.compile()
    assert jcs.has_subsurface and jcs.unified is None  # no accel in either
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, cam), "cpu")
    assert pcs.has_subsurface and pcs.unified is None
    return jcs, pcs


def walk_state(n, seed):
    """Seeded lanes on the sphere: p, n, wi_world, and a BXDF state."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm[:, 1] = np.abs(nrm[:, 1]) + 0.2  # the upper part, off the ground
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    p = (np.float32([0.0, 0.35, 0.0]) + 0.35 * nrm).astype(np.float32)
    wi = nrm + rng.normal(size=(n, 3)) * 0.6
    wi = np.where((wi * nrm).sum(-1, keepdims=True) > 0.05, wi, nrm)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    tag = np.where(rng.random(n) < 0.9, 5, 0).astype(np.int32)  # BX_BSSRDF, else diffuse
    sigma = rng.uniform(4.0, 60.0, (n, 3)).astype(np.float32)
    state = dict(tag=tag, albedo=np.full((n, 3), 0.7, np.float32),
                 roughness=np.zeros(n, np.float32), ior=np.full(n, 1.4, np.float32),
                 sigma_s=sigma)
    return p, nrm, wi, state


def test_bssrdf_walk_matches(walk_scenes):
    from pine_tpu.core.samplers import SobolSampler as JSobol
    from pine_tpu.integrators.path import bssrdf_walk as jwalk

    from pine_tpu_torch.core.samplers import SobolSampler
    from pine_tpu_torch.integrators.path import bssrdf_walk

    jcs, pcs = walk_scenes
    n = 4096
    p, nrm, wi, state = walk_state(n, 12)
    rng = np.random.default_rng(1)
    xs, ys = (rng.integers(0, 640, n).astype(np.int32) for _ in range(2))
    dim = 4 + 5 * 16 + 1 * 32
    want = [np.asarray(x) for x in jwalk(
        jcs, {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(p), jnp.asarray(nrm),
        jnp.asarray(wi), jnp.asarray(xs), jnp.asarray(ys), JSobol(4), 1, dim)]
    got = [x.numpy() for x in bssrdf_walk(
        pcs, {k: torch.as_tensor(v) for k, v in state.items()}, torch.as_tensor(p),
        torch.as_tensor(nrm), torch.as_tensor(wi), torch.as_tensor(xs), torch.as_tensor(ys),
        SobolSampler(4), 1, dim)]
    moved_j, moved_p = (want[3] != 1.0).any(-1), (got[3] != 1.0).any(-1)
    assert moved_j.mean() > 0.5 and (~moved_j).any()  # walks that leave and walks that stay
    agree = np.ones(n, bool)
    for g, w in zip(got, want):
        agree &= np.isclose(g, w, rtol=1e-4, atol=1e-5).all(-1)
    assert (~agree).mean() <= 0.005, (~agree).sum()
    assert (moved_j != moved_p).mean() <= 0.005
    np.testing.assert_array_equal(got[3][agree], want[3][agree])


def garden_pair(sky, sampler):
    """pine_tpu's reduced garden under ``sky`` (its own interpreter and
    compile) and the port's CompiledScene of its arrays."""
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import compiled_scene_from_arrays

    itp = Interpreter()
    itp.run(scenes.garden_prl(sky, sampler, size=SIZE, integrator=None, save=None), "<garden>")
    jscene = itp.get_var("scene")
    jcs = jscene.compile()
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, jscene.camera), "cpu")
    return jscene, jcs, pcs


def render_pair(sky, sampler):
    """(pine_tpu's render, its traced rays, the port's render, its traced
    rays) of the reduced garden under ``sky`` with ``sampler``."""
    from pine_tpu.core import samplers as JS
    from pine_tpu.integrators.path import render_wavefront as jax_render

    from pine_tpu_torch.core import samplers as PS
    from pine_tpu_torch.integrators.path import render_wavefront

    jscene, jcs, pcs = garden_pair(sky, sampler)
    name = sampler.replace("Sampler", "").lower()
    want, jstats = jax_render(jcs, jscene.camera, SIZE, SIZE, JS.SAMPLERS[name](SPP), SPP, DEPTH,
                              return_stats=True)
    got, pstats = render_wavefront(pcs, None, SIZE, SIZE, PS.SAMPLERS[name](SPP), SPP, DEPTH,
                                   return_stats=True)
    return np.asarray(want), float(jstats["traced_rays"]), got.numpy(), pstats["traced_rays"]


def test_reduced_garden_matches_pine_tpu():
    want, rays_want, got, rays_got = render_pair("atmosphere", "SobolSampler")
    assert_renders_agree(got, want, rays_got, rays_want)
