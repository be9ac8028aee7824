"""MltIntegrator against pine_tpu: the mutation, the acceptance, one chain
evaluation lane by lane, one lockstep step, and the port's whole render
against its own path integrator.

pine_tpu runs op by op (``jax.disable_jit``): its jitted trace would fuse
multiply-adds, which the port, like its other integrators, follows op by
op.  The scenes are pine_tpu's tests': the tame box
(tests/test_integrators.py), with the homogeneous fog of tests/test_media.py
(``foggy``) or its grid medium (``grid_foggy``), carried to the port by
convert (test_torch_csg.carried_arrays).

1. ``mutate`` on 512 chains x 68 dims over four steps: the large steps
   exactly, the mutated coordinates to 2e-6 in torus distance (the Box-Muller
   draw's log and cos: the port's core/fmath is correctly rounded, XLA's
   within an ulp or two, ROADMAP.md section 3).  ``accept_prob`` and
   ``luminance`` bit for bit on seeded values.
2. ``mlt_radiance`` of one seeded X (512 chains) on the tame box, the fog
   and the grid medium: the film positions bit for bit, each lane's
   radiance to 1e-3 relative or 1e-4 absolute on 97 % of the lanes
   (test_torch_cloud's LANE_SHARE: a grid medium's shadow ray's ratio
   tracking is keyed by the bits of its origin, so an ulp there draws
   another estimate).
3. One lockstep step from the same X and L on the tame box: the splats'
   image to 1e-5 relative or 1e-7 absolute on 99 % of its pixels (the port
   adds each pixel's splats in float64 and rounds once, pine_tpu in float32
   in lane order; a chain whose proposal's radiance differs moves its
   weights), the acceptances equal on 99 % of the chains.
4. The port's render_mlt (its default 4,096 chains: 24 bootstrap rounds,
   and 16 spp on average: 2 steps; depth 4) against its own path integrator
   at 64 spp on the tame box: the means within 15 %
   (tests/test_integrators.py's check; measured 6.4 %: MLT's mean rests on
   its bootstrap's estimate of the image's luminance).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.integrators import mlt as JM
from test_torch_cloud import LANE_SHARE
from test_torch_csg import carried_arrays

from pine_tpu_torch.convert import compiled_scene_from_arrays
from pine_tpu_torch.integrators import mlt as PM

torch.set_num_threads(2)

SIZE, DEPTH = 24, 4


def jax_scene(kind):
    """pine_tpu's tame box at SIZE^2 with the medium ``kind`` adds: None,
    "fog" (tests/test_media.py's foggy) or "grid" (its grid_foggy)."""
    from test_integrators import tame_cbox

    from pine_tpu.scene import shapes as S
    from pine_tpu.scene.media import GridMedium, HgPhaseFunction, HomogeneousMedium

    scene = tame_cbox(SIZE)
    if kind == "fog":
        scene.add(HomogeneousMedium(S.BoxAABB([-1, 0, 0], [1, 2, 2]), HgPhaseFunction(0.3),
                                    [0.05, 0.08, 0.05], [0.25, 0.3, 0.35]))
    elif kind == "grid":
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 1.6
        m[:3, 3] = [-0.8, 0.2, 0.2]
        scene.add(GridMedium(np.full((8, 8, 8), 0.8, np.float32), m, HgPhaseFunction(0.2),
                             [0.03, 0.03, 0.03], [0.3, 0.35, 0.4]))
    return scene


def carried(kind):
    """(pine_tpu's scene, its compiled scene, the port's carried from it)."""
    scene = jax_scene(kind)
    jcs = scene.compile()
    return scene, jcs, compiled_scene_from_arrays(carried_arrays(jcs, scene.camera), "cpu")


def lanes_agree(got, want):
    d = np.abs(got - want)
    return ((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean()


def test_mutate_accept_and_luminance_match():
    rng = np.random.default_rng(3)
    X = rng.random((512, 68)).astype(np.float32)
    ids = np.arange(512)
    n_large = 0
    for step in (0, 1, 7, 40):
        with jax.disable_jit():
            jx, jl = JM.mutate(jnp.asarray(X), jnp.asarray(ids, jnp.uint32), step, 5)
        px, pl = PM.mutate(torch.from_numpy(X), torch.from_numpy(ids), step, 5)
        np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
        d = np.abs(px.numpy() - np.asarray(jx))
        assert np.minimum(d, 1.0 - d).max() <= 2e-6
        assert ((px >= 0) & (px < 1)).all()
        n_large += int(pl.sum())
        X = px.numpy()
    assert 0 < n_large < 4 * 512 * 0.05
    lum = rng.exponential(1.0, (2, 4096)).astype(np.float32)
    lum[:, :64] = 0.0
    with jax.disable_jit():
        ja = JM.accept_prob(jnp.asarray(lum[0]), jnp.asarray(lum[1]))
        rgb = rng.exponential(1.0, (4096, 3)).astype(np.float32)
        jlum = JM.luminance(jnp.asarray(rgb))
    np.testing.assert_array_equal(
        PM.accept_prob(torch.from_numpy(lum[0]), torch.from_numpy(lum[1])).numpy(),
        np.asarray(ja))
    np.testing.assert_array_equal(PM.luminance(torch.from_numpy(rgb)).numpy(), np.asarray(jlum))


@pytest.mark.parametrize("kind", [None, "fog", "grid"])
def test_radiance_of_one_x_matches_lane_by_lane(kind):
    scene, jcs, pcs = carried(kind)
    D = PM.sample_dims(pcs, DEPTH)
    assert D == (68 if kind is None else 164)
    X = np.random.default_rng(11).random((512, D)).astype(np.float32)
    with jax.disable_jit():
        jL, jpf = JM.mlt_radiance(jcs, scene.camera.params(), jnp.asarray(X), SIZE, SIZE, DEPTH,
                                  True)
        want = np.asarray(jL)
    got, pf, rays = PM.mlt_radiance(pcs, pcs.camera, torch.from_numpy(X), DEPTH)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jpf))
    assert np.isfinite(got.numpy()).all() and want.mean() > 1e-3
    assert (want > 0).any(-1).mean() > 0.3 and int(rays) > 512 * 2
    assert lanes_agree(got.numpy(), want) >= LANE_SHARE, lanes_agree(got.numpy(), want)


def test_one_lockstep_step_splats_as_pine_tpu():
    scene, jcs, pcs = carried(None)
    C, W, H = 512, SIZE, SIZE
    X = np.random.default_rng(12).random((C, 68)).astype(np.float32)
    ids = np.arange(C)
    with jax.disable_jit():
        cp = scene.camera.params()
        Xj, idsj = jnp.asarray(X), jnp.asarray(ids, jnp.uint32)
        Lp, _ = JM.mlt_radiance(jcs, cp, Xj, W, H, DEPTH, True)
        # render_mlt's step_fn, step 3, seed 0
        Xn, _ = JM.mutate(Xj, idsj, 3, 0)
        Ln, pfn = JM.mlt_radiance(jcs, cp, Xn, W, H, DEPTH, True)
        lp, ln = JM.luminance(Lp), JM.luminance(Ln)
        a = JM.accept_prob(ln, lp)

        def splat(img, pfilm, w_rgb):
            px = jnp.clip((pfilm[:, 0] * W).astype(jnp.int32), 0, W - 1)
            py = jnp.clip((pfilm[:, 1] * H).astype(jnp.int32), 0, H - 1)
            return img.at[py, px].add(w_rgb)

        img = splat(jnp.zeros((H, W, 3), jnp.float32), Xj[:, 0:2],
                    jnp.where((lp > 1e-6)[:, None],
                              Lp / jnp.maximum(lp, 1e-20)[:, None] * (1.0 - a)[:, None], 0.0))
        img = splat(img, pfn, jnp.where((ln > 1e-6)[:, None],
                                        Ln / jnp.maximum(ln, 1e-20)[:, None] * a[:, None], 0.0))
        from pine_tpu.core import rng as jrng

        acc_j = np.asarray(jrng.uniform(idsj, jnp.uint32(3), jnp.uint32(999331)) < a)
        want = np.asarray(img)
        Lp = np.asarray(Lp)
    Xp, _, pix, w, acc, _ = PM.mlt_step(pcs, pcs.camera, torch.from_numpy(X),
                                        torch.from_numpy(Lp.copy()), torch.from_numpy(ids), 3, W,
                                        H, DEPTH)
    got = torch.zeros(H * W, 3, dtype=torch.float64).index_add_(0, pix, w.double())
    got = got.float().reshape(H, W, 3).numpy()
    assert want.sum() > 10.0 and (want > 0).any(-1).mean() > 0.3
    d = np.abs(got - want)
    assert ((d <= 1e-5 * np.abs(want)) | (d <= 1e-7)).all(-1).mean() >= 0.99
    same = acc.numpy() == acc_j
    assert same.mean() >= 0.99 and 0 < acc_j.sum() < C
    # the chains that decided alike hold the same state
    d = np.abs(Xp.numpy() - np.where(acc_j[:, None], np.asarray(Xn), X))[same]
    assert np.minimum(d, 1.0 - d).max() <= 2e-6


def test_render_matches_own_path_integrator():
    from test_torch_restir import port_tame_box

    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene = port_tame_box(SIZE)
    cs = scene.compile("cpu")
    ref = render_wavefront(cs, scene.camera, SIZE, SIZE, UniformSampler(64), 64, DEPTH).numpy()
    img, st = PM.render_mlt(cs, scene.camera, SIZE, SIZE, 16, DEPTH, return_stats=True)
    img = img.numpy()
    assert np.isfinite(img).all() and st["steps"] == SIZE * SIZE * 16 // 4096 == 2
    assert st["boot_rounds"] == 24 and st["accepted"].shape == (2, 4096)
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.15, rel
