"""The grid-media slice as a whole: bench_cloud.py's cloud and
scripts_explosion.py's emissive VDB against pine_tpu.

1. ``scenes.cloud`` and ``scenes.explosion`` are the repository's scenes:
   their grids bit for bit ``scripts_cloud.make_cloud`` and
   ``scripts_explosion.make_explosion``'s, read back from the ``.nvdb``
   file each writes; the same prims, materials, medium parameters and
   camera as ``bench_cloud.build_scene``'s (96^3, 1920x1080).
2. The reduced cloud (16^3, 24x16 film) and the reduced explosion (16^3,
   16x16 film), BlueSampler(2), depth 3, by the path integrator: pine_tpu's
   compiled scene carried across by convert, against pine_tpu evaluated op
   by op (``jax.disable_jit``), per lane: each sample's radiance of each
   pixel (``path_trace_sample``), held to 1e-3 relative or 1e-4 absolute on
   97 % of the lane-samples (LANE_SHARE), the means to 1 %, and the film
   the mean of those samples.  Measured: 99.3 % (cloud) and 99.2 %
   (explosion) of the lane-samples; by pixels of the 2-spp film 98.7 % and
   98.4 %.  The lanes that differ are NEE lanes whose shadow ray's origin
   differs from pine_tpu's in the last bit: the ratio tracking of a shadow
   ray is keyed by a hash of the ray's bits (``media_track.ray_key``), so
   such a lane draws an independent estimate.  Against pine_tpu's jitted
   render the agreement is lower (71.9 % and 82.8 % of the pixels):
   the jitted tracking and shading fuse multiply-adds, which the op-by-op
   evaluation does not (at depth 2, 30 of 256 lanes of one sample differ
   from the jitted render, none from the op-by-op one).
3. ``python -m pine_tpu_torch.bench_cloud`` exits with status 1 without a
   card; its ``render`` averages its batches as one render of all samples.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_csg import carried_arrays
from test_torch_render import assert_renders_agree

torch.set_num_threads(2)

SPP, DEPTH = 2, 3
# lane-samples that agree to 1e-3 relative or 1e-4 absolute (measured: 99.3 %
# and 99.2 %): an ulp of a shadow ray's origin (pine_tpu's jnp.linalg.norm,
# a jitted function, fuses multiply-adds) changes ray_key's hash of its bits
# and so the whole random walk of its ratio-tracked transmittance
LANE_SHARE = 0.97


def jax_cloud(size, n):
    """bench_cloud.build_scene with an n^3 cloud on a film of ``size``."""
    import bench_cloud
    import scripts_cloud
    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film

    make = scripts_cloud.make_cloud
    scripts_cloud.make_cloud = lambda _=96: make(n)
    try:
        scene = bench_cloud.build_scene()
    finally:
        scripts_cloud.make_cloud = make
    scene.set(ThinLenCamera(Film(list(size), "uncharted2"), [0, 1.0, -2.6], [0, 1.0, 1.0], 0.44))
    return scene


def jax_explosion(size, n):
    """scripts_explosion.main's scene, built, with n^3 grids."""
    import tempfile

    import scripts_explosion
    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film
    from pine_tpu.io.nvdb import write_nvdb_multi
    from pine_tpu.scene import materials as M
    from pine_tpu.scene import shapes as S
    from pine_tpu.scene.media import CloudPhaseFunction, VDBMedium
    from pine_tpu.scene.scene import Scene

    dens, flame, temp = scripts_explosion.make_explosion(n)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= np.diag([2.4, 2.4, 2.4]).astype(np.float32)
    m[:3, 3] = [-1.2, 0.0, -1.2]
    sc = Scene()
    sc.add("floor", M.Diffuse([0.45, 0.42, 0.4]))
    sc.add(S.Rect([0, 0, 0], [12, 0, 0], [0, 0, 12]), "floor")
    sc.add(S.Rect([0, 0.01, 6], [12, 0, 0], [0, 10, 0], True), "floor")
    sc.add(S.Rect([-4, 7, -6], [2.5, 0, 0], [0, 0, 2.5]), M.Emissive([16.0, 15.0, 14.0]))
    with tempfile.TemporaryDirectory() as d:
        write_nvdb_multi(f"{d}/e.nvdb", {"density": dens, "flames": flame, "temperature": temp})
        sc.add(VDBMedium(f"{d}/e.nvdb", m, CloudPhaseFunction(0.6), [6.0, 6.0, 6.0],
                         [4.0, 4.0, 4.0], 3.0, 0.9))
    sc.set(ThinLenCamera(Film([size, size], "uncharted2"), [0, 1.6, -4.6], [0, 1.1, 0], 0.3))
    return sc


def test_scenes_are_the_repositorys():
    import scripts_cloud
    import scripts_explosion

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import scene_arrays

    np.testing.assert_array_equal(scenes.make_cloud(96), scripts_cloud.make_cloud(96))
    for a, b in zip(scenes.make_explosion(24), scripts_explosion.make_explosion(24)):
        np.testing.assert_array_equal(a, b)
    for port, ref in ((scenes.cloud(), jax_cloud((1920, 1080), 96)),
                      (scenes.explosion(16, 24), jax_explosion(16, 24))):
        pa, ja = scene_arrays(port), ref.compile()
        np.testing.assert_array_equal(pa["g_type"], ja.g_type)
        for tid, table in ja.tables.items():
            np.testing.assert_array_equal(pa[f"table.{tid}"], np.asarray(table))
        (pm,), (jm,) = port.mediums, ref.mediums
        for k in ("density", "flame", "temperature", "m", "m_inv", "sigma_a", "sigma_s"):
            want = getattr(jm, k)
            if want is None:
                assert getattr(pm, k) is None
            else:
                np.testing.assert_array_equal(getattr(pm, k), np.asarray(want), err_msg=k)
        for k in ("sigma_maj", "blackbody_intensity", "temperature_scale", "emissive"):
            assert getattr(pm, k) == getattr(jm, k), k
        assert (pm.pf.l0.g, pm.pf.l1.g, pm.pf.w) == (jm.pf.l0.g, jm.pf.l1.g, jm.pf.w)
        np.testing.assert_array_equal(port.camera.c2w, ref.camera.c2w)
        assert port.camera.film.width == ref.camera.film.width


def lane_samples(jcs, pcs, cam, W, H, spp, depth):
    """Each sample's radiance per lane (pixels in row order) -> (pine_tpu's
    path_trace_sample op by op, the port's), (spp, W*H, 3) each."""
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import path_trace_sample as jax_sample

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import path_trace_sample

    ys, xs = np.divmod(np.arange(W * H), W)
    jxs, jys = jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32)
    pxs, pys = torch.as_tensor(xs, dtype=torch.int32), torch.as_tensor(ys, dtype=torch.int32)
    with jax.disable_jit():
        want = [np.asarray(jax_sample(jcs, cam.params(), jxs, jys, W, H, JBlue(spp), i, depth))
                for i in range(spp)]
    got = [path_trace_sample(pcs, pcs.camera, pxs, pys, W, H, BlueSampler(spp), i, depth)[0]
           .numpy() for i in range(spp)]
    return np.stack(want), np.stack(got)


@pytest.mark.parametrize("which", ["cloud", "explosion"])
def test_reduced_render_matches_pine_tpu_op_by_op(which):
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene = jax_cloud((24, 16), 16) if which == "cloud" else jax_explosion(16, 16)
    W, H = scene.camera.film.width, scene.camera.film.height
    jcs = scene.compile()
    assert len(jcs.grid_media) == 1 and jcs.unified is None
    pcs = compiled_scene_from_arrays(carried_arrays(jcs, scene.camera), "cpu")
    want, got = lane_samples(jcs, pcs, scene.camera, W, H, SPP, DEPTH)
    d = np.abs(got - want)
    share = ((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean()
    assert share >= LANE_SHARE, share
    assert abs(got.mean() - want.mean()) <= 0.01 * abs(want.mean())
    # the film is the mean of those samples
    img = render_wavefront(pcs, None, W, H, BlueSampler(SPP), SPP, DEPTH).numpy()
    np.testing.assert_allclose(img.reshape(-1, 3), got.mean(0), rtol=1e-5, atol=1e-6)
    assert img.mean() > 0.01


def test_bench_cloud_entry_and_render():
    from pine_tpu_torch import bench_cloud
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    if not torch.cuda.is_available():
        assert bench_cloud.main([]) == 1
    scene = bench_cloud.build_scene((12, 8), 16)
    cs = scene.compile("cpu")
    sampler = BlueSampler(4)
    bench_cloud.BATCH, batch = 2, bench_cloud.BATCH
    try:
        got, st = bench_cloud.render(cs, scene, sampler, 4, 2, (12, 8), return_stats=True)
    finally:
        bench_cloud.BATCH = batch
    want, want_st = render_wavefront(cs, scene.camera, 12, 8, sampler, 4, 2, return_stats=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert st == want_st
