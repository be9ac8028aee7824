"""RestirIntegrator against pine_tpu: one sample of the whole film lane by
lane, and the port's render against its own depth-2 path render.

1. ``restir_sample`` of sample 1 on the whole 24x24 film (row-major: the
   spatial reuse gathers neighbours by pixel index), BlueSampler(4), against
   pine_tpu's ``_restir_sample`` op by op (``jax.disable_jit``: its jitted
   trace fuses multiply-adds), on the tame box, its homogeneous fog and its
   grid medium (test_torch_mlt.jax_scene), the port's compiled scene
   carried from pine_tpu's: each lane's radiance to 1e-3 relative or 1e-4
   absolute on 97 % of the lanes (test_torch_cloud's LANE_SHARE: a grid
   medium's ratio tracking is keyed by the bits of its ray, and a
   reservoir that takes another candidate on one lane passes it on to the
   lanes that merge it).
2. The port's render (BlueSampler(16)) against its PathIntegrator at depth
   2 and 128 spp on the tame box: the means within 10 %
   (tests/test_integrators.py's check; ReSTIR is direct light only).
3. A script's RestirIntegrator through the port's interpreter equals
   render_restir's image bit for bit, and warns of a grid medium.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.core.samplers import BlueSampler as JBlue
from pine_tpu.integrators import restir as JR
from test_torch_cloud import LANE_SHARE
from test_torch_mlt import SIZE, carried, lanes_agree

from pine_tpu_torch.core.samplers import BlueSampler
from pine_tpu_torch.integrators import restir as PR

torch.set_num_threads(2)


def port_tame_box(res):
    """tests/test_integrators.py's tame_cbox through the port's Scene API."""
    from pine_tpu_torch.core.camera import ThinLenCamera
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    sc = Scene()
    sc.add("w", M.Diffuse([0.8, 0.8, 0.8]))
    sc.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "w")
    sc.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "w")
    sc.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), M.Diffuse([0.8, 0.2, 0.2]))
    sc.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), M.Diffuse([0.2, 0.8, 0.2]))
    sc.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "w")
    sc.add(S.Sphere([0.3, 0.5, 1.0], 0.5), "w")
    sc.add(S.Rect([0, 1.99, 1], [1.2, 0, 0], [0, 0, 1.2]), M.Emissive([4.0, 4.0, 4.0]))
    sc.set(ThinLenCamera(Film([res, res], "uncharted2"), [0, 1, -3.5], [0, 1, 0], 0.3))
    return sc


@pytest.mark.parametrize("kind", [None, "fog", "grid"])
def test_one_sample_of_the_film_matches_lane_by_lane(kind):
    scene, jcs, pcs = carried(kind)
    n = SIZE * SIZE
    ys, xs = np.divmod(np.arange(n), SIZE)
    with jax.disable_jit():
        want = np.asarray(JR._restir_sample(jcs, scene.camera.params(), jnp.asarray(xs, jnp.int32),
                                            jnp.asarray(ys, jnp.int32), SIZE, SIZE, JBlue(4), 1))
    got, rays = PR.restir_sample(pcs, pcs.camera, torch.as_tensor(xs, dtype=torch.int32),
                                 torch.as_tensor(ys, dtype=torch.int32), SIZE, SIZE,
                                 BlueSampler(4), 1)
    got = got.numpy()
    assert np.isfinite(got).all() and want.mean() > 0.01 and n < int(rays) <= 2 * n
    assert lanes_agree(got, want) >= LANE_SHARE, lanes_agree(got, want)


def test_render_matches_own_direct_path_render():
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene = port_tame_box(32)
    cs = scene.compile("cpu")
    ref = render_wavefront(cs, scene.camera, 32, 32, UniformSampler(128), 128, 2).numpy()
    img, st = PR.render_restir(cs, scene.camera, 32, 32, BlueSampler(16), 16, return_stats=True)
    img = img.numpy()
    assert np.isfinite(img).all() and st["traced_rays"] > 16 * 32 * 32
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.1, rel


def test_script_renders_through_the_interpreter():
    from pine_tpu_torch import scenes
    from pine_tpu_torch.core import log
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device="cpu")
    itp.run(scenes.csg_fog_prl(16, integrator="RestirIntegrator(BlueSampler(2), 2)", save=None))
    scene = itp.get_var("scene")
    want = PR.render_restir(scene.compile("cpu"), scene.camera, 16, 16, BlueSampler(2), 2)
    np.testing.assert_array_equal(scene.camera.film.rgb.numpy(), want.numpy())
    cloud = scenes.cloud((8, 8), 8)
    said = []
    log.streams["warning"], keep = said.append, log.streams["warning"]
    try:
        PR.RestirIntegrator(BlueSampler(1), 2).render(cloud, device="cpu")
    finally:
        log.streams["warning"] = keep
    assert len(said) == 1 and "grid (VDB) media" in said[0]
