"""The random-walk integrator and the denoiser (pine_tpu_torch/integrators/
randomwalk.py, denoiser.py) against pine_tpu.

1. The reduced bench box (tests/test_torch_render.py's REDUCED: 36 cones,
   32x32, BlueSampler(4), depth 4) by both packages' random walk (the path
   integrator's wavefront without NEE): pine_tpu's compiled scene carried
   across, the port's render against pine_tpu's jitted one by
   test_torch_render's rule.
2. ``render_aux`` on the same scene: first-hit albedo bit for bit, and
   normals to 1e-6 of pine_tpu's on 99 % of the values (measured: 99.58 %)
   and to 5e-3 on all: the jitted pine_tpu's cone hits fuse multiply-adds,
   and a cone's normal at its hit point carries the hit's last bits (one
   intersect, surface info and material evaluation; misses zero in both).
3. The à-trous filter on one seeded noisy image with its albedo and
   normal buffers against pine_tpu's jitted ``atrous_denoise``, to rtol
   1e-5 / atol 1e-6 (its weights are exp of float32 sums: the port's exp is
   core/fmath's, XLA's its own float32 approximation).
4. ``RandomWalkIntegrator`` and ``denoise`` as PRL builtins: a script that
   renders the reduced box by each integrator and denoises runs on the CPU,
   its film finite, lit and changed by the filter.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SIZE, SPP, DEPTH = 32, 4, 4


@pytest.fixture(scope="module")
def box():
    import bench
    from pine_tpu.prl.interp import Interpreter
    from test_torch_render import REDUCED, jax_scene_arrays

    from pine_tpu_torch.convert import compiled_scene_from_arrays

    (x0, dx, x1), (z0, dz, z1) = REDUCED
    src = (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}")
           .replace("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}"))
    itp = Interpreter()
    itp.run(src, "<reduced cbox>")
    scene = itp.get_var("scene")
    jcs = scene.compile()
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, scene.camera), "cpu")
    return scene, jcs, pcs


def test_random_walk_matches_pine_tpu(box):
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from test_torch_render import assert_renders_agree

    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    scene, jcs, pcs = box
    want, jst = jax_render(jcs, scene.camera, SIZE, SIZE, JBlue(SPP), SPP, DEPTH, nee=False,
                           return_stats=True)
    got, pst = render_wavefront(pcs, None, SIZE, SIZE, BlueSampler(SPP), SPP, DEPTH, nee=False,
                                return_stats=True)
    assert np.asarray(want).mean() > 0
    assert_renders_agree(got.numpy(), np.asarray(want), pst["traced_rays"],
                         float(jst["traced_rays"]))


def test_render_aux_matches_pine_tpu(box):
    from pine_tpu.integrators import denoiser as JD

    from pine_tpu_torch.integrators import denoiser as PD

    scene, jcs, pcs = box
    ja, jn = (np.asarray(x) for x in JD.render_aux(jcs, scene.camera, SIZE, SIZE))
    pa, pn = (x.numpy() for x in PD.render_aux(pcs, None, SIZE, SIZE))
    assert pa.shape == pn.shape == (SIZE, SIZE, 3) and (ja > 0).any()
    np.testing.assert_array_equal(pa, ja)
    assert np.isclose(pn, jn, rtol=1e-6, atol=1e-6).mean() >= 0.99
    np.testing.assert_allclose(pn, jn, atol=5e-3)


def test_atrous_filter_matches_pine_tpu():
    from pine_tpu.integrators import denoiser as JD

    from pine_tpu_torch.integrators import denoiser as PD

    rng = np.random.default_rng(11)
    h, w = 24, 40
    albedo = np.repeat(rng.uniform(0, 1, (h, w // 8, 3)), 8, 1).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal[: h // 2] = [0, 1, 0]
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    color = (albedo * rng.gamma(2.0, 0.5, (h, w, 1))).astype(np.float32)
    want = np.asarray(jax.jit(JD.atrous_denoise)(color, albedo, normal))
    got = PD.atrous_denoise(*map(torch.from_numpy, (color, albedo, normal))).numpy()
    assert np.abs(got - color).max() > 0.1  # the filter did something
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_randomwalk_and_denoise_builtins_run():
    import bench
    from test_torch_render import REDUCED

    from pine_tpu_torch.prl.interp import Interpreter

    (x0, dx, x1), (z0, dz, z1) = REDUCED
    src = (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}")
           .replace("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}")
           .replace("[640, 640]", f"[{SIZE}, {SIZE}]"))
    src += "RandomWalkIntegrator(BlueSampler(4), 4).render(scene);\n"
    itp = Interpreter(device="cpu")
    itp.run(src)
    film = itp.get_var("scene").camera.film
    rw = film.rgb.clone()
    itp.run("PathIntegrator(BlueSampler(4), 4).render(scene); denoise(scene);")
    out = film.rgb
    assert torch.isfinite(out).all() and rw.mean() > 0 and out.mean() > 0
    assert type(itp.builtins["RandomWalkIntegrator"](None, 2)).__name__ == "RandomWalkIntegrator"
