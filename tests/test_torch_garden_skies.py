"""The garden's other skies, as test_torch_garden.py holds its Atmosphere
(32x32, 4 spp, depth 2; that file's docstring says why depth 2), pine_tpu's
compiled scene carried across by convert.

1. ``Sky([1, 1, 1])`` with BlueSampler, both path integrators: held to
   test_torch_render's rule, 97 % of pixels to 1e-3 relative or 1e-4
   absolute, means to 1 %, traced rays to 0.5 %.
2. ``ImageSky(load_image("images/cbox0.png"))`` with HaltonSampler, sample by
   sample (each package's ``path_trace_sample``, pine_tpu's jitted once for
   all four samples): held at the lane level, 98.5 % of the 4,096
   lane-samples to 1e-3 relative or 1e-4 absolute, the mean radiance to 1 %
   and the traced rays to 0.5 %.  Not the pixel rule: under this sky 1.2 %
   of the lane-samples differ (measured: 8 and 16 of the 1,024 lanes of
   samples 0 and 1), which leaves 95.4 % of the pixels of a 4-spp render.
   They are pine_tpu's own: evaluated op by op (``jax.disable_jit``), its
   path agrees with the port's on every lane of those samples, and with its
   jitted self on all but those same lanes, where XLA fuses multiply-adds
   into the traversal's cone tests (a discriminant near zero, ROADMAP.md
   §3); the op-by-op evaluation takes minutes a sample on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_garden import DEPTH, SIZE, SPP, garden_pair, render_pair
from test_torch_render import assert_renders_agree, differing

torch.set_num_threads(2)


def test_reduced_garden_sky_matches_pine_tpu():
    want, rays_want, got, rays_got = render_pair("sky", "BlueSampler")
    assert_renders_agree(got, want, rays_got, rays_want)


def test_reduced_garden_imagesky_lanes_match_pine_tpu():
    from pine_tpu.core.samplers import HaltonSampler as JHalton
    from pine_tpu.integrators.path import path_trace_sample as jax_sample

    from pine_tpu_torch.core.samplers import HaltonSampler
    from pine_tpu_torch.integrators.path import path_trace_sample, tile_order

    jscene, jcs, pcs = garden_pair("imagesky", "HaltonSampler")
    ys, xs = np.divmod(tile_order(SIZE, SIZE), SIZE)
    xs, ys = xs.astype(np.int32), ys.astype(np.int32)
    cam, jsampler = jscene.camera.params(), JHalton(SPP)
    trace = jax.jit(lambda x, y, s: jax_sample(jcs, cam, x, y, SIZE, SIZE, jsampler, s, DEPTH,
                                               return_stats=True))
    bad = 0
    sums = np.zeros(2)
    rays = np.zeros(2)
    for si in range(SPP):
        lj, rj = trace(jnp.asarray(xs), jnp.asarray(ys), jnp.int32(si))
        lp, rp = path_trace_sample(pcs, pcs.camera, torch.as_tensor(xs), torch.as_tensor(ys),
                                   SIZE, SIZE, HaltonSampler(SPP), si, DEPTH)
        lj, lp = np.asarray(lj)[:, None], lp.numpy()[:, None]
        bad += int(differing(lp, lj).sum())
        sums += (lp.mean(), lj.mean())
        rays += (int(rp), float(rj))
    assert bad <= 0.015 * SPP * xs.size, bad
    assert abs(sums[0] - sums[1]) <= 0.01 * abs(sums[1])
    assert abs(rays[0] - rays[1]) <= 0.005 * rays[1]
