"""The reduced garden under CachedPathIntegrator against pine_tpu's: the Sky
variant (``scenes.garden_prl("sky")``, 32x32, SobolSampler(4), depth 2,
cache grid 16), pine_tpu's compiled scene carried across by convert, its
``render_cached`` against the port's.  Held to test_torch_render's rule: 97 %
of pixels to 1e-3 relative or 1e-4 absolute, means to 1 % (measured: 97.75 %
of pixels, means 8e-4 apart).

The Sky, not the Atmosphere: the cache averages the radiance of every
vertex in a cell into each pixel that reads the cell, and the Atmosphere's
radiance differs between the two packages by up to 1.0e-3 in float32
(test_torch_env_lights.py), so under it 23 % of pixels differ by more than
the gate's 1e-3; the Sky's radiance is the same in both.  Depth 2 for the
compile time of pine_tpu's two jitted programs (about a minute and a half
at depth 2; under the Atmosphere at depth 3, over seven minutes on the
CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from test_torch_garden import DEPTH, SIZE, SPP, garden_pair
from test_torch_render import assert_renders_agree

torch.set_num_threads(2)


def test_reduced_garden_cached_matches_pine_tpu():
    from pine_tpu.core.samplers import SobolSampler as JSobol
    from pine_tpu.integrators.cachedpath import render_cached as jax_cached

    from pine_tpu_torch.core.samplers import SobolSampler
    from pine_tpu_torch.integrators.cachedpath import render_cached

    jscene, jcs, pcs = garden_pair("sky", "SobolSampler")
    want = np.asarray(jax_cached(jcs, jscene.camera, SIZE, SIZE, JSobol(SPP), SPP, DEPTH, 16))
    got = render_cached(pcs, None, SIZE, SIZE, SobolSampler(SPP), SPP, DEPTH, jscene.get_aabb(),
                        16)
    assert_renders_agree(got.numpy(), want)
