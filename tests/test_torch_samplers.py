"""The garden slice's samplers and procedural inputs against pine_tpu.

1. ``SobolSampler`` and ``HaltonSampler``: bit-equal to pine_tpu's on 2,052
   pixels of a 640x640 film (2,048 drawn from a seed and the four corners)
   at sample indices 0-15, for every dim the path schedule reads at depth 5
   (integrators/path.py's docstring): dims 0-3, each scattering depth's
   +0..+9, and the subsurface walk's block (4 + 5*16 + d*32, +0..+24) at
   every depth.  pine_tpu takes the 16 sample indices as one array.
2. The noise functions (``perlin_noise1/2/3``, ``fbm``, ``fbm2d``, ``fbm3d``,
   octaves as a number and per lane) and the procedural nodes (Position,
   Normal, Unary, Lerp, Checkerboard, Noisef, Noise3f, Component, ToVec3),
   on seeded points: rtol 1e-4 / atol 1e-6 (XLA's CPU backend fuses
   multiply-adds; the port does not).  Checkerboard, a 0/1 step, is compared
   on points away from its cell boundaries.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.core import noise as JN
from pine_tpu.core import samplers as JS
from pine_tpu.scene import nodes as JNd
from pine_tpu_torch.core import noise as PN
from pine_tpu_torch.core import samplers as PS
from pine_tpu_torch.scene import nodes as PNd

torch.set_num_threads(2)

MAX_DEPTH = 5
RTOL, ATOL = 1e-4, 1e-6


def schedule_dims(max_depth=MAX_DEPTH):
    """Every sampler dim a depth-``max_depth`` path with a subsurface walk reads."""
    dims = set(range(4))
    for d in range(max_depth - 1):  # the last depth only intersects
        dims.update(4 + d * 16 + k for k in range(10))
        dims.update(4 + max_depth * 16 + d * 32 + k for k in range(25))
    return sorted(dims)


@pytest.fixture(scope="module")
def film_lanes():
    rng = np.random.default_rng(13)
    px = np.concatenate([rng.integers(0, 640, 2048), [0, 639, 0, 639]]).astype(np.int32)
    py = np.concatenate([rng.integers(0, 640, 2048), [0, 0, 639, 639]]).astype(np.int32)
    return px, py


@pytest.mark.parametrize("name", ["sobol", "halton"])
def test_sampler_bit_equal_on_the_path_schedule(name, film_lanes):
    px, py = film_lanes
    js, ps = JS.SAMPLERS[name](16), PS.SAMPLERS[name](16)
    spp = 16
    jx, jy = jnp.asarray(np.tile(px, spp)), jnp.asarray(np.tile(py, spp))
    jsi = jnp.asarray(np.repeat(np.arange(spp), len(px)).astype(np.uint32))
    tx, ty = torch.as_tensor(px), torch.as_tensor(py)
    dims = schedule_dims()
    assert len(dims) == 144 and dims[-1] == 4 + 80 + 3 * 32 + 24
    for dim in dims:
        want = np.asarray(js.u1(jx, jy, jsi, dim)).reshape(spp, -1)
        got = np.stack([ps.u1(tx, ty, si, dim).numpy() for si in range(spp)])
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"{name} dim {dim}")
    np.testing.assert_array_equal(ps.u2(tx, ty, 3, 9).numpy(),
                                  np.asarray(js.u2(jnp.asarray(px), jnp.asarray(py), 3, 9)))


def test_owen_scramble_matches_uint64_arithmetic():
    """The scramble's int64 multiply in two halves is the uint32 product: the
    hash against numpy's uint64 on random words and the extremes."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        np.asarray([0, 1, 2**31, 2**32 - 1], np.uint64)])
    seed = rng.integers(0, 2**32, x.shape[0], dtype=np.uint64)

    def rev(v):
        return np.asarray([int(f"{int(b):032b}"[::-1], 2) for b in v], np.uint64)

    m = np.uint64(0xFFFFFFFF)
    want = (rev(x) + seed) & m
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        want = want ^ ((want * np.uint64(c)) & m)
    want = rev(want)
    got = PS.owen_scramble(torch.as_tensor(x.astype(np.int64)), torch.as_tensor(seed.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(2000, 3)) * 4).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 2])
def test_perlin_noise_matches(points, seed):
    p = points
    close(PN.perlin_noise3(torch.as_tensor(p), seed), JN.perlin_noise3(jnp.asarray(p), seed))
    close(PN.perlin_noise2(torch.as_tensor(p[:, :2]), seed),
          JN.perlin_noise2(jnp.asarray(p[:, :2]), seed))
    close(PN.perlin_noise1(torch.as_tensor(p[:, 0]), seed),
          JN.perlin_noise1(jnp.asarray(p[:, 0]), seed))


@pytest.mark.parametrize("octaves", [1, 4, 8])
def test_fbm_matches(points, octaves):
    p = points
    for pf, jf in ((PN.fbm, JN.fbm), (PN.fbm3d, JN.fbm3d)):
        close(pf(torch.as_tensor(p), octaves), jf(jnp.asarray(p), octaves))
    close(PN.fbm2d(torch.as_tensor(p[:, :2]), octaves), JN.fbm2d(jnp.asarray(p[:, :2]), octaves))
    close(PN.fbm(torch.as_tensor(p[:, 0]), octaves), JN.fbm(jnp.asarray(p[:, 0]), octaves))
    lanes = np.random.default_rng(octaves).integers(0, 9, p.shape[0])
    close(PN.fbm(torch.as_tensor(p), torch.as_tensor(lanes)), JN.fbm(jnp.asarray(p), jnp.asarray(lanes)))


def node_pairs():
    """(pine_tpu node, port node) of each ported kind, over Position and Normal."""
    pairs = []
    for mod in (JNd, PNd):
        P, Nn = mod.Position(), mod.Normal()
        pairs.append([
            P, Nn, mod.Unary("-", P), mod.Unary("s", P), mod.Unary("r", mod.Unary("s", Nn)),
            mod.Unary("f", P * 1.7),
            mod.Lerp(mod.Noisef(P, 3), mod.Constant([0.2, 0.3, 0.4]), mod.Constant([0.9, 0.1, 0.5])),
            mod.Lerp(0.25, P, Nn), mod.Noisef(P * 3.0, 3), mod.Noise3f(P * 4.0, 4),
            mod.Component(mod.ToVec3(mod.Noisef(P, 2)), 0), mod.ToVec3(mod.Component(P, 2)),
            mod.ToVec3(mod.Component(P, 0), mod.Component(Nn, 1), mod.Noisef(P, 1)),
            mod.Noise3f(P, mod.Constant(2.0)), -(P + Nn) * 0.5,
        ])
    return list(zip(*pairs))


def test_nodes_match(points):
    rng = np.random.default_rng(8)
    n = rng.normal(size=points.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = rng.random((points.shape[0], 2)).astype(np.float32)
    jctx = dict(p=jnp.asarray(points), n=jnp.asarray(n), uv=jnp.asarray(uv))
    pctx = dict(p=torch.as_tensor(points), n=torch.as_tensor(n), uv=torch.as_tensor(uv))
    for jnode, pnode in node_pairs():
        close(pnode.eval(pctx), jnode.eval(jctx))
    # the Checkerboard away from its cell boundaries (a 0/1 step there)
    q = points * 2.0 + np.float32([0.0, 0.25, 0.0])
    frac = q - np.floor(q)
    far = (np.abs(frac - 0.5) > 1e-3).all(-1)
    jc = np.asarray(JNd.Checkerboard(JNd.Position() * 2.0 + JNd.Constant([0.0, 0.25, 0.0])).eval(jctx))
    pc = PNd.Checkerboard(PNd.Position() * 2.0 + PNd.Constant([0.0, 0.25, 0.0])).eval(pctx).numpy()
    assert far.mean() > 0.99 and set(np.unique(pc)) == {0.0, 1.0}
    np.testing.assert_array_equal(pc[far], jc[far])
    np.testing.assert_array_equal(PNd.Checkerboard().eval(pctx).numpy(),
                                  np.asarray(JNd.Checkerboard().eval(jctx)))
