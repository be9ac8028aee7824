"""MicroRenderGI against pine_tpu: the surfel draw, the light it picks, the
push-pull, the microbuffer gather and a reduced render.

1. ``_surfel_sample`` (2,048 surfels) bit for bit pine_tpu's: positions,
   normals, geometry ids and total area, on the classic-style scene
   (scenes.CLASSIC_MICRO_PRL through each package's interpreter: a disk,
   spheres, a rect), the tame box (tests/test_integrators.py), that box
   with a seeded 242-triangle mesh, and the bench box (scenes.CBOX_PRL:
   cones, OBBs on the box-top fallback).  The draw is one numpy stream, so
   a shape's area one bit off would move every later surfel: the port's
   ``area()`` is pine_tpu's formula in pine_tpu's dtypes.
2. ``_pick_light`` for a point light, a directional light and an area light
   (the box's emissive rect): equal.
3. ``_push_pull`` on seeded sparse buffers: bit for bit (maxima, halvings
   and selections).
4. ``_microbuffer_gather`` on 64 seeded receivers and 512 surfels against
   pine_tpu's jitted: each receiver's gather to rtol 1e-4 / atol 1e-6 on
   97 % of them.  The port writes the dot products
   out term by term and takes core/fmath's atan2 (pine_tpu: einsum and
   XLA's atan2), so a surfel whose direction lies within an ulp of a cell
   edge can land in the neighbouring cell; the colour sums are float64
   rounded once, the final sum over 1,024 cells too (pine_tpu's einsum sums
   in float32).
5. ``render_micro`` on the classic scene at 32x16 with 256 surfels, against
   pine_tpu's (jitted, as it runs it): test_torch_render's rule (97 % of
   pixels to 1e-3 relative or 1e-4 absolute, means to 1 %).  And the script
   through the port's interpreter equals render_micro's image bit for bit.

pine_tpu runs jitted here: MicroRenderGI traces no path that a fused
multiply-add could turn (one camera hit, one shadow ray a point, the
gather), and op by op its first render compiles each operation (25 s).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.integrators import micro_render as JMR
from test_torch_render import assert_renders_agree

from pine_tpu_torch import scenes
from pine_tpu_torch.integrators import micro_render as PMR

torch.set_num_threads(2)


def both_scripts(src):
    """``scene`` of the PRL script ``src`` through pine_tpu's and the port's
    interpreters -> (pine_tpu's, the port's)."""
    from pine_tpu.prl.interp import Interpreter as JInterp

    j = JInterp(out=lambda s: None)
    j.run(src)
    return j.get_var("scene"), scenes.prl_scene(src, device="cpu")


def mesh_rows(seed=4, grid=12):
    """A seeded bumpy 11 x 11 x 2-triangle mesh over the box's floor."""
    rng = np.random.default_rng(seed)
    x, z = np.meshgrid(np.linspace(-0.8, 0.8, grid), np.linspace(0.2, 1.8, grid), indexing="ij")
    y = 0.05 + 0.2 * rng.random((grid, grid))
    V = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(grid - 1), np.arange(grid - 1), indexing="ij")
    a, b, c, d = i * grid + j, (i + 1) * grid + j, (i + 1) * grid + j + 1, i * grid + j + 1
    F = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)]).reshape(-1, 3)
    return V, F.astype(np.uint32)


def scene_pair(case):
    """(pine_tpu's scene, the port's) of a surfel case."""
    from test_integrators import tame_cbox
    from test_torch_restir import port_tame_box

    if case == "classic":
        return both_scripts(scenes.classic_micro_prl((32, 16), None, None))
    if case == "cbox":
        return both_scripts(scenes.CBOX_PRL)
    j, p = tame_cbox(16), port_tame_box(16)
    if case == "mesh":
        from pine_tpu.scene import materials as JM
        from pine_tpu.scene import shapes as JS

        from pine_tpu_torch.scene import materials as PM
        from pine_tpu_torch.scene import shapes as PS

        V, F = mesh_rows()
        j.add(JS.Mesh(V, F), JM.Diffuse([0.5, 0.6, 0.7]))
        p.add(PS.Mesh(V, F), PM.Diffuse([0.5, 0.6, 0.7]))
    return j, p


@pytest.mark.parametrize("case", ["classic", "tame", "mesh", "cbox"])
def test_surfel_draw_is_pine_tpus_bit_for_bit(case):
    js, ps = scene_pair(case)
    assert [type(s).__name__ for s, _ in js.geometries] == [
        type(s).__name__ for s, _ in ps.geometries]
    np.testing.assert_array_equal([s.area() for s, _ in ps.geometries],
                                  [s.area() for s, _ in js.geometries])
    want = JMR._surfel_sample(js, 2048)
    got = PMR._surfel_sample(ps, 2048)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] and len(set(got[2].tolist())) > 3
    if case == "mesh":
        np.testing.assert_array_equal(ps.geometries[-1][0].triangle_areas(),
                                      js.geometries[-1][0].triangle_areas())


def test_pick_light_is_pine_tpus():
    from test_integrators import tame_cbox
    from test_torch_restir import port_tame_box

    from pine_tpu.scene import lights as JL

    from pine_tpu_torch.scene import lights as PL

    for extra in (None, "point", "directional"):
        js, ps = tame_cbox(8), port_tame_box(8)
        if extra == "point":
            js.add(JL.PointLight(np.float32([0.2, 1.5, 0.7]), np.float32([5, 4, 3])))
            ps.add(PL.PointLight([0.2, 1.5, 0.7], [5, 4, 3]))
        elif extra == "directional":
            js.add(JL.DirectionalLight([0.3, -1.0, 0.2], [2, 2, 1]))
            ps.add(PL.DirectionalLight([0.3, -1.0, 0.2], [2, 2, 1]))
        want = JMR._pick_light(js.compile())
        got = PMR._pick_light(ps.compile("cpu"), ps)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2] == (extra == "directional")


def test_push_pull_is_pine_tpus():
    rng = np.random.default_rng(8)
    color = rng.exponential(1.0, (16, 32, 32, 3)).astype(np.float32)
    occ = rng.random((16, 32, 32)) < np.linspace(0.02, 0.6, 16)[:, None, None]
    for hb in (32, 16):
        c, o = color[:, :hb, :hb].copy(), occ[:, :hb, :hb].copy()
        want = np.asarray(jax.jit(JMR._push_pull, static_argnums=2)(jnp.asarray(c),
                                                                     jnp.asarray(o), hb))
        got = PMR._push_pull(torch.from_numpy(c), torch.from_numpy(o), hb).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want > 0).all(-1).mean() > (o.mean() + 0.05)


def test_microbuffer_gather_matches():
    rng = np.random.default_rng(9)
    m, S = 64, 512
    p = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    n = rng.normal(size=(m, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    P = rng.uniform(-1.5, 1.5, (S, 3)).astype(np.float32)
    N = rng.normal(size=(S, 3))
    N = (N / np.linalg.norm(N, axis=1, keepdims=True)).astype(np.float32)
    cd = rng.exponential(1.0, (S, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JMR._microbuffer_gather)(*map(jnp.asarray, (p, n, P, N, cd)), 0.05))
    got = PMR._microbuffer_gather(*map(torch.from_numpy, (p, n, P, N, cd)), 0.05).numpy()
    assert np.isfinite(got).all() and (want > 0).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() >= 0.97, close.mean()


def test_reduced_render_matches_pine_tpu():
    js, ps = scene_pair("classic")
    want = np.asarray(JMR.render_micro(js.compile(), js.camera, 32, 16, 256, chunk=512))
    pcs = ps.compile("cpu")
    got, st = PMR.render_micro(pcs, ps, ps.camera, 32, 16, 256, return_stats=True)
    assert want.mean() > 0.05 and st["traced_rays"] > 256 + 32 * 16
    assert_renders_agree(got.numpy(), want)
    # the script through the port's interpreter: MicroRenderGI(256)
    src = scenes.classic_micro_prl((32, 16), 256, None)
    np.testing.assert_array_equal(scenes.prl_scene(src, device="cpu").camera.film.rgb.numpy(),
                                  got.numpy())
