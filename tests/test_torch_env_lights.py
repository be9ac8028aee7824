"""The garden slice's lights, shapes and scene inputs against pine_tpu.

1. ``Distribution2D``: its tables, and the row and column of every sample,
   bit for bit pine_tpu's, on a density with rows and runs of zero density
   (equal CDF entries) and with u equal to CDF entries; the port finds the
   column by one search over the rows laid end to end, where pine_tpu
   gathers the lane's whole row.
2. ``Sky``, ``Atmosphere`` and ``ImageSky`` (with and without a rotation, its
   image a PNG the test writes, read by each package's own decoder):
   ``color``, ``pdf`` and ``sample`` to rtol 1e-4 / atol 1e-6 (XLA's CPU
   backend fuses multiply-adds; the port does not); the Atmosphere's
   importance map, built in numpy by both, bit for bit.  The Atmosphere's
   radiance (its ``color`` and its samples' ``le``) is the exception: it
   marches through planet-scale coordinates (6.4e6 m) in float32, where an
   ulp is 0.5 m, and the heights above the ground that feed exp(-h / 1200)
   carry that rounding.  Against a float64 evaluation of the same formula
   pine_tpu's float32 values are off by up to 1.28e-3 relative and the
   port's by up to 1.27e-3 (measured); the two differ by up to 1.0e-3.
   So they are held to rtol 2e-3 of each other, and the port to no more
   than 1.1 times pine_tpu's own deviation from the float64 values.
3. ``SpotLight.sample``, to the same tolerance; an emissive rect whose color
   is a node (a Checkerboard of the position): its area light's samples
   and its radiance at hits, each package's.
4. ``Line``: ``intersect_line`` and ``surface_info_line`` against
   pine_tpu/scene/intersect.py's; the "plain" route of a 24-line fence
   group, with the scene's other groups, against pine_tpu's packet walk
   (closest hit and any-hit; the same rows in the same SAH order).
5. ``heightmap(file)`` through both PRL interpreters: the mesh arrays of a
   PNG the test writes.
6. The builtins still to port refuse with their ROADMAP.md item; the ones
   ported since (script lambdas, the random walk) build pine_tpu's values.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.scene import env_lights as JE
from pine_tpu.scene import lights as JL
from pine_tpu_torch.scene import env_lights as PE
from pine_tpu_torch.scene import lights as PL

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
N_LANES = 4096


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(3)
    wo = rng.normal(size=(N_LANES, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    p = (rng.normal(size=(N_LANES, 3)) * 2).astype(np.float32)
    u2 = rng.random((N_LANES, 2)).astype(np.float32)
    return wo, p, u2


def zero_run_density():
    rng = np.random.default_rng(9)
    d = rng.random((24, 40)) ** 3
    d[3] = 0.0  # a row of no density
    d[7, 5:30] = 0.0  # a run of equal CDF entries
    d[:, 0] = 0.0
    d[11:14, 20:] = 0.0
    return d


def test_distribution2d_bit_equal():
    d = zero_run_density()
    jd, pd = JE.Distribution2D(d), PE.Distribution2D.of_density(d)
    for k in ("pdf_img", "cdf_marg", "cdf_cond"):
        np.testing.assert_array_equal(getattr(pd, k), np.asarray(getattr(jd, k)), err_msg=k)
    rng = np.random.default_rng(4)
    u = rng.random((20000, 2)).astype(np.float32)
    # u equal to CDF entries: marginal entries, and entries of every row
    u[:500, 0] = rng.choice(pd.cdf_marg, 500)
    u[500:2000, 1] = rng.choice(pd.cdf_cond.ravel(), 1500)
    u[2000:2100] = 0.0
    sc_j, pdf_j = jd.sample(jnp.asarray(u))
    sc_p, pdf_p = pd.sample(torch.as_tensor(u))
    np.testing.assert_array_equal(sc_p.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(pdf_p.numpy(), np.asarray(pdf_j))
    np.testing.assert_array_equal(pd.pdf(sc_p).numpy(), np.asarray(jd.pdf(sc_j)))


@pytest.fixture(scope="module")
def atmospheres():
    sun, color = [0.4, 0.5, -0.6], [1.0, 0.9, 0.8]
    return JE.Atmosphere(sun, color), PE.Atmosphere(sun, color)


def test_atmosphere_map_bit_equal(atmospheres):
    ja, pa = atmospheres
    assert pa.distr.cdf_cond.shape == (1024, 1024)
    for k in ("pdf_img", "cdf_marg", "cdf_cond"):
        np.testing.assert_array_equal(getattr(pa.distr, k), np.asarray(getattr(ja.distr, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(pa.sun_direction, ja.sun_direction)


def check_env(jl, pl, lanes, radiance_rtol=RTOL):
    wo, p, u2 = lanes
    close(pl.color(torch.as_tensor(wo)), jl.color(jnp.asarray(wo)), rtol=radiance_rtol)
    close(pl.pdf(torch.as_tensor(wo)), jl.pdf(jnp.asarray(wo)))
    sj = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u2[:, 0]), None)
    sp = pl.sample(torch.as_tensor(p), torch.as_tensor(u2), torch.as_tensor(u2[:, 0]))
    for k in ("wo", "distance", "pdf"):
        close(sp[k], sj[k])
    close(sp["le"], sj["le"], rtol=radiance_rtol)
    np.testing.assert_array_equal(sp["valid"].numpy(), np.asarray(sj["valid"]))
    return sp


def test_sky_matches(lanes):
    check_env(JL.Sky([1.0, 0.8, 0.6]), PL.Sky([1.0, 0.8, 0.6]), lanes)


def test_atmosphere_matches(atmospheres, lanes):
    ja, pa = atmospheres
    sp = check_env(ja, pa, lanes, radiance_rtol=2e-3)
    wo = lanes[0]
    sun = pa.sun_direction
    for dirs, real in ((wo, False), (sp["wo"].numpy(), True)):
        truth = PE.atmosphere_color_np(dirs.astype(np.float64), sun, 8, real)
        got = PE.atmosphere_color(torch.as_tensor(dirs), torch.as_tensor(sun), 8, real).numpy()
        want = np.asarray(JE.atmosphere_color(jnp.asarray(dirs), jnp.asarray(sun), 8, real))

        def dev(x):
            return (np.abs(x - truth) / np.maximum(np.abs(truth), 1e-6)).max()

        assert dev(got) <= 1.1 * dev(want), (dev(got), dev(want))


@pytest.mark.parametrize("rotation", [(0.0, 0.0), (0.15, 0.3)])
def test_imagesky_matches(tmp_path, lanes, rotation):
    from PIL import Image

    from pine_tpu.io.image_io import load_image as jload
    from pine_tpu_torch.io.image_io import load_image as pload

    rng = np.random.default_rng(17)
    path = str(tmp_path / "sky.png")
    Image.fromarray(rng.integers(0, 256, (36, 72, 3), dtype=np.uint8)).save(path)
    ji, pi = jload(path), pload(path)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    elevation, turn = rotation
    jl = JE.ImageSky(ji, (1.0, 0.9, 0.7), elevation, turn)
    pl = PE.ImageSky(pi, (1.0, 0.9, 0.7), elevation, turn)
    assert (pl.l2w is None) == (jl.l2w is None)
    check_env(jl, pl, lanes)


def test_spotlight_sample_matches(lanes):
    _, p, u2 = lanes
    args = ([0.2, 2.5, 0.4], [0.1, -1.0, 0.5], [12.0, 11.0, 9.0], 0.35, 0.1)
    jl, pl = JL.SpotLight(*args), PL.SpotLight(*args)
    assert pl.is_delta and (pl.falloff_cos, pl.cutoff_cos) == (jl.falloff_cos, jl.cutoff_cos)
    sj = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u2[:, 0]), None)
    sp = pl.sample(torch.as_tensor(p), torch.as_tensor(u2), torch.as_tensor(u2[:, 0]))
    for k in ("le", "wo", "distance", "pdf"):
        close(sp[k], sj[k])
    valid = sp["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(sj["valid"]))
    assert 0.02 < valid.mean() < 0.98  # lanes in and out of the cone


def test_emissive_node_color_matches(lanes):
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene import nodes as JN
    from pine_tpu.scene import shapes as JS
    from pine_tpu_torch.convert import node_of, param_record
    from pine_tpu_torch.scene import shapes as PS

    _, p, u2 = lanes
    color = JN.Lerp(JN.Checkerboard(JN.Position() * 3.0), JN.Constant([1.0, 2.0, 3.0]),
                    JN.Constant([4.0, 0.5, 0.2]))
    rect = ([0.0, 2.0, 0.0], [2.0, 0.0, 0.0], [0.0, 0.0, 2.0])
    jl = JL.AreaLight(JS.Rect(*rect), JM.Emissive(color), 0)
    images = []
    rec = param_record("color", color, images)
    assert "color.node" in rec
    pl = PL.AreaLight(PS.RECT, torch.as_tensor(PS.Rect(*rect).params()), 0,
                      node_of(json.loads(str(rec["color.node"])), images))
    sj = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u2[:, 0]), None)
    sp = pl.sample(torch.as_tensor(p), torch.as_tensor(u2), torch.as_tensor(u2[:, 0]))
    for k in ("le", "wo", "distance", "pdf"):
        close(sp[k], sj[k])
    np.testing.assert_array_equal(sp["valid"].numpy(), np.asarray(sj["valid"]))
    assert len(np.unique(sp["le"].numpy()[sp["valid"].numpy()], axis=0)) == 2


def fence(mod):
    """The garden's 24 fence lines as shapes of ``mod`` (a shapes module)."""
    out = []
    for i in range(12):
        x = -2.2 + 0.4 * i
        out.append(mod.Line([x, 0, 3.6], [x, 0.8, 3.6], 0.02))
        out.append(mod.Line([x, 0.55, 3.6], [x + 0.4, 0.55, 3.6], 0.02))
    return out


def fence_rays(n, seed):
    """Rays from in front of the fence aimed at points within 0.03 of its
    lines (so some graze them, some pass by)."""
    rng = np.random.default_rng(seed)
    ro = np.stack([rng.uniform(-3, 3, n), rng.uniform(0.1, 2.0, n), rng.uniform(-1, 2, n)],
                  -1).astype(np.float32)
    i = rng.integers(0, 12, n)
    post = rng.random(n) < 0.5
    along = rng.random(n)
    x = -2.2 + 0.4 * i + np.where(post, 0.0, 0.4 * along)
    y = np.where(post, 0.8 * along, 0.55)
    target = np.stack([x, y, np.full(n, 3.6)], -1) + rng.uniform(-0.03, 0.03, (n, 3))
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd.astype(np.float32)


def test_line_queries_match():
    from pine_tpu.scene import intersect as JI
    from pine_tpu.scene import shapes as JS
    from pine_tpu_torch.scene import intersect as PI
    from pine_tpu_torch.scene import shapes as PS

    params = np.stack([s.params() for s in fence(PS)])
    np.testing.assert_array_equal(params, np.stack([s.params() for s in fence(JS)]))
    ro, rd = fence_rays(2000, 1)
    tmin, tmax = np.zeros((2000, 1), np.float32), np.full((2000, 1), 1e30, np.float32)
    tj = np.asarray(JI.intersect_line(jnp.asarray(params), jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(tmin), jnp.asarray(tmax)))
    tp = PI.intersect_line(torch.as_tensor(params), torch.as_tensor(ro), torch.as_tensor(rd),
                           torch.as_tensor(tmin), torch.as_tensor(tmax)).numpy()
    hit_j, hit_p = tj < 1e30, tp < 1e30
    assert hit_j.any(axis=1).mean() > 0.2
    assert (hit_j != hit_p).mean() < 1e-3  # a hit decided at the thickness, in the last ulp
    both = hit_j & hit_p
    close(tp[both], tj[both])
    lane, row = np.nonzero(both)
    p = (ro[lane] + tp[lane, row][:, None] * rd[lane]).astype(np.float32)
    rows = params[row]
    for got, want in zip(PI.surface_info_line(torch.as_tensor(rows), torch.as_tensor(p)),
                         JI.surface_info_line(jnp.asarray(rows), jnp.asarray(p))):
        close(got, want, atol=1e-5)
    u = np.random.default_rng(2).random((len(rows), 2)).astype(np.float32)
    sj = JI.sample_line(jnp.asarray(rows), jnp.asarray(p - 0.3), jnp.asarray(u))
    sp = PI.sample_line(torch.as_tensor(rows), torch.as_tensor(p - 0.3), torch.as_tensor(u))
    for k in ("p", "n", "w", "distance", "pdf"):
        close(sp[k], sj[k], atol=1e-5)


def test_fence_group_plain_route_matches_packet_walk():
    """24 lines and a sphere: pine_tpu's packet walk over its line group (a
    SAH "bvh" group) against the port's plain route over the same rows."""
    from pine_tpu.scene import materials as JM
    from pine_tpu.scene import shapes as JS
    from pine_tpu.scene.scene import Scene as JScene
    from test_torch_render import jax_scene_arrays

    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film

    from pine_tpu_torch.convert import compiled_scene_from_arrays

    js = JScene()
    wood = JM.Diffuse([0.45, 0.3, 0.18])
    for line in fence(JS):
        js.add(line, wood)
    js.add(JS.Sphere([0.0, 0.3, 2.9], 0.3), wood)
    jcs = js.compile()
    assert [(g["tid"], g["kind"]) for g in jcs.unified["groups"]] == [(0, "dense"), (9, "bvh")]
    cam = ThinLenCamera(Film((8, 8)), [0, 1, -2], [0, 0.3, 2], 0.4)
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, cam), "cpu")
    assert [(g["tid"], g["variant"]) for g in pcs.unified["groups"]] == [(0, "dense"),
                                                                          (9, "plain")]
    ro, rd = fence_rays(4096, 2)
    n = ro.shape[0]
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 3e38, np.float32)
    tmax[::7] = 2.0  # windows that end short of the fence
    t_j, g_j, h_j, _ = (np.asarray(x) for x in jcs.intersect(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin), jnp.asarray(tmax)))
    t_p, g_p, h_p, _ = (x.numpy() for x in pcs.intersect(
        torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(tmin), torch.as_tensor(tmax)))
    assert h_j.mean() > 0.2 and (h_j != h_p).mean() < 1e-3
    both = h_j & h_p
    assert (g_j[both] == g_p[both]).mean() > 0.999
    close(t_p[both], t_j[both])
    occ_j = np.asarray(jcs.any_hit(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
                                   jnp.asarray(tmax)))
    occ_p = pcs.any_hit(torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(tmin),
                        torch.as_tensor(tmax)).numpy()
    assert occ_p.mean() > 0.2 and (occ_j != occ_p).mean() < 1e-3


def test_heightmap_file_matches(tmp_path):
    from PIL import Image

    from pine_tpu.prl.interp import Interpreter as JInterp

    from pine_tpu_torch.prl.interp import Interpreter

    rng = np.random.default_rng(6)
    path = str(tmp_path / "height.png")
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)).save(path)
    src = f"m := heightmap({path!r});"
    ji, pi = JInterp(), Interpreter(device="cpu")
    ji.run(src)
    pi.run(src)
    jm, pm = ji.get_var("m"), pi.get_var("m")
    np.testing.assert_array_equal(pm.indices, jm.indices)
    np.testing.assert_allclose(pm.vertices, jm.vertices, rtol=1e-6, atol=1e-7)
    assert pm.vertices.shape == (13 * 9, 3)


@pytest.mark.parametrize("src, item", [
    ("r := SDF(AABB([0, 0, 0], [1, 1, 1]), (p: vec3): f32 { return length(p) - 0.5; });",
     None),
    ("RestirIntegrator(UniformSampler(4), 4);", "item 12"),
    ("GuidedPathIntegrator(UniformSampler(4), 4);", "item 12"),
    ("r := RandomWalkIntegrator(UniformSampler(4), 4);", None),
    ("MltIntegrator(UniformSampler(4), 4);", "item 12"),
    ("r := draw([4, 4], (u: vec2): vec3 { return [u.x, u.y, 0.5]; });", None),
    ("m := Diffuse(Function((c: NodeEvalCtx): vec3 { return c.p; })); r := m.albedo;", None),
    ("r := heightmap([8, 8], (p: vec2): f32 { return p.x; });", None),
])
def test_unported_builtins_name_their_item(src, item):
    """The builtins still to port refuse naming their item; those this
    slice's item 15 and item 12's random walk ported (item None) build what
    pine_tpu's build from the same line."""
    from test_torch_lambdas import lines_agree

    from pine_tpu_torch.prl.interp import Interpreter

    if item is None:
        lines_agree(src)
        return
    with pytest.raises(NotImplementedError, match=item):
        Interpreter(device="cpu").run(src)
