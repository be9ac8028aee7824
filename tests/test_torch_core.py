"""pine_tpu_torch core math against pine_tpu, element by element.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
hash, the ULP ray offset and the samplers must be bit-equal; the float
helpers agree to float32 rounding (rtol 1e-5, atol 1e-6: the two packages
may order a sum or a fused op differently).
"""
from __future__ import annotations

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.core import camera as JC
from pine_tpu.core import color as Jcolor
from pine_tpu.core import film as JF
from pine_tpu.core import ray as Jray
from pine_tpu.core import rng as Jrng
from pine_tpu.core import samplers as JS
from pine_tpu.core import sampling as Jsampling
from pine_tpu.core import scattering as Jsc
from pine_tpu.core import vecmath as JV
from pine_tpu_torch.core import camera as PC
from pine_tpu_torch.core import color as Pcolor
from pine_tpu_torch.core import film as PF
from pine_tpu_torch.core import ray as Pray
from pine_tpu_torch.core import rng as Prng
from pine_tpu_torch.core import samplers as PS
from pine_tpu_torch.core import sampling as Psampling
from pine_tpu_torch.core import scattering as Psc
from pine_tpu_torch.core import vecmath as PV

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def test_vecmath_matches():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 512, 3)).astype(np.float32)
    n = _unit(rng, 512)
    ja, ta = _both(a)
    jb, tb = _both(b)
    jn, tn = _both(n)
    _close(PV.dot(ta, tb), JV.dot(ja, jb))
    _close(PV.normalize(ta), JV.normalize(ja))
    _close(PV.cross(ta, tb), JV.cross(ja, jb))
    _close(PV.face_forward(ta, tn), JV.face_forward(ja, jn))
    for got, want in zip(PV.coordinate_system(tn), JV.coordinate_system(jn)):
        _close(got, want)
    _close(PV.to_local(tn, ta), JV.to_local(jn, ja))
    _close(PV.to_world(tn, ta), JV.to_world(jn, ja))
    _close(PV.cartesian_to_spherical(tn), JV.cartesian_to_spherical(jn))
    for f in ("look_at",):
        np.testing.assert_array_equal(getattr(PV, f)([0, 1, -4], [0, 1, 0]),
                                      getattr(JV, f)([0, 1, -4], [0, 1, 0]))
    for f, arg in (("translate", [0.1, -2, 3]), ("scale", [0.6, 1.3, 0.6]),
                   ("rotate_x", 0.3), ("rotate_y", -0.4), ("rotate_z", 1.1)):
        np.testing.assert_array_equal(getattr(PV, f)(arg), getattr(JV, f)(arg))


def test_offset_ray_origin_bit_equal():
    rng = np.random.default_rng(2)
    p = rng.normal(size=(4096, 3)).astype(np.float32) * np.float32(3.0)
    p[:512] *= np.float32(1e-3)  # the near-origin branch
    p[512:520] = 0.0
    n = _unit(rng, 4096)
    jp, tp = _both(p)
    jn, tn = _both(n)
    got = Pray.offset_ray_origin(tp, tn).numpy()
    want = np.asarray(Jray.offset_ray_origin(jp, jn))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_rng_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    y = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    jx, jy = jnp.asarray(x.astype(np.uint32)), jnp.asarray(y.astype(np.uint32))
    tx, ty = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64))
    np.testing.assert_array_equal(
        Prng.pcg_hash(tx).numpy(), np.asarray(Jrng.pcg_hash(jx)).astype(np.int64)
    )
    np.testing.assert_array_equal(
        Prng.hash_combine(tx, ty, 7, 2**32 - 5).numpy(),
        np.asarray(Jrng.hash_combine(jx, jy, jnp.uint32(7), jnp.uint32(2**32 - 5))).astype(np.int64),
    )
    got = Prng.uniform(tx, ty, 3, 11).numpy()
    want = np.asarray(Jrng.uniform(jx, jy, jnp.uint32(3), jnp.uint32(11)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sampling_matches():
    rng = np.random.default_rng(4)
    u = rng.uniform(size=(2048, 2)).astype(np.float32)
    u[0] = 0.5  # the concentric map's origin
    ju, tu = _both(u)
    for f in ("sample_disk_polar", "sample_disk_concentric", "cosine_weighted_hemisphere",
              "uniform_hemisphere"):
        _close(getattr(Psampling, f)(tu), getattr(Jsampling, f)(ju))
    a, b = rng.uniform(0, 4, (2, 256)).astype(np.float32)
    _close(Psampling.balance_heuristic(torch.from_numpy(a), torch.from_numpy(b)),
           Jsampling.balance_heuristic(jnp.asarray(a), jnp.asarray(b)))


def test_scattering_matches():
    rng = np.random.default_rng(5)
    n = 2048
    wi, wm = _unit(rng, n), _unit(rng, n)
    wm[:, 2] = np.abs(wm[:, 2])
    eta = rng.uniform(1.1, 2.0, n).astype(np.float32)
    alpha = rng.uniform(0.01, 1.0, n).astype(np.float32)
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    f0 = rng.uniform(size=(n, 3)).astype(np.float32)
    (jwi, twi), (jwm, twm) = _both(wi), _both(wm)
    (je, te), (ja, ta), (ju, tu), (jf, tf) = _both(eta), _both(alpha), _both(u), _both(f0)
    _close(Psc.reflect(twi, twm), Jsc.reflect(jwi, jwm))
    for got, want in zip(Psc.refract(twi, twm, te), Jsc.refract(jwi, jwm, je)):
        _close(got, want)
    _close(Psc.fr_dielectric(twi[:, 2], te), Jsc.fr_dielectric(jwi[:, 2], je))
    _close(Psc.fr_schlick(tf, twi[:, 2].abs()), Jsc.fr_schlick(jf, jnp.abs(jwi[:, 2])),
           rtol=1e-5, atol=1e-5)
    _close(Psc.ggx_d(ta, twm), Jsc.ggx_d(ja, jwm), rtol=1e-4)
    _close(Psc.ggx_g(ta, twi, twm), Jsc.ggx_g(ja, jwi, jwm))
    _close(Psc.ggx_pdf(ta, twi, twm), Jsc.ggx_pdf(ja, jwi, jwm), rtol=1e-4)
    _close(Psc.ggx_sample_wm(ta, twi, tu), Jsc.ggx_sample_wm(ja, jwi, ju), atol=1e-5)


def test_uncharted2_matches():
    x = np.random.default_rng(6).uniform(0, 50, (64, 64, 3)).astype(np.float32)
    _close(Pcolor.uncharted2_filmic(torch.from_numpy(x)), Jcolor.uncharted2_filmic(jnp.asarray(x)))


@pytest.mark.parametrize("len_radius", [0.0, 0.05])
def test_gen_rays_match(len_radius):
    rng = np.random.default_rng(7)
    jcam = JC.ThinLenCamera(JF.Film([48, 32]), [0, 1, -4], [0.2, 1, 0], 0.25, len_radius, 3.0)
    pcam = PC.ThinLenCamera(PF.Film([48, 32]), [0, 1, -4], [0.2, 1, 0], 0.25, len_radius, 3.0)
    p_film = rng.uniform(size=(1024, 2)).astype(np.float32)
    u_lens = rng.uniform(size=(1024, 2)).astype(np.float32)
    jo, jd = JC.gen_rays(jcam.params(), jnp.asarray(p_film), jnp.asarray(u_lens))
    to, td = PC.gen_rays(pcam.params("cpu"), torch.from_numpy(p_film), torch.from_numpy(u_lens))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("name", ["uniform", "blue"])
def test_samplers_bit_equal(name):
    """Every dim the path schedule reads at depth 4 (0 .. 4 + 16*4), over a
    grid of pixels and sample indices."""
    spp, depth = 16, 4
    js = {"uniform": JS.UniformSampler, "blue": JS.BlueSampler}[name](spp)
    ps = {"uniform": PS.UniformSampler, "blue": PS.BlueSampler}[name](spp)
    xs, ys = np.meshgrid(np.arange(0, 640, 37, dtype=np.int32),
                         np.arange(0, 640, 41, dtype=np.int32))
    xs, ys = xs.ravel(), ys.ravel()
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    for si in (0, 5, 15):
        for dim in range(0, 4 + 16 * depth + 1):
            got = ps.u1(tx, ty, si, dim).numpy()
            want = np.asarray(js.u1(jx, jy, si, dim))
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                          err_msg=f"{name} dim={dim} si={si}")
        np.testing.assert_array_equal(ps.u2(tx, ty, si, 8).numpy(),
                                      np.asarray(js.u2(jx, jy, si, 8)))


def test_bluesobol_assets_byte_identical():
    names = sorted(f for f in os.listdir(os.path.join(REPO, "pine_tpu", "assets"))
                   if f.startswith("bluesobol_"))
    assert len(names) == 9
    for f in names:
        assert filecmp.cmp(os.path.join(REPO, "pine_tpu", "assets", f),
                           os.path.join(REPO, "pine_tpu_torch", "assets", f), shallow=False), f


def test_sobol_matrices_byte_identical():
    """The SobolSampler's direction numbers: the port's copy of pine_tpu's table."""
    assert filecmp.cmp(os.path.join(REPO, "pine_tpu", "assets", "sobol_matrices.npy"),
                       os.path.join(REPO, "pine_tpu_torch", "assets", "sobol_matrices.npy"),
                       shallow=False)


def test_png_matches_reference_writer(tmp_path):
    """The port's own PNG writer stores the same 8-bit pixels as pine_tpu's."""
    from PIL import Image

    from pine_tpu.io.image_io import save_image as jsave
    from pine_tpu_torch.io.image_io import save_image as psave

    rgb = np.random.default_rng(8).uniform(-0.1, 1.2, (20, 30, 3)).astype(np.float32)
    jsave(str(tmp_path / "j.png"), rgb)
    psave(str(tmp_path / "p.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
