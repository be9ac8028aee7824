"""The AO and volume integrators, and the slice's PRL builtins, against
pine_tpu.

1. ``AOIntegrator`` on the reduced benchmark box (bench.py's script with
   the cone loops cut to 36 cones: rect, OBB and cone groups, the dense
   sweep) at 24x24, BlueSampler(2): pine_tpu's compiled scene carried
   across by convert (``render_ao``), and the port's own PRL interpreter
   running ``AOIntegrator(...).render(scene)``, each against pine_tpu's
   jitted ``AOIntegrator``.  Held to test_torch_render's rule.  Measured:
   100 % of pixels, both.
2. ``VolIntegrator``'s closed-form single scatter at 24x24 against pine_tpu's
   to rtol 1e-4 (atol 1e-6) on every pixel (its E1 approximation takes
   powers and logarithms that differ by an ulp between XLA and PyTorch).
3. The PRL builtins of the slice build the port's objects and render: a
   script with ``HgPF``, ``Hg2PF``, ``CloudPF``, ``HomoMedium`` over a CSG
   shape, and a ``VDBMedium`` over an ``.nvdb`` written at run time (its
   flames and temperature grids too), rendered by the path integrator on
   the CPU: finite, lit, and each builtin's object that of pine_tpu's
   interpreter (the same class and parameters).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_render import REDUCED, assert_renders_agree, jax_scene_arrays

torch.set_num_threads(2)

SIZE, SPP = 24, 2


def reduced_box_src():
    from pine_tpu_torch import scenes

    (x0, dx, x1), (z0, dz, z1) = REDUCED
    return (scenes.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}")
            .replace("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}")
            .replace("image_size := [640, 640];", f"image_size := [{SIZE}, {SIZE}];"))


@pytest.fixture(scope="module")
def ao_want():
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.ao import AOIntegrator as JAO
    from pine_tpu.prl.interp import Interpreter as JInterp

    itp = JInterp()
    itp.run(reduced_box_src(), "<reduced cbox>")
    scene = itp.get_var("scene")
    film = JAO(JBlue(SPP)).render(scene)
    return scene, np.asarray(film.pixels)[..., :3]


def test_ao_on_the_reduced_box_matches_pine_tpu(ao_want):
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.ao import render_ao

    scene, want = ao_want
    jcs = scene.compile()
    assert [g["kind"] for g in jcs.unified["groups"]] == ["dense", "dense", "bvh"]
    pcs = compiled_scene_from_arrays(jax_scene_arrays(jcs, scene.camera), "cpu")
    lo, up = scene.get_aabb()
    got = render_ao(pcs, None, SIZE, SIZE, BlueSampler(SPP), SPP,
                    float(np.linalg.norm(up - lo) / 2)).numpy()
    assert 0.05 < got.mean() < 0.95
    assert_renders_agree(got, want)


def test_ao_through_the_port_interpreter(ao_want):
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device="cpu")
    itp.run(reduced_box_src() + "AOIntegrator(BlueSampler(2)).render(scene);", "<reduced cbox>")
    got = itp.get_var("scene").camera.film.pixels[..., :3]
    assert_renders_agree(np.asarray(got), ao_want[1])


def test_vol_integrator_matches_pine_tpu():
    from pine_tpu.core.camera import ThinLenCamera as JCam
    from pine_tpu.core.film import Film as JFilm
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.integrators.vol import VolIntegrator as JVol
    from pine_tpu.scene.scene import Scene as JScene

    from pine_tpu_torch.core.camera import ThinLenCamera
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.vol import VolIntegrator
    from pine_tpu_torch.scene.scene import Scene

    want, got = JScene(), Scene()
    want.set(JCam(JFilm([SIZE, SIZE]), [0, 1, -2], [0, 1, 4], 0.6))
    got.set(ThinLenCamera(Film([SIZE, SIZE]), [0, 1, -2], [0, 1, 4], 0.6))
    w = np.asarray(JVol(JUniform(1)).render(want).pixels)[..., :3]
    g = VolIntegrator(UniformSampler(1)).render(got, device="cpu").pixels[..., :3]
    assert w.max() > 0.01
    np.testing.assert_allclose(np.asarray(g), w, rtol=1e-4, atol=1e-6)


MEDIA_SRC = """
scene := Scene();
scene.add("white", Diffuse([0.8, 0.8, 0.8]));
scene.add(Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "white");
scene.add(Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "white");
scene.add(Rect([0, 1.9, 1], [0.5, 0, 0], [0, 0, 0.5]), Emissive([20, 20, 20]));
hg := HgPF(0.3); hg2 := Hg2PF(0.6, -0.3, 0.2); cloud := CloudPF(0.65);
scene.add(HomoMedium(AABB([-1, 0, 0], [1, 2, 2]) - Sphere([0, 1, 1], 0.4), hg2, [0.05, 0.05, 0.05], [0.3, 0.3, 0.3]));
scene.add(VDBMedium(FILE, translate([-0.5, 0.3, 0.5]) * scale([1, 1, 1]), cloud, [1, 2, 3], [8, 6, 4], 2.0, 0.9));
scene.set(ThinLenCamera(Film([16, 16]), [0, 1, -3], [0, 1, 1], 0.4));
"""


def test_media_builtins_build_and_render(tmp_path):
    from pine_tpu.prl.interp import Interpreter as JInterp

    from pine_tpu_torch import scenes
    from pine_tpu_torch.io.nvdb import write_nvdb_multi
    from pine_tpu_torch.prl.interp import Interpreter

    dens, flame, temp = scenes.make_explosion(16)
    path = str(tmp_path / "fire.nvdb")
    write_nvdb_multi(path, {"density": dens, "flames": flame, "temperature": temp})
    src = MEDIA_SRC.replace("FILE", repr(path))
    ji, pi = JInterp(), Interpreter(device="cpu")
    ji.run(src)
    pi.run(src + "PathIntegrator(BlueSampler(2), 3).render(scene);"
           f"scene.camera.film().save({str(tmp_path / 'media.png')!r});")
    for name in ("hg", "hg2", "cloud"):
        j, p = ji.get_var(name), pi.get_var(name)
        assert type(p).__name__ == type(j).__name__
        assert {k: v for k, v in vars(p).items() if not hasattr(v, "p")} == {
            k: v for k, v in vars(j).items() if not hasattr(v, "p")}
    (jh, jv), (ph, pv) = ji.get_var("scene").mediums, pi.get_var("scene").mediums
    for k in ("sigma_a", "sigma_s"):
        np.testing.assert_array_equal(getattr(ph, k), getattr(jh, k))
        np.testing.assert_array_equal(getattr(pv, k), getattr(jv, k))
    for k in ("density", "flame", "temperature", "m"):
        np.testing.assert_array_equal(getattr(pv, k), np.asarray(getattr(jv, k)))
    assert pv.emissive and (pv.blackbody_intensity, pv.temperature_scale) == (2.0, 0.9)
    img = pi.get_var("scene").camera.film.pixels[..., :3]
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert (tmp_path / "media.png").exists()
