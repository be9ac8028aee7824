"""Progressive and interactive rendering, the terminal preview and the
coherence sort's octahedral bins: pine_tpu_torch against pine_tpu.

1. ``--progressive`` (PathIntegrator.render with options.progressive_every):
   tests/test_render.py's 12x12 scene, UniformSampler(8), depth 2, every 2,
   through both packages: four snapshots each, latest.png and the viewer
   page, each snapshot's film against pine_tpu's to rtol/atol 1e-4 (the
   tolerance of tests/test_render.py's progressive test), and the port's
   final film against its own one-shot render to rtol/atol 1e-4.
2. io/term_preview: ``ansi_frame`` and ``_box_downsample`` equal to
   pine_tpu's on seeded images of odd sizes, byte for byte; ``preview_enabled``
   under PINE_TERM_PREVIEW.
3. ``FlyCam``: one key string through both packages, the camera's position,
   yaw, pitch and c2w to 1e-6; the moved camera's params are rebuilt from it.
4. A scripted ``run_loop`` session on the CPU (PINE_INTERACTIVE_KEYS="wj]pq"):
   four frames, the screenshot, latest.png; the last frame against
   pine_tpu's render_wavefront at the moved camera by the render rule (97 %
   of pixels to 1e-3 relative or 1e-4 absolute, means to 1 %).
5. ``_ray_sort_perm`` at dirbits 6 and 8 against pine_tpu's under
   PINE_SORT_DIRBITS on seeded rays: keys and permutations bit for bit
   (torch.argsort(stable=True) against jnp.argsort), and
   ``CompiledScene.sort_dirbits`` reaching it.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import assert_renders_agree

torch.set_num_threads(2)

SNAPS = ["snap_00002spp.png", "snap_00004spp.png", "snap_00006spp.png", "snap_00008spp.png"]


def small_scene(pkg, size=12):
    """tests/test_render.py's progressive scene in package ``pkg``."""
    if pkg == "jax":
        from pine_tpu.core.camera import ThinLenCamera
        from pine_tpu.core.film import Film
        from pine_tpu.scene import materials as M, shapes as S
        from pine_tpu.scene.scene import Scene
    else:
        from pine_tpu_torch.core.camera import ThinLenCamera
        from pine_tpu_torch.core.film import Film
        from pine_tpu_torch.scene import materials as M, shapes as S
        from pine_tpu_torch.scene.scene import Scene
    sc = Scene()
    sc.add(S.Rect([0, 2, 0], [1, 0, 0], [0, 0, 1]), M.Emissive([10, 10, 10]))
    sc.add(S.Sphere([0, 0, 0], 0.5), M.Diffuse([0.7, 0.6, 0.5]))
    sc.add(S.Plane([0, -0.5, 0], [0, 1, 0]), M.Diffuse([0.8, 0.8, 0.8]))
    sc.set(ThinLenCamera(Film([size, size]), [0, 0.6, -2.5], [0, 0, 0], 0.5))
    return sc


def recorded_films(monkeypatch, film_cls):
    """Every frame set on a film of ``film_cls`` from now on, as numpy."""
    films = []
    real = film_cls.set_rgb

    def set_rgb(self, rgb):
        films.append(np.array(rgb, np.float32))
        return real(self, rgb)

    monkeypatch.setattr(film_cls, "set_rgb", set_rgb)
    return films


def test_progressive_snapshots_match_pine_tpu(tmp_path, monkeypatch):
    from pine_tpu.core import options as joptions
    from pine_tpu.core.film import Film as JFilm, flush_deferred_saves
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.integrators.path import _VIEWER_HTML, PathIntegrator as JPath
    from pine_tpu_torch.core import options
    from pine_tpu_torch.core.film import Film
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import VIEWER_HTML, PathIntegrator

    one_shot = PathIntegrator(UniformSampler(8), 2).render(small_scene("torch"), device="cpu")
    one_shot = one_shot.rgb.numpy().copy()

    jfilms = recorded_films(monkeypatch, JFilm)
    films = recorded_films(monkeypatch, Film)
    for opts, pkg in ((joptions, "jax"), (options, "torch")):
        monkeypatch.setattr(opts, "progressive_every", 2)
        monkeypatch.setattr(opts, "progressive_dir", str(tmp_path / pkg))
    monkeypatch.setenv("PINE_TERM_PREVIEW", "0")
    JPath(JUniform(8), 2).render(small_scene("jax"))
    flush_deferred_saves()
    PathIntegrator(UniformSampler(8), 2).render(small_scene("torch"), device="cpu")

    for pkg in ("jax", "torch"):
        files = sorted(os.listdir(tmp_path / pkg))
        assert files == ["index.html", "latest.png"] + SNAPS, files
    assert (tmp_path / "torch" / "index.html").read_text() == _VIEWER_HTML == VIEWER_HTML
    assert len(films) == len(jfilms) == 4
    for got, want in zip(films, jfilms):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(films[-1], one_shot, rtol=1e-4, atol=1e-4)
    # the last snapshot's PNG is the final film's
    from pine_tpu_torch.io.image_io import load_image

    assert np.array_equal(load_image(str(tmp_path / "torch" / SNAPS[-1])),
                          load_image(str(tmp_path / "torch" / "latest.png")))


@pytest.mark.parametrize("shape", [(7, 13), (33, 101), (61, 45), (2, 3), (150, 97)])
def test_term_preview_matches_pine_tpu(shape):
    from pine_tpu.io import term_preview as J
    from pine_tpu_torch.io import term_preview as P

    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(-0.1, 1.2, (*shape, 3)).astype(np.float32)
    for cols, lines in ((80, 24), (17, 5), (200, 100)):
        assert P.ansi_frame(img, cols, lines).encode() == J.ansi_frame(img, cols, lines).encode()
    src = np.clip(img, 0.0, 1.0)
    for out_h, out_w in ((2, 2), shape, (max(1, shape[0] // 3), min(5, shape[1]))):
        got, want = P._box_downsample(src, out_h, out_w), J._box_downsample(src, out_h, out_w)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_preview_enabled_matches_pine_tpu(monkeypatch):
    from pine_tpu.io import term_preview as J
    from pine_tpu_torch.io import term_preview as P

    monkeypatch.delenv("PINE_TERM_PREVIEW", raising=False)
    for live in (False, True):  # pytest's stdout is no tty
        assert P.preview_enabled(live) is J.preview_enabled(live) is False
    for env, want in (("1", True), ("0", False), ("", False), ("off", False), ("yes", True)):
        monkeypatch.setenv("PINE_TERM_PREVIEW", env)
        assert P.preview_enabled(False) is J.preview_enabled(False) is want


KEYS = "wwasdecjjlikk" + "i" * 30 + "dqx"


def test_flycam_matches_pine_tpu():
    from pine_tpu.interactive import FlyCam as JFly
    from pine_tpu_torch.interactive import FlyCam

    jcam, cam = small_scene("jax").camera, small_scene("torch").camera
    jfly, fly = JFly(jcam), FlyCam(cam)
    for ch in KEYS:
        assert fly.apply_key(ch) == jfly.apply_key(ch)
        fly.write_back()
        jfly.write_back()
        np.testing.assert_allclose(fly.pos, jfly.pos, rtol=0, atol=1e-6)
        assert abs(fly.yaw - jfly.yaw) <= 1e-6 and abs(fly.pitch - jfly.pitch) <= 1e-6
        np.testing.assert_allclose(cam.c2w, np.asarray(jcam.c2w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(cam.position, np.asarray(jcam.position), rtol=0, atol=1e-6)
    assert fly.pitch == 1.5  # clamped
    # a render reads the moved camera: params are rebuilt from position and c2w
    cp = cam.params(torch.device("cpu"))
    assert np.array_equal(cp["position"].numpy(), cam.position)
    assert np.array_equal(cp["rot"].numpy(), cam.c2w[:3, :3])


def test_run_loop_scripted_session(tmp_path, monkeypatch):
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.integrators.path import render_wavefront as jrender
    from pine_tpu.interactive import FlyCam as JFly
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import PathIntegrator
    from pine_tpu_torch.interactive import run_loop

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PINE_INTERACTIVE_KEYS", "wj]pq")
    monkeypatch.setenv("PINE_TERM_PREVIEW", "0")
    size, depth = 16, 2
    sc = small_scene("torch", size)
    cs = sc.compile("cpu")
    frames = run_loop(PathIntegrator(UniformSampler(8), depth), sc, cs)
    assert frames == 4  # the first, w, j and ]
    assert sorted(os.listdir("interactive")) == ["index.html", "latest.png", "shot_001.png"]

    jsc = small_scene("jax", size)
    jfly = JFly(jsc.camera)
    for ch in "wj":
        jfly.apply_key(ch)
        jfly.write_back()
    np.testing.assert_allclose(sc.camera.c2w, np.asarray(jsc.camera.c2w), rtol=0, atol=1e-6)
    want = np.asarray(jrender(jsc.compile(), jsc.camera, size, size, JUniform(2), 2, depth))
    assert_renders_agree(sc.camera.film.rgb.numpy(), want)


def seeded_rays(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:64] = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [0, -1, 0]] * 16  # the fold's edges
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.2, -1.0, 1e30).astype(np.float32)
    return ro, rd, tmin, tmax


@pytest.mark.parametrize("dirbits", [6, 8])
def test_octahedral_sort_bins_match_pine_tpu(dirbits, monkeypatch):
    import pine_tpu.scene.scene as jscene
    from pine_tpu_torch.scene import scene as pscene

    ro, rd, tmin, tmax = seeded_rays()
    lo, span = np.float32([-2.0, -2.0, -2.0]), 5.0
    keys = {}

    class RecordingJnp:  # jnp with its argsort recording the key
        def __getattr__(self, name):
            return getattr(jnp, name)

        def argsort(self, key):
            keys["jax"] = np.asarray(key)
            return jnp.argsort(key)

    real_argsort = torch.argsort

    def argsort(key, **kw):
        keys["torch"] = key.numpy().copy()
        return real_argsort(key, **kw)

    monkeypatch.setenv("PINE_SORT_DIRBITS", str(dirbits))
    monkeypatch.setattr(jscene, "jnp", RecordingJnp())
    jperm, jinv = jscene._ray_sort_perm(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin),
                                        jnp.asarray(tmax), jnp.asarray(lo), span)
    monkeypatch.setattr(torch, "argsort", argsort)
    perm, inv = pscene._ray_sort_perm(*map(torch.from_numpy, (ro, rd, tmin, tmax)),
                                      torch.from_numpy(lo), span, dirbits=dirbits)
    assert keys["torch"].dtype == np.int32 and np.array_equal(keys["torch"], keys["jax"])
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert np.array_equal(inv.numpy(), np.asarray(jinv))
    assert len(np.unique(keys["torch"] >> 15)) > 2 ** (dirbits // 2 * 2 - 1)  # finer than octants

    # CompiledScene.sort_dirbits reaches the key where the sort runs
    cs = small_scene("torch").compile("cpu")
    monkeypatch.setattr(cs, "sort_mode", lambda n, on_card: "octant")
    cs.world_lo, cs.world_span, cs.sort_dirbits = torch.from_numpy(lo), span, dirbits
    got = cs.sort_perm(torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tmax < 0))
    assert torch.equal(got[0], perm)
