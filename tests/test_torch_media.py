"""Participating media against pine_tpu: the blackbody table, the .nvdb
files, phase functions, grid lookups and the tracking.

1. ``core/blackbody.py``'s colour table equals pine_tpu's bit for bit, and
   ``blackbody_rgb`` its lookup to rtol 1e-5; ``core/sparse_array.py``
   behaves as pine_tpu's.
2. ``io/nvdb.py``: files written by the two packages from the same arrays
   (``write_nvdb_dense``, ``write_nvdb_multi``) are byte-identical, and
   each package reads the other's to the same arrays and grid names.
3. The phase functions' ``p`` and ``sample`` (HG with g = 0, 0.3, -0.6,
   two-lobe HG, CloudPF), and a grid medium's ``density_at``,
   ``emission_at`` (flame and temperature grids) and ``bounds_interval``, to
   rtol 1e-5 (atol 1e-6), but the sampled directions (atol 1e-4) and their
   pdf (rtol 1e-4): near the lobe's axis cos_t comes from a cancelling
   1 + g^2 - sqr_term^2 and sin_t = sqrt(1 - cos_t^2) amplifies its last
   ulp, up to 2.4e-5 of a component and 1.5e-5 of the pdf (1-2 lanes of
   4,096).
4. The tracking on a 16^3 cloud grid under a non-axis-aligned transform,
   4,096 lanes: ``grid_transmittance`` and ``grid_sample_scatter`` (an
   emissive medium) per lane to rtol 1e-4 (atol 1e-5), the scatter and
   absorption masks equal.  A lane may differ where a collision's t lies
   within a few ulps of a voxel face or of t_hi (XLA's ``log`` is not
   libm's); held to 99 % of lanes, measured 100 % (4,096 of 4,096, both).
   The loops' compaction to the walking lanes and their early end
   (media_track.EXIT_CHECK) are exact: the outputs equal those of all
   TRACK_STEPS steps on every lane bit for bit.
5. ``CompiledScene.transmittance`` of a scene with a homogeneous medium in a
   CSG shape and a grid medium, against pine_tpu's, to rtol 1e-4.
6. The compile cache: adding a medium or a CSG tree drops the scene's
   compiled state, and a second scene never gets the first one's.
7. No module of pine_tpu_torch, nor chip_smoke.py, imports jax or pine_tpu.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_blackbody_table_is_pine_tpus():
    from pine_tpu.core import blackbody as JB

    from pine_tpu_torch.core import blackbody as PB

    for k in ("_RGBS", "_TS"):
        a, b = getattr(PB, k), getattr(JB, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (PB._N, PB._T_MIN, PB._T_MAX) == (JB._N, JB._T_MIN, JB._T_MAX)
    t = np.random.default_rng(0).uniform(500, 11000, 1000).astype(np.float32)
    np.testing.assert_allclose(PB.blackbody_rgb(torch.from_numpy(t)).numpy(),
                               np.asarray(JB.blackbody_rgb(jnp.asarray(t))), rtol=1e-5, atol=1e-7)


def test_sparse_array_behaves_as_pine_tpus():
    from pine_tpu.core.sparse_array import SparseArray3d as J

    from pine_tpu_torch.core.sparse_array import SparseArray3d as P

    out = []
    for cls in (J, P):
        a = cls(default=-1.0)
        a[(1, 2, 3)] = 5.0
        a[np.array([1.7, 2.2, 3.9])] = 6.0  # cells are the integer parts
        a[(-4, 0, 2)] = 1.5
        out.append((a[(1, 2, 3)], a[(0, 0, 0)], (1, 2, 3) in a, (9, 9, 9) in a, len(a),
                    sorted(a.items())))
        a.clear()
        out.append(len(a))
    assert out[:2] == out[2:] and out[0][:5] == (6.0, -1.0, True, False, 2)


def grids(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"density": rng.uniform(0, 1, (n, n, n)).astype(np.float32),
            "flames": rng.uniform(0, 1, (n // 2, n, n)).astype(np.float32),
            "temperature": rng.uniform(0, 1.5, (n, n, n)).astype(np.float32)}


def test_nvdb_files_are_byte_identical_and_cross_read(tmp_path):
    from pine_tpu.io import nvdb as JN

    from pine_tpu_torch.io import nvdb as PN

    g = grids()
    for mod, tag in ((JN, "j"), (PN, "p")):
        mod.write_nvdb_dense(tmp_path / f"dense_{tag}.nvdb", g["density"])
        mod.write_nvdb_multi(tmp_path / f"multi_{tag}.nvdb", g)
    for name in ("dense", "multi"):
        written = [(tmp_path / f"{name}_{tag}.nvdb").read_bytes() for tag in "jp"]
        assert written[0] == written[1]
    for reader, tag in ((PN, "j"), (JN, "p")):  # each package reads the other's files
        dense, bbox = reader.read_nvdb_density(str(tmp_path / f"dense_{tag}.nvdb"))
        np.testing.assert_array_equal(dense, g["density"])
        np.testing.assert_array_equal(bbox, [[0, 0, 0], [16, 16, 16]])
        path = str(tmp_path / f"multi_{tag}.nvdb")
        assert reader.list_nvdb_grids(path) == list(g)
        for k, v in g.items():
            np.testing.assert_array_equal(reader.read_nvdb_density(path, k)[0], v)
    with pytest.raises(ValueError, match="no grid named"):
        PN.read_nvdb_density(str(tmp_path / "multi_j.nvdb"), "velocity")


PHASES = [("HgPhaseFunction", (0.0,)), ("HgPhaseFunction", (0.3,)), ("HgPhaseFunction", (-0.6,)),
          ("TwoLobeHgPhaseFunction", (0.7, -0.3, 0.25)), ("CloudPhaseFunction", (0.65,))]


@pytest.mark.parametrize("name, args", PHASES, ids=[f"{n}{a}" for n, a in PHASES])
def test_phase_functions_match(name, args):
    from pine_tpu.scene import media as JM

    from pine_tpu_torch.scene import media as PM

    rng = np.random.default_rng(3)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    jp, pp = getattr(JM, name)(*args), getattr(PM, name)(*args)
    np.testing.assert_allclose(pp.p(torch.from_numpy(cos)).numpy(),
                               np.asarray(jp.p(jnp.asarray(cos))), rtol=1e-5, atol=1e-6)
    # a sampled direction near the lobe's axis takes cos_t from a cancelling
    # 1 + g^2 - sqr_term^2 and sin_t = sqrt(1 - cos_t^2): an ulp there is up to
    # 2.4e-5 of a component (measured): atol 1e-4 for the directions, and rtol
    # 1e-4 for their pdf, the phase function at their cosine (1.5e-5 measured)
    for got, want, tol in zip(pp.sample(torch.from_numpy(wi), torch.from_numpy(u)),
                              jp.sample(jnp.asarray(wi), jnp.asarray(u)),
                              (dict(rtol=1e-5, atol=1e-4), dict(rtol=1e-4, atol=1e-6))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def transform():
    a = 0.4
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                 @ np.diag([1.7, 0.9, 1.3])).astype(np.float32)
    m[:3, 3] = [-0.85, 0.95, 0.45]
    return m


def media_pair(emissive=False):
    """(pine_tpu's grid medium, the port's) over a 16^3 cloud, from the same
    arguments; emissive: with flame and temperature grids."""
    from pine_tpu.scene import media as JM

    from pine_tpu_torch import scenes
    from pine_tpu_torch.scene import media as PM

    dens = scenes.make_cloud(16)
    kw = {}
    if emissive:
        g = grids(16, 1)
        kw = dict(flame=g["density"], temperature=g["temperature"], blackbody_intensity=3.0,
                  temperature_scale=0.9)
    return tuple(M.GridMedium(dens, transform(), M.CloudPhaseFunction(0.65), [1.2, 2.2, 4.0],
                              [38.0, 30.0, 22.0], **kw) for M in (JM, PM))


def medium_rays(seed=4):
    rng = np.random.default_rng(seed)
    m = transform()
    ro = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + np.float32([0, 1, -1])
    ro[: N // 8] = (rng.uniform(0.1, 0.9, (N // 8, 3)) @ m[:3, :3].T + m[:3, 3])  # inside
    aim = rng.uniform(0, 1, (N, 3)) @ m[:3, :3].T + m[:3, 3]
    rd = (aim - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(np.arange(N) % 4 == 0, 1.5, 1e30).astype(np.float32)
    return ro, rd.astype(np.float32), tmax


def test_grid_lookups_match():
    jm, pm = media_pair(emissive=True)
    ro, rd, _ = medium_rays()
    p = (ro + rd * np.random.default_rng(5).uniform(0, 3, (N, 1))).astype(np.float32)
    for name in ("density_at", "emission_at"):
        got = getattr(pm, name)(torch.from_numpy(p)).numpy()
        want = np.asarray(getattr(jm, name)(jnp.asarray(p)))
        assert (want > 0).any()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    for got, want in zip(pm.bounds_interval(torch.from_numpy(ro), torch.from_numpy(rd)),
                         jm.bounds_interval(jnp.asarray(ro), jnp.asarray(rd))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pm.get_aabb(), jm.get_aabb())


def lanes_agree(got, want):
    """Per lane: every value agrees to rtol 1e-4 / atol 1e-5 (masks equal)."""
    ok = np.ones(N, bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g).reshape(N, -1), np.asarray(w).reshape(N, -1)
        ok &= (g == w).all(1) if g.dtype == bool else np.isclose(g, w, rtol=1e-4, atol=1e-5).all(1)
    return ok


@pytest.mark.parametrize("emissive", [False, True])
def test_tracking_matches_per_lane(emissive):
    from pine_tpu.scene import media_track as JT

    from pine_tpu_torch.scene import media_track as PT

    jm, pm = media_pair(emissive)
    ro, rd, tmax = medium_rays()
    key = np.random.default_rng(6).integers(0, 2**32, N, dtype=np.uint64)
    j_args = tuple(map(jnp.asarray, (ro, rd, tmax, key.astype(np.uint32))))
    p_args = (torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tmax),
              torch.from_numpy(key.astype(np.int64)))
    tr = lanes_agree([PT.grid_transmittance(pm, *p_args).numpy()],
                     [JT.grid_transmittance(jm, *j_args)])
    sc_p = [x.numpy() for x in PT.grid_sample_scatter(pm, *p_args)]
    sc_j = JT.grid_sample_scatter(jm, *j_args)
    sc = lanes_agree(sc_p, sc_j)
    assert tr.mean() >= 0.99 and sc.mean() >= 0.99, (tr.mean(), sc.mean())
    scattered, absorbed = sc_p[0], sc_p[3]
    assert scattered.mean() > 0.05 and absorbed.mean() > 0.01  # the walk does both
    if emissive:
        assert (sc_p[4] > 0).any()


def test_early_end_of_tracking_is_exact(monkeypatch):
    from pine_tpu_torch.scene import media_track as PT

    _, pm = media_pair(emissive=True)
    ro, rd, tmax = medium_rays(7)
    key = torch.from_numpy(np.random.default_rng(8).integers(0, 2**32, N).astype(np.int64))
    args = (torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tmax), key)
    early = (PT.grid_transmittance(pm, *args), *PT.grid_sample_scatter(pm, *args))
    monkeypatch.setattr(PT, "EXIT_CHECK", PT.TRACK_STEPS + 1)  # all TRACK_STEPS steps
    full = (PT.grid_transmittance(pm, *args), *PT.grid_sample_scatter(pm, *args))
    for a, b in zip(early, full):
        assert torch.equal(a, b)


def test_scene_transmittance_matches():
    from pine_tpu.scene import materials as JMat
    from pine_tpu.scene import media as JM
    from pine_tpu.scene import shapes as JS
    from pine_tpu.scene.scene import Scene as JScene

    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from test_torch_csg import carried_arrays

    from pine_tpu.core.camera import ThinLenCamera
    from pine_tpu.core.film import Film

    scene = JScene()
    scene.add(JS.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), JMat.Diffuse([0.5, 0.5, 0.5]))
    fog = JS.BoxAABB([-1, 0, 0], [1, 2, 2]) - JS.Sphere([0, 1, 1], 0.5)
    scene.add(JM.HomogeneousMedium(fog, JM.HgPhaseFunction(0.3), [0.1, 0.2, 0.3], [0.5, 0.4, 0.3]))
    scene.add(media_pair()[0])
    scene.set(ThinLenCamera(Film((8, 8)), [0, 1, -3], [0, 1, 0], 0.4))
    jcs = scene.compile()
    pcs = compiled_scene_from_arrays(carried_arrays(jcs, scene.camera), "cpu")
    assert len(pcs.media) == 1 and len(pcs.grid_media) == 1
    ro, rd, tmax = medium_rays(9)
    for grid in (False, True):
        got = pcs.transmittance(torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tmax),
                                grid=grid).numpy()
        want = np.asarray(jcs.transmittance(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmax),
                                            grid=grid))
        assert (want < 0.99).mean() > 0.2
        assert lanes_agree([got], [want]).mean() >= 0.99


def test_compile_cache_drops_on_add():
    """Adding a medium, a CSG tree or an SDF drops the scene's compiled
    state; another scene never gets it."""
    from pine_tpu_torch.scene import materials as M
    from pine_tpu_torch.scene import media as Med
    from pine_tpu_torch.scene import shapes as S
    from pine_tpu_torch.scene.scene import Scene

    def box():
        scene = Scene()
        scene.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), M.Diffuse([0.5, 0.5, 0.5]))
        return scene

    a, b = box(), box()
    cs = a.compile("cpu")
    assert a.compile("cpu") is cs and b.compile("cpu") is not cs
    a.add(Med.HomogeneousMedium(S.Sphere([0, 0, 0], 1.0), Med.HgPhaseFunction(0.0), 0.1, 0.2))
    cs2 = a.compile("cpu")
    assert cs2 is not cs and len(cs2.media) == 1 and not cs.media
    a.add(S.Sphere([0, 0, 0], 1.0) * S.Sphere([0, 0, 0.5], 1.0), M.Diffuse([1, 1, 1]))
    cs3 = a.compile("cpu")
    assert cs3 is not cs2 and len(cs3.csg_shapes) == 1 and not cs2.csg_shapes
    assert not b.compile("cpu").media and not b.compile("cpu").csg_shapes


def test_port_imports_neither_jax_nor_pine_tpu():
    """Every module of the port (and chip_smoke.py) imports in a process
    that then holds no jax and no pine_tpu module."""
    src = ("import importlib, pkgutil, sys\n"
           "import pine_tpu_torch\n"
           "for m in pkgutil.walk_packages(pine_tpu_torch.__path__, 'pine_tpu_torch.'):\n"
           "    if not m.name.endswith('__main__'): importlib.import_module(m.name)\n"
           "import chip_smoke\n"
           "bad = sorted(k for k in sys.modules\n"
           "             if k.split('.')[0] in ('jax', 'jaxlib', 'pine_tpu'))\n"
           "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", src], cwd=ROOT, env=dict(env, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]
