"""pine_tpu_torch's scene layer against pine_tpu on random hits.

Per analytic type: the brute-force intersect, surface info, light sampling
and the light pdf.  Per
material: the per-lane BXDF state, then BSDF sampling and f/pdf evaluation
for the four ported lobes (diffuse, conductor, refractive dielectric,
diffusive dielectric).  And the scene build: the Scene API's benchmark box
flattens to pine_tpu's tables, and the numpy SAH builder's leaf order is
pine_tpu's numpy builder's.  Tolerance: rtol 1e-4, atol 1e-5 (float32; the
GGX terms divide small numbers, so a few ulps of input grow); where a value
is ill-conditioned the test says why it compares it otherwise.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.scene import intersect as JI
from pine_tpu.scene import lights as JL
from pine_tpu.scene import materials as JM
from pine_tpu.scene import shapes as JS
from pine_tpu.scene import bxdf as Jbxdf
from pine_tpu.scene import material_eval as Jme
from pine_tpu_torch.scene import bxdf as Pbxdf
from pine_tpu_torch.scene import intersect as PI
from pine_tpu_torch.scene import lights as PL
from pine_tpu_torch.scene import material_eval as Pme
from pine_tpu_torch.scene import materials as PM
from pine_tpu_torch.scene import shapes as PS
from test_torch_dense_kernel import TYPES, make_shape

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
N = 1024


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _rows(tid, seed, n_shapes=5):
    rng = np.random.default_rng(seed)
    shapes = [make_shape(tid, rng) for _ in range(n_shapes)]
    table = np.stack([s.params() for s in shapes]).astype(np.float32)
    pick = rng.integers(0, n_shapes, N)
    return table[pick], rng


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("name", list(TYPES))
def test_brute_force_intersect_matches(name):
    """The (rays x prims) product: pine_tpu's brute force for scenes of 24 or
    fewer prims, the port's "plain" route for lines."""
    tid = TYPES[name]
    rng = np.random.default_rng(70 + tid)
    params = np.stack([make_shape(tid, rng).params() for _ in range(7)]).astype(np.float32)
    ro = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    rd = _unit(rng, N)
    tmin = rng.uniform(0, 0.2, (N, 1)).astype(np.float32)
    tmax = np.where(rng.uniform(size=(N, 1)) < 0.5, 4.0, 1e30).astype(np.float32)
    inputs = (params, ro, rd, tmin, tmax)
    snapshot = [x.copy() for x in inputs]
    # each package gets its own copy (jnp.asarray and torch.from_numpy may
    # both alias the numpy buffers), and the inputs must come back unchanged
    want = np.array(JI.INTERSECT[tid](*(jnp.array(x) for x in inputs)))
    got = PI.INTERSECT[tid](*(torch.from_numpy(x.copy()) for x in inputs)).numpy()
    for x, x0 in zip(inputs, snapshot):
        np.testing.assert_array_equal(x, x0)
    assert (want < 1e30).any()
    np.testing.assert_array_equal(got < 1e30, want < 1e30)
    bad = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    _close(got, want, rtol=1e-5, atol=1e-6, err_msg="lanes (ray, prim, port, pine_tpu): " + str(
        [(int(i), int(j), float(got[i, j]), float(want[i, j])) for i, j in zip(*np.nonzero(bad))]))


@pytest.mark.parametrize("name", list(TYPES))
def test_surface_info_matches(name):
    tid = TYPES[name]
    rows, rng = _rows(tid, tid)
    p = (rows[:, 0:3] + rng.uniform(-0.3, 0.3, (N, 3))).astype(np.float32)
    want = JI.SURFACE_INFO[tid](jnp.asarray(rows), jnp.asarray(p))
    got = PI.SURFACE_INFO[tid](torch.from_numpy(rows), torch.from_numpy(p))
    for g, w, what in zip(got, want, ("p", "n", "uv")):
        _close(g, w, err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", list(TYPES))
def test_light_sample_and_pdf_match(name):
    tid = TYPES[name]
    rows, rng = _rows(tid, 50 + tid)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    want = JI.SAMPLE[tid](jnp.asarray(rows), jnp.asarray(p), jnp.asarray(u))
    got = PI.SAMPLE[tid](torch.from_numpy(rows), torch.from_numpy(p), torch.from_numpy(u))
    for k in ("p", "n", "w", "distance", "pdf"):
        # a sphere sample at the silhouette takes its distance from the square
        # root of a cancellation: the normal there carries ~1e-4 either way
        atol = 2e-4 if (tid == TYPES["sphere"] and k == "n") else ATOL
        _close(got[k], want[k], atol=atol, err_msg=f"{name} {k}")
    rd = _unit(rng, N)
    ns = _unit(rng, N)
    t = rng.uniform(0.1, 5, N).astype(np.float32)
    args = [p, rd, t, ns]
    _close(PI.PDF[tid](torch.from_numpy(rows), *map(torch.from_numpy, args)),
           JI.PDF[tid](jnp.asarray(rows), *map(jnp.asarray, args)), err_msg=name)


def test_area_and_point_lights_match():
    rng = np.random.default_rng(9)
    rect = JS.Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1])
    color = np.float32(600) * np.float32([1.0, 0.64, 0.185])
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    u1 = rng.uniform(size=N).astype(np.float32)
    ctx = dict(p=jnp.asarray(p), n=jnp.zeros((N, 3)), uv=jnp.zeros((N, 2)))
    pairs = [
        (JL.AreaLight(rect, JM.Emissive(color), 3),
         PL.AreaLight(rect.type_id, torch.from_numpy(rect.params()), 3, torch.from_numpy(color))),
        (JL.PointLight([0.2, 1.5, 0.3], [4.0, 3.0, 2.0]),
         PL.PointLight([0.2, 1.5, 0.3], [4.0, 3.0, 2.0])),
    ]
    for jl, pl in pairs:
        want = jl.sample(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(u1), ctx)
        got = pl.sample(torch.from_numpy(p), torch.from_numpy(u2), torch.from_numpy(u1))
        for k in ("le", "wo", "distance", "pdf"):
            _close(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
        assert pl.is_delta == jl.is_delta


MATERIALS = [
    ("Diffuse", ([0.9, 0.5, 0.1],)),
    ("Metal", ([1.0, 0.8, 0.6], 0.0)),
    ("Metal", ([0.7, 0.7, 0.9], 0.3)),
    ("Glossy", ([0.25, 0.25, 0.25], 0.05)),
    ("Glossy", ([0.6, 0.3, 0.2], 0.5, 1.6)),
    ("Glass", ([1.0, 1.0, 1.0], 0.0, 1.5)),
    ("Glass", ([0.9, 1.0, 0.9], 0.3)),
    ("Emissive", ([5.0, 4.0, 3.0],)),
]


def _states(seed):
    """The same materials in both packages, lane states from random slots."""
    from pine_tpu_torch.convert import compiled_scene_from_arrays, scene_arrays
    from pine_tpu_torch.scene.scene import Scene

    rng = np.random.default_rng(seed)
    pscene = Scene()
    jmats = []
    for k, (cls, args) in enumerate(MATERIALS):
        jmats.append(getattr(JM, cls)(*args))
        pscene.add(PS.Sphere([3.0 * k, 0, 0], 1.0), getattr(PM, cls)(*args))
    pcs = compiled_scene_from_arrays(scene_arrays(pscene), "cpu")

    class JCS:
        materials = jmats

    mat_idx = rng.integers(0, len(MATERIALS), N).astype(np.int32)
    diffused = rng.uniform(size=N) < 0.3
    n = _unit(rng, N)
    wi_world = _unit(rng, N)
    u_a, u_b = rng.uniform(size=(2, N)).astype(np.float32)
    ctx = dict(p=jnp.zeros((N, 3)), n=jnp.asarray(n), uv=jnp.zeros((N, 2)))
    jst = Jme.eval_bxdf_state(JCS, jnp.asarray(mat_idx), ctx, jnp.asarray(wi_world),
                              jnp.asarray(u_a), jnp.asarray(u_b), 0.6, jnp.asarray(diffused))
    pctx = dict(p=torch.zeros(N, 3), n=torch.from_numpy(n), uv=torch.zeros(N, 2))
    pst = Pme.eval_bxdf_state(pcs, torch.from_numpy(mat_idx), pctx, torch.from_numpy(wi_world),
                              torch.from_numpy(u_a), torch.from_numpy(u_b), 0.6,
                              torch.from_numpy(diffused))
    return jst, pst, rng


def test_bxdf_state_matches():
    jst, pst, _ = _states(11)
    for k in ("tag", "albedo", "roughness", "ior"):
        np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]), err_msg=k)


def test_bxdf_sample_and_eval_match():
    jst, pst, rng = _states(12)
    wi = _unit(rng, N)
    wo = _unit(rng, N)
    u2, u2b = rng.uniform(size=(2, N, 2)).astype(np.float32)
    u1 = rng.uniform(size=N).astype(np.float32)
    js = Jbxdf.sample(jst, *map(jnp.asarray, (wi, u2, u1, u2b)))
    ps = Pbxdf.sample(pst, *map(torch.from_numpy, (wi, u2, u1, u2b)))
    for k in ("is_delta_sample", "valid"):
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]), err_msg=k)
    ok = np.asarray(js["valid"])
    _close(ps["wo"].numpy()[ok], np.asarray(js["wo"])[ok], err_msg="wo")
    # the integrator uses f / pdf; near a smooth lobe's grazing peak f and pdf
    # are each ~1e6 and ill-conditioned, so compare them there by their ratio
    jpdf, ppdf = np.asarray(js["pdf"]), ps["pdf"].numpy()
    _close(ps["f"].numpy()[ok] / ppdf[ok, None], np.asarray(js["f"])[ok] / jpdf[ok, None],
           err_msg="f/pdf")
    tame = ok & (jpdf < 1e4)
    _close(ps["f"].numpy()[tame], np.asarray(js["f"])[tame], err_msg="f")
    _close(ppdf[tame], jpdf[tame], err_msg="pdf")
    np.testing.assert_array_equal(Pbxdf.is_delta(pst).numpy(), np.asarray(Jbxdf.is_delta(jst)))
    jf, jp = Jbxdf.f_and_pdf(jst, jnp.asarray(wi), jnp.asarray(wo))
    pf, pp = Pbxdf.f_and_pdf(pst, torch.from_numpy(wi), torch.from_numpy(wo))
    _close(pf, jf)
    _close(pp, jp)


def test_sah_order_is_pine_tpu_numpy_builder():
    """The numpy builder, kept as the reference, orders leaves as pine_tpu's;
    the groups themselves take the C++ builder's order (test_torch_mesh.py)."""
    from pine_tpu.accel import bvh as Jbvh
    from pine_tpu.accel.native_build import build_sah_native
    from pine_tpu_torch.accel import bvh as Pbvh

    rng = np.random.default_rng(13)
    for n in (17, 100, 420):
        c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        lo, hi = c - 0.05, c + 0.05
        want, _ = Jbvh._build_sah(lo, hi, (lo + hi) * 0.5)
        got, _ = Pbvh._build_sah(lo, hi, (lo + hi) * 0.5)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(Pbvh.sah_arrays(lo, hi)[0], build_sah_native(lo, hi)[0])


def test_cbox_scene_flattens_like_pine_tpu():
    """The port's Scene API benchmark box (scenes.cbox, reduced cone field)
    gives pine_tpu's per-type tables, materials and geometry ids."""
    import bench
    from pine_tpu.prl.interp import Interpreter

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import scene_arrays

    src = (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", "-0.3 ~ 0.1 ~ 0.3")
           .replace("0.0 ~ 0.1 ~ 2.0", "0.5 ~ 0.1 ~ 1.0"))
    itp = Interpreter()
    itp.run(src, "<reduced cbox>")
    jscene = itp.get_var("scene")
    jcs = jscene.compile()
    a = scene_arrays(scenes.cbox((32, 32), (-0.3, 0.1, 0.3), (0.5, 0.1, 1.0)))
    for k in ("g_type", "g_local", "g_mat"):
        np.testing.assert_array_equal(a[k], getattr(jcs, k), err_msg=k)
    for tid, table in jcs.tables.items():
        np.testing.assert_array_equal(a[f"table.{tid}"], np.asarray(table), err_msg=str(tid))
    assert [int(a[f"mat.{i}.tag"]) for i in range(int(a["n_materials"]))] == [
        m.tag for m in jcs.materials]
    assert int(a["n_lights"]) == len(jcs.lights) == 1
    assert int(a["light.0.gidx"]) == jcs.lights[0].global_idx
    groups = [(int(a[f"group.{i}.tid"]), str(a[f"group.{i}.kind"]), a[f"group.{i}.rows"].shape)
              for i in range(int(a["n_groups"]))]
    assert groups == [(g["tid"], g["kind"], g["rows_np"].shape) for g in jcs.unified["groups"]]
    # each group holds the same geometries.  The cone lattice's leaf order may
    # differ: pine_tpu builds its C++ builder with -march=native, whose fused
    # multiply-adds break the lattice's exact SAH cost ties another way than
    # the port's contraction-free build (test_torch_mesh.py holds the builders
    # equal on meshes without such ties)
    ent = np.asarray(jcs.unified["ent_gidx"])
    for i, g in enumerate(jcs.unified["groups"]):
        b, n = g["base"], len(g["_prim_aabbs"])
        assert sorted(a["ent_gidx"][b:b + n]) == sorted(ent[b:b + n])
    np.testing.assert_array_equal(a["cam.rot"], np.asarray(jscene.camera.params()["rot"]))
