"""Guided path tracing against pine_tpu: one traced iteration from a frozen
guide, one whole render, and the port against its own path integrator.

1. One traced sample (``_trace_guided``, prob_a 0.5, training on) of each
   package from the same trained guide at 16x16, depth 3: pine_tpu's op by
   op under ``jax.disable_jit`` (its jitted trace fuses multiply-adds, which
   the port's, like its other integrators, follows op by op; and a jitted
   render costs 97-260 s a case), the port's on its compiled scene carried
   across by convert and the guide by ``convert.guide_state``.  The box is
   bench.py's with a 3 x 3 cone field (GUIDED_BOX).  The guide:
   pine_tpu's GuidingTree after a seeded training round (a hot quadrant,
   spatial splits), or a seeded histogram for the "grid" structure.  Cases:
   the reduced box with the tree and with the grid, the CSG fog box
   (homogeneous segment terms, the CSG walk) and the 16^3 cloud (first-class
   medium vertices).  Held to: each lane's radiance to 1e-3 relative or 1e-4
   absolute on 97 % of the lanes (test_torch_cloud's LANE_SHARE: a shadow
   ray's ratio tracking is keyed by the bits of its origin, so an ulp there
   draws another estimate); the sample counts equal; the collector and the
   histogram to rtol 2e-6 (the port sums in float64 and rounds once,
   pine_tpu adds in float32 lane by lane).  Measured: every lane of every
   case; 22, 22 and 21 of the 26,944 collector entries (box, fog, cloud)
   differ, by 1.1e-7 relative at most, and 9 of the 2,362,756 histogram
   entries, by 6.0e-7.
2. pine_tpu's ``render_guided`` under ``jax.disable_jit`` against the
   port's on that box, 16x16, BlueSampler(8), depth 3, tree: the
   spatial leaves and quadtree nodes after each training iteration equal
   (a float64-rounded collector could move a quadrant across the 1 % split
   only where its flux lies within an ulp of it), the image by the render
   rule (97 % of pixels, means to 1 %).  Measured: the same trees (one
   spatial leaf; 381, then 321 quadtree nodes), 100 % of pixels; the final
   arenas' topology equal, 110 of their 321 flux entries an ulp apart.
3. The port's guided render (tree, and grid on 16 cells a side) against
   its PathIntegrator on the reduced box (36 cones), 24x24, BlueSampler(32),
   depth 4: the means within 3 % (tests/test_integrators.py's unbiasedness
   check; measured 0.2 % and 0.4 %).
4. A script's GuidedPathIntegrator rendered through the interpreter with
   either structure equals render_guided's image bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pine_tpu.core.samplers import BlueSampler as JBlue
from pine_tpu.integrators import guidedpath as JG
from pine_tpu.integrators import guiding_tree as JT
from test_torch_cloud import LANE_SHARE, jax_cloud
from test_torch_csg import carried_arrays
from test_torch_render import REDUCED, assert_renders_agree

from pine_tpu_torch.convert import compiled_scene_from_arrays, guide_state
from pine_tpu_torch.core.samplers import BlueSampler
from pine_tpu_torch.integrators import guidedpath as PG
from pine_tpu_torch.integrators.cachedpath import SpatialGrid

torch.set_num_threads(2)

SIZE, DEPTH = 16, 3
# the bench box with 3 x 3 cones: 17 prims, so no accel in either package
# (each prim type's table one group, on the dense route in the port):
# pine_tpu's op-by-op packet walk of the 36-cone box's lattice group would
# double its render's 3 s a sample
GUIDED_BOX = ((-0.1, 0.1, 0.1), (0.7, 0.1, 0.9))
CPU = torch.device("cpu")


def box_prl(cones=None):
    """bench.py's box with its cone loops cut to ``cones`` ((begin, step,
    end) in x and in z; default GUIDED_BOX)."""
    import bench

    (x0, dx, x1), (z0, dz, z1) = cones or GUIDED_BOX
    return (bench.CBOX_PRL.replace("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}")
            .replace("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}"))


def jax_script_scene(src):
    from pine_tpu.prl.interp import Interpreter

    itp = Interpreter()
    itp.run(src, "<script>")
    return itp.get_var("scene")


def carried(scene):
    """(pine_tpu's compiled scene, the port's carried from it, the guide's
    bounds: the scene's box and its media's, as render_guided takes them)."""
    jcs = scene.compile()
    pcs = compiled_scene_from_arrays(carried_arrays(jcs, scene.camera), "cpu")
    lo, hi = scene.get_aabb()
    for med in list(jcs.grid_media) + list(jcs.media):
        mlo, mhi = med.get_aabb()
        lo, hi = np.minimum(lo, mlo), np.maximum(hi, mhi)
    return jcs, pcs, (lo, hi)


@pytest.fixture(scope="module")
def box():
    scene = jax_script_scene(box_prl())
    assert scene.compile().n_global == 17
    return (scene,) + carried(scene)


def trained_tree(lo, hi, n, seed):
    """pine_tpu's GuidingTree after one seeded training round: 4,096 samples
    at points over the box, 70 % of them in one quadrant of their quadtree,
    added by its dtree_add; 10 samples counted for each."""
    gt = JT.GuidingTree(lo, hi, n_initial_samples=n)
    rng = np.random.default_rng(seed)
    st = gt.device_state()
    m = 4096
    p = jnp.asarray(rng.uniform(lo, hi, (m, 3)).astype(np.float32))
    droot, leaf, _ = JT.stree_lookup(st["schild"], st["sdroot"], jnp.asarray(gt.lo),
                                     jnp.asarray(gt.inv_diag), jnp.float32(gt.footprint0), p)
    sq = rng.random((m, 2)).astype(np.float32)
    hot = rng.random(m) < 0.7
    sq[hot] = sq[hot] * 0.25 + 0.5
    flux = jnp.asarray(rng.exponential(1.0, m).astype(np.float32))
    dcoll = JT.dtree_add(st["dcoll"], st["dchild"], droot, jnp.asarray(sq), flux,
                         jnp.ones(m, bool))
    scount = np.zeros(st["scount"].shape[0], np.float32)
    np.add.at(scount, np.asarray(leaf), 10.0)
    gt.absorb(np.asarray(dcoll), scount)
    gt.refine(3000.0)
    return gt


def frozen_iteration(scene, jcs, pcs, bounds, struct, seed=0):
    """One traced sample of each package from the same guide -> (pine_tpu's
    L, the port's, {key: (pine_tpu's, the port's)} of the guide's sums)."""
    n = SIZE * SIZE
    lo, hi = bounds
    if struct == "tree":
        jgt = trained_tree(lo, hi, n, seed)
        jguide, grid, jstate = JG.TreeGuide(jgt), None, jgt.device_state()
        pguide = PG.TreeGuide(PG.GT.GuidingTree(lo, hi, n_initial_samples=n), CPU)
        pstate = guide_state(jgt._arrays, CPU)
        keys = ("dcoll", "scount")
    else:
        from pine_tpu.integrators.cachedpath import SpatialGrid as JGrid

        grid = JGrid(lo, hi, 32)
        rng = np.random.default_rng(seed)
        hist = (rng.exponential(1.0, (grid.n_cells(), 256))
                * (rng.random((grid.n_cells(), 256)) < 0.3)).astype(np.float32)
        jguide, jstate = JG.DirectionalGuide(grid), {"hist": jnp.asarray(hist)}
        pguide = PG.DirectionalGuide(SpatialGrid(lo, hi, 32, CPU))
        pstate = guide_state({"hist": hist}, CPU)
        keys = ("hist",)
    ys, xs = np.divmod(np.arange(n), SIZE)
    with jax.disable_jit():
        want, jst = JG._trace_guided(jcs, scene.camera.params(), jnp.asarray(xs, jnp.int32),
                                     jnp.asarray(ys, jnp.int32), SIZE, SIZE, JBlue(8), 1, DEPTH,
                                     grid, jguide, jstate, 0.5, True)
        want = np.asarray(want)
    got, pst, _ = PG._trace_guided(pcs, pcs.camera, torch.as_tensor(xs, dtype=torch.int32),
                                   torch.as_tensor(ys, dtype=torch.int32), SIZE, SIZE,
                                   BlueSampler(8), 1, DEPTH, pguide, pstate, 0.5, True)
    return want, got.numpy(), {k: (np.asarray(jst[k]), pst[k].numpy()) for k in keys}


def assert_iterations_agree(want, got, sums):
    d = np.abs(got - want)
    share = ((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).all(-1).mean()
    assert share >= LANE_SHARE, share
    assert np.isfinite(got).all() and want.mean() > 0.01
    for k, (w, g) in sums.items():
        if k == "scount":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0, err_msg=k)
            assert (g != 0).sum() > 100, k


@pytest.mark.parametrize("struct", ["tree", "grid"])
def test_box_iteration_from_a_frozen_guide(box, struct):
    assert_iterations_agree(*frozen_iteration(*box, struct))


def test_fog_box_iteration_from_a_frozen_guide():
    from pine_tpu_torch import scenes

    scene = jax_script_scene(scenes.csg_fog_prl(SIZE, integrator=None, save=None))
    jcs, pcs, bounds = carried(scene)
    assert len(pcs.csg_shapes) == 4 and len(pcs.media) == 1
    assert_iterations_agree(*frozen_iteration(scene, jcs, pcs, bounds, "tree"))


def test_grid_medium_iteration_from_a_frozen_guide():
    scene = jax_cloud((SIZE, SIZE), 16)
    jcs, pcs, bounds = carried(scene)
    assert len(pcs.grid_media) == 1
    assert_iterations_agree(*frozen_iteration(scene, jcs, pcs, bounds, "tree"))


def test_whole_render_matches_pine_tpu(box, monkeypatch):
    scene, jcs, pcs, bounds = box
    sizes = []
    refine = JT.GuidingTree.refine

    def recorded(tree, threshold):
        refine(tree, threshold)
        sizes.append((tree.n_spatial_leaves(), len(tree._qnodes)))

    monkeypatch.setattr(JT.GuidingTree, "refine", recorded)
    with jax.disable_jit():
        want = np.asarray(JG.render_guided(jcs, scene.camera, SIZE, SIZE, JBlue(8), 8, DEPTH))
    got, stats, tree = PG._render_guided(pcs, None, SIZE, SIZE, BlueSampler(8), 8, DEPTH,
                                         scene.get_aabb())
    assert [(it["spatial_leaves"], it["quadtree_nodes"]) for it in stats["iterations"][:-1]] \
        == sizes
    assert [it["spp"] for it in stats["iterations"]] == [2, 4, 2]
    for k in ("schild", "sdroot", "dchild", "scount"):
        np.testing.assert_array_equal(tree.arrays()[k], JG._LAST_TREE._arrays[k], err_msg=k)
    assert_renders_agree(got.numpy(), want)


@pytest.fixture(scope="module")
def path_box():
    """The reduced box (36 cones) and the port's path integrator's render of
    it, 24x24, BlueSampler(32), depth 4."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.integrators.path import render_wavefront

    scene = scenes.cbox((24, 24), *REDUCED)
    cs = scene.compile("cpu")
    return scene, cs, render_wavefront(cs, scene.camera, 24, 24, BlueSampler(32), 32, 4).numpy()


@pytest.mark.parametrize("struct", ["tree", "grid"])
def test_guided_mean_is_the_path_integrators(path_box, struct):
    scene, cs, p = path_box
    # the grid on 16 cells a side: its float64 sums cover the whole
    # histogram, which at the default 32 costs the CPU more than the render
    g = PG.render_guided(cs, scene.camera, 24, 24, BlueSampler(32), 32, 4, scene.get_aabb(),
                         max_axis_resolution=16, struct=struct).numpy()
    assert np.isfinite(g).all()
    assert abs(g.mean() - p.mean()) <= 0.03 * p.mean(), (g.mean(), p.mean())


@pytest.mark.parametrize("struct", ["tree", "grid"])
def test_script_renders_guided_through_the_interpreter(struct):
    """A script's GuidedPathIntegrator, rendered by the interpreter's
    ``render`` with either structure (``struct`` set on the integrator, as
    pine_tpu's PINE_GUIDE_STRUCT picks it), is render_guided's image."""
    from pine_tpu_torch import scenes
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device="cpu", out=lambda s: None)
    itp.run(scenes.CBOX_PRL.replace("[640, 640]", "[8, 8]")
            + "g := GuidedPathIntegrator(BlueSampler(4), 3);", "<guided box>")
    itp.get_var("g").struct = struct
    itp.run("render(g, scene);")
    scene = itp.get_var("scene")
    got = scene.camera.film.rgb.numpy()
    want = PG.render_guided(scene.compile("cpu"), scene.camera, 8, 8, BlueSampler(4), 4, 3,
                            scene.get_aabb(), struct=struct).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.mean() > 0
