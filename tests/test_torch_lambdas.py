"""The builtins that take a script lambda (draw, SDF, heightmap(size, fn),
Function) and the PRL reference document, against pine_tpu.

1. storm (scenes.STORM_PRL, README's draw() example, at 64x64): the port's
   image against pine_tpu's jitted draw.  Its 19 chaotic iterations of
   cos, tanh, pow and exp amplify the last bits of the transcendental
   functions (the port's core/fmath in float64, rounded; XLA's float32
   approximations), so it is held to 1e-3 relative or 1e-4 absolute on 99 %
   of the channel values (measured: 99.4 %; 8 % bit for bit), finite.
2. The torus as a PRL SDF lambda (scenes.TORUS_SDF_PRL): its box is
   torus_shape's and its distance scenes.torus_sdf's, bit for bit; distance,
   march t and normal over 4,096 seeded rays (test_torch_sdf's) against
   pine_tpu's _sdf_march / _sdf_normal of the same lambda through its
   interpreter: hit masks on 99.9 % of the lanes, t to rtol 1e-4, normals
   to 1e-3 (test_torch_sdf's tolerances).
3. heightmap(size, fn): the mesh of a polynomial lambda bit for bit
   pine_tpu's, of an fbm lambda to 1e-4 (the noise's parity,
   test_torch_samplers).
4. A Function node of a script lambda: its values over a seeded ctx equal
   pine_tpu's (rtol 1e-6).
5. The PRL reference (prl/apidoc.py) lists the builtin names pine_tpu's
   lists, but for pine_tpu's internal ``_to_node``.
6. CSG_FOG_SDF_PRL cut to 32x32, BlueSampler(2), depth 3: pine_tpu's
   compiled scene carried across with the port's lambda, the port's render
   against pine_tpu's jitted one by test_torch_render's rule.

``lines_agree`` runs one PRL line through both interpreters and compares
what it built; the refusal cases of earlier slices that this slice ports
use it.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def run_line(src):
    """``src`` through both interpreters -> (port's, pine_tpu's)."""
    from pine_tpu.prl.interp import Interpreter as JInterp

    from pine_tpu_torch.prl.interp import Interpreter

    p, j = Interpreter(device="cpu", out=lambda s: None), JInterp(out=lambda s: None)
    p.run(src)
    j.run(src)
    return p, j


def values_agree(p, j):
    """A value the port built against pine_tpu's: images and meshes to rtol
    1e-6, SDF shapes by their boxes and distances on seeded points, nodes
    by their values on a seeded ctx, integrators by their settings (the
    sampler's spp and the depth, or every setting of those without a
    sampler)."""
    from pine_tpu_torch.scene import nodes as PN

    kind = type(p).__name__
    assert kind == type(j).__name__, (kind, type(j).__name__)
    rng = np.random.default_rng(5)
    if kind == "Array2dValue":
        np.testing.assert_allclose(p.host(), np.asarray(j.data), rtol=1e-6, atol=1e-7)
    elif kind == "SDFShape":
        np.testing.assert_array_equal(p.center, np.asarray(j.center))
        np.testing.assert_array_equal(p.half, np.asarray(j.half))
        pts = rng.normal(size=(256, 3)).astype(np.float32)
        np.testing.assert_allclose(p.fn(torch.from_numpy(pts)).numpy(),
                                   np.asarray(j.fn(jnp.asarray(pts))), rtol=1e-6, atol=1e-7)
    elif kind == "Mesh":
        np.testing.assert_array_equal(p.indices, np.asarray(j.indices))
        np.testing.assert_allclose(p.vertices, np.asarray(j.vertices), rtol=1e-6, atol=1e-7)
    elif isinstance(p, PN.Node):
        ctx = {k: rng.uniform(-1, 1, (64, n)).astype(np.float32)
               for k, n in (("p", 3), ("n", 3), ("uv", 2))}
        got = p.eval({k: torch.from_numpy(v) for k, v in ctx.items()})
        want = j.eval({k: jnp.asarray(v) for k, v in ctx.items()})
        np.testing.assert_allclose(np.broadcast_to(got.numpy(), np.shape(want)),
                                   np.asarray(want), rtol=1e-6, atol=1e-7)
    elif kind.endswith("Integrator") and hasattr(j, "sampler"):
        assert (p.sampler.spp, p.max_path_length) == (j.sampler.spp, j.max_path_length)
    elif kind.endswith("Integrator"):  # MLT's and MicroRenderGI's settings are numbers
        assert vars(p) == vars(j)
    else:
        raise AssertionError(f"no comparison for {kind}")


def lines_agree(src, name="r"):
    """Run ``src`` in both packages and compare the variable ``name``."""
    p, j = run_line(src)
    values_agree(p.get_var(name), j.get_var(name))


def test_storm_matches_pine_tpu():
    from pine_tpu_torch import scenes

    src = scenes.STORM_PRL.replace("[640, 640]", "[64, 64]").replace(
        '}).save("storm.png");', "});").replace("draw(image_size", "img := draw(image_size")
    p, j = run_line(src)
    got, want = p.get_var("img").host(), np.asarray(j.get_var("img").data)
    assert got.shape == want.shape == (64, 64, 3) and np.isfinite(got).all()
    d = np.abs(got - want)
    assert ((d <= 1e-3 * np.abs(want)) | (d <= 1e-4)).mean() >= 0.99


def test_storm_script_runs_through_the_cli(tmp_path):
    """STORM_PRL as written but for its size, through python -m pine_tpu_torch."""
    import os
    import subprocess
    import sys

    from PIL import Image

    from pine_tpu_torch import scenes

    (tmp_path / "storm.pine").write_text(scenes.storm_prl(32))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "pine_tpu_torch", "storm.pine", "--platform",
                        "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0 and "Finished in" in r.stdout, r.stdout + r.stderr
    img = np.asarray(Image.open(tmp_path / "storm.png"))
    assert img.shape[:2] == (32, 32) and img.std() > 0


def sdf_shapes():
    from pine_tpu_torch import scenes

    p, j = run_line("scene := Scene();" + scenes.TORUS_SDF_PRL)
    return p.get_var("scene").geometries[0][0], j.get_var("scene").geometries[0][0]


def test_torus_lambda_is_the_torch_torus():
    from pine_tpu_torch import scenes

    ps, _ = sdf_shapes()
    ref = scenes.torus_shape()
    np.testing.assert_array_equal(ps.center, ref.center)
    np.testing.assert_array_equal(ps.half, ref.half)
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(4096, 3)).astype(np.float32))
    assert torch.equal(ps.fn(pts), scenes.torus_sdf(pts))


def test_sdf_lambda_march_and_normals_match_pine_tpu():
    from pine_tpu.scene import scene as JSc
    from test_torch_sdf import torus_rays

    from pine_tpu_torch.scene import scene as PSc

    ps, js = sdf_shapes()
    values_agree(ps, js)
    ro, rd, tmin, tmax = torus_rays()
    t_j = np.asarray(JSc._sdf_march(js, *map(jnp.asarray, (ro, rd, tmin, tmax))))
    t_p = PSc._sdf_march(ps, *map(torch.from_numpy, (ro, rd, tmin, tmax))).numpy()
    hit_j, hit_p = t_j < 1e30, t_p < 1e30
    assert 0.2 < hit_j.mean() < 0.9
    assert (hit_j == hit_p).mean() >= 0.999, (hit_j != hit_p).sum()
    both = hit_j & hit_p
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-4, atol=1e-6)
    p = (ro + np.where(both, t_j, 1.0)[:, None] * rd).astype(np.float32)
    n_j = np.asarray(JSc._sdf_normal(js, jnp.asarray(p)))[both]
    n_p = PSc._sdf_normal(ps, torch.from_numpy(p)).numpy()[both]
    np.testing.assert_allclose(n_p, n_j, atol=1e-3)


@pytest.mark.parametrize("body, rtol", [("return p.x * p.y * 0.5 + p.x;", 0.0),
                                        ("return fbm(p * 4.0, 4) * 0.3;", 1e-4)])
def test_heightmap_of_a_lambda_matches_pine_tpu(body, rtol):
    p, j = run_line(f"m := heightmap([13, 9], (p: vec2): f32 {{ {body} }});")
    pm, jm = p.get_var("m"), j.get_var("m")
    np.testing.assert_array_equal(pm.indices, jm.indices)
    assert pm.vertices.shape == (13 * 9, 3)
    np.testing.assert_allclose(pm.vertices, jm.vertices, rtol=rtol, atol=rtol * 1e-2)


def test_function_node_matches_pine_tpu():
    lines_agree("r := Function((c: NodeEvalCtx): vec3 { "
                "return [c.p.x * 0.5 + 0.5, c.uv.y * c.n.z, 0.25]; });")
    lines_agree("m := Diffuse(Function((c: NodeEvalCtx): f32 { return c.p.y + 1.0; })); "
                "r := m.albedo;")


def test_apidoc_lists_pine_tpu_names():
    import re

    from pine_tpu.prl import apidoc as japidoc

    from pine_tpu_torch.prl import apidoc

    names = lambda doc: {m for m in re.findall(r"^\| `(\w+)\(", doc, re.M)  # noqa: E731
                         if not m.startswith("_")}
    got, want = names(apidoc.generate()), names(japidoc.generate())
    assert got == want and "draw" in got and "SDF" in got


def test_fog_box_with_lambda_torus_matches_pine_tpu():
    from pine_tpu.core.samplers import BlueSampler as JBlue
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from test_torch_csg import carried_arrays
    from test_torch_render import assert_renders_agree

    from pine_tpu_torch import scenes
    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import render_wavefront

    size, spp, depth = 32, 2, 3
    p, j = run_line(scenes.csg_fog_sdf_prl(size, integrator=None, save=None))
    scene = j.get_var("scene")
    jcs = scene.compile()
    a = carried_arrays(jcs, scene.camera)
    (sdf, _), = p.get_var("scene").compile("cpu").sdf_shapes
    a["sdf.0"].fn = sdf.fn  # the port's bridge of the same lambda
    pcs = compiled_scene_from_arrays(a, "cpu")
    want, jst = jax_render(jcs, scene.camera, size, size, JBlue(spp), spp, depth,
                           return_stats=True)
    got, pst = render_wavefront(pcs, None, size, size, BlueSampler(spp), spp, depth,
                                return_stats=True)
    assert_renders_agree(got.numpy(), np.asarray(want), pst["traced_rays"],
                         float(jst["traced_rays"]))


def test_function_node_survives_the_compile_and_refuses_a_spec():
    """A Function node is carried into the compiled scene by index (a spec
    cannot hold a closure): the compiled material's albedo is the node the
    script built; pine_tpu's Function node, which convert.node_spec would
    have to carry across as a spec, is refused with that reason."""
    from pine_tpu.scene import nodes as JN

    from pine_tpu_torch.convert import node_spec
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device="cpu")
    itp.run('scene := Scene(); m := Diffuse(Function((c: NodeEvalCtx): vec3 { return c.n; }));'
            "scene.add(Sphere([0, 0, 0], 1.0), m);")
    cs = itp.get_var("scene").compile("cpu")
    assert cs.materials[0]["albedo"] is itp.get_var("m").albedo
    with pytest.raises(NotImplementedError, match="closure"):
        node_spec(JN.Function(lambda ctx: 1.0), [])
