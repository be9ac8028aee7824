"""The PRL front end and CLI of the port (pine_tpu_torch/prl, cli.py) against pine_tpu.

- Parse trees: the benchmark box's script (``CBOX_PRL``), the cone forest's
  and the eager snippets of tests/test_prl.py give the same tree in both
  parsers, compared field by field.
- The snippets print the same lines through both interpreters; ``!=`` on
  vectors, where the two depart on purpose, is held to each side's result.
- A builtin whose target is not ported raises NotImplementedError naming
  its ROADMAP.md modules item; those of script lambdas and the random walk
  build what pine_tpu's build; the garden slice's scene model (Subsurface,
  Line, SpotLight, Sky, the Sobol and Halton samplers) builds and compiles.
- ``CBOX_PRL`` through the port's interpreter gives exactly the scene arrays
  of ``scenes.cbox``, and pine_tpu's interpreter the same tables, materials,
  lights, camera and group contents.
- ``python -m pine_tpu_torch tiny.pine --platform cpu`` writes the PNG of
  the library render; without ``--platform cpu`` and without a card, and
  with an unported flag, it exits non-zero, and ``scenes.prl_scene`` of a
  script that renders raises; ``python -m pine_tpu_torch.bench`` without a
  card exits with status 1.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pine_tpu_torch import scenes
from pine_tpu_torch.prl.interp import Interpreter, PRLRuntimeError

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the eager snippets of tests/test_prl.py
SNIPPETS = {
    "arithmetic": "println(1 + 2 * 3);",
    "int_division": "println(7 / 2); println(-7 / 2); println(7 % 2);",
    "declare_vs_assign": "x := 1;\nx = x + 1;\ny = 10;\nprintln(x, \" \", y);",
    "ranges": "s = 0;\nfor i in 0..5 { s += i; }\nprintln(s);\nt = 0.0;\n"
              "for f in 0.0~0.5~1.0 { t += f; }\nprintln(t);",
    "c_style_for_and_while": "s = 0;\nfor i = 0; i < 4; i++ { s += i; }\nprintln(s);\n"
                             "w = 1;\nwhile (w < 10) { w = w * 2; }\nprintln(w);",
    "collatz": "sum = 0;\nfor n in 1..30 {\n    x = n;\n    iter = 0;\n    while (x != 1) {\n"
               "        if (x % 2 == 0) { x = x / 2; }\n        else { x = x * 3 + 1; }\n"
               "        iter += 1;\n    }\n    sum += iter;\n}\nprintln(sum);",
    "vectors": "v := [1.0, 2.0, 3.0];\nprintln(v.x + v.y + v.z);\ni := [2, 3];\n"
               "println(i * 4);\nprintln(v[1]);",
    "matrices": "m = translate([1.0, 0, 0]) * scale([2.0, 2, 2]);\nprintln(m * [1.0, 1, 1]);\n"
                "mm = mat2([0.0, 1.0], [-1.0, 0.0]);\nprintln(mm * [1.0, 0.0]);",
    "fn_recursion": "fn fib(n: i32): i32 {\n    if (n < 2) { return n; }\n"
                    "    return fib(n - 1) + fib(n - 2);\n}\nprintln(fib(10));",
    "lambda": "fn make_adder(k: f32): (f32): f32 {\n    return (x: f32): f32 { return x + k; };\n"
              "}\nadd3 := make_adder(3.0);\nprintln(add3(4.0));",
    "class": "class Counter {\n    ctor Counter(start: i32) {\n        value = start;\n    }\n"
             "    fn bump(amount: i32): i32 {\n        value += amount;\n        return value;\n"
             "    }\n    value: i32;\n}\nc := Counter(5);\nc.bump(2);\nprintln(c.bump(1));\n"
             "println(c.value);",
    "precedence": "println(8.0 * 4.0 / 2.0); println(2 + 3 * 4 - 1);",
    "strings": "println('a' + \"b\" + 1.5);",
    "comments": "# a comment\nprintln(1); # trailing\n",
    "compound_member": "v := [1.0, 2.0, 3.0];\nv.x += 10;\nprintln(v.x);",
    "break_continue": "s = 0;\nfor i in 0..10 {\n    if (i == 3) { continue; }\n"
                      "    if (i == 6) { break; }\n    s += i;\n}\nprintln(s);",
    "builtin_math": "println(min(3, 7)); println(max_value([1.0, 5.0, 2.0]));",
    "transforms": "println(rotate_y(0.4) * [1.0, 0, 0]); println(normalize([3.0, 4, 0]));\n"
                  "println(inverse(scale([2.0, 4, 8])) * [1.0, 1, 1]); println(cross(X, Y));\n"
                  "println(lerp(0.25, 1.0, 3.0), ' ', clamp(7, 0, 5), ' ', vec3(2));",
}


def walk(a, b, path="tree"):
    """Compare two parse trees node by node: class names and every field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            walk(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            walk(x, y, f"{path}[{k}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", ["CBOX_PRL", "CONE_FOREST_PRL"] + list(SNIPPETS))
def test_parse_trees_match_pine_tpu(name):
    from pine_tpu.prl.parser import parse as jparse

    from pine_tpu_torch.prl.parser import parse

    src = getattr(scenes, name) if name.endswith("_PRL") else SNIPPETS[name]
    walk(parse(src), jparse(src))


def run_both(src):
    from pine_tpu.prl.interp import Interpreter as JInterpreter

    got, want = [], []
    Interpreter(out=got.append, device="cpu").run(src)
    JInterpreter(out=want.append).run(src)
    return got, want


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_snippets_print_as_pine_tpu(name):
    got, want = run_both(SNIPPETS[name])
    assert got == want and got


def test_vector_inequality_is_the_negation():
    """The one place the port's interpreter departs from pine_tpu on purpose
    (ROADMAP.md section 3): ``!=`` on vectors is the negation of ``==``, where
    pine_tpu's eager path returns the equality for both operators."""
    got, want = run_both("println([1, 2] != [1, 3]); println([1, 2] != [1, 2]);"
                         "println([1, 2] == [1, 3]); println([1.0, 2] == [1, 2]);")
    assert got == ["true", "false", "false", "true"]
    assert want == ["false", "true", "false", "true"]


def test_errors_and_unported_builtins():
    from pine_tpu_torch.prl.parser import PRLSyntaxError, parse

    with pytest.raises(PRLSyntaxError, match="Expect a primary expression"):
        parse("x := ;")
    with pytest.raises(PRLRuntimeError):
        Interpreter(device="cpu").run("println(nope);")
    with pytest.raises(NotImplementedError, match="item 12"):
        Interpreter(device="cpu").run("GuidedPathIntegrator(UniformSampler(4), 4);")
    # the lambdas' builtins and the random walk are ported: the same line in
    # both packages builds the same value (tests/test_torch_lambdas.py)
    from test_torch_lambdas import lines_agree

    for src in ("r := SDF(AABB([0, 0, 0], [1, 1, 1]), (p: vec3): f32 { return 0.5; });",
                "r := Function((c: NodeEvalCtx): vec3 { return c.p; });",
                "r := heightmap([4, 4], (p: vec2): f32 { return p.x; });",
                "r := RandomWalkIntegrator(UniformSampler(4), 4);",
                "r := draw([4, 4], (u: vec2): vec3 { return [u.x, u.y, 0.5]; });"):
        lines_agree(src)
    # the scene model of the garden slice builds: Subsurface, lines, a spot light, skies
    itp = Interpreter(device="cpu")
    itp.run('scene := Scene(); scene.add("skin", Subsurface([1, 1, 1], 0.0, 40.0));')
    itp.run("scene.add(Sphere([0, 0, 0], 1.0), \"skin\");"
            "scene.add(Line([0, 0, 1], [0, 1, 1], 0.02), \"skin\");"
            "scene.add(SpotLight([0, 1, 0], [0, -1, 0], [1, 1, 1], 0.5));"
            "scene.set(Sky([1, 1, 1])); s := SobolSampler(4); h := HaltonSampler(4);")
    cs = itp.get_var("scene").compile("cpu")
    assert cs.has_subsurface and cs.env_light is not None and len(cs.lights) == 2
    # and so do the media slice's: CSG by the operators, media, AO and Vol
    itp.run('scene.add(Sphere([0, 0, 0], 1.0) - AABB([0, 0, 0], [1, 1, 1]), "skin");'
            "scene.add(HomoMedium(Sphere([0, 0, 0], 2.0), HgPF(0.2), [0.1, 0.1, 0.1], "
            "[0.2, 0.2, 0.2])); ao := AOIntegrator(UniformSampler(4));"
            "vol := VolIntegrator(UniformSampler(4));")
    cs = itp.get_var("scene").compile("cpu")
    assert len(cs.csg_shapes) == 1 and len(cs.media) == 1
    assert [type(itp.get_var(k)).__name__ for k in ("ao", "vol")] == ["AOIntegrator",
                                                                     "VolIntegrator"]


def test_cbox_script_builds_the_benchmark_box():
    """CBOX_PRL is bench.py's text; through the port's interpreter it gives
    scenes.cbox's arrays exactly, and pine_tpu's interpreter the same
    geometry (group rows compared by geometry id: the two SAH builds may
    order the cone lattice's leaves differently)."""
    import bench
    from pine_tpu.prl.interp import Interpreter as JInterpreter

    from pine_tpu_torch.convert import scene_arrays

    assert scenes.CBOX_PRL == bench.CBOX_PRL
    a = scene_arrays(scenes.prl_scene(scenes.CBOX_PRL))
    b = scene_arrays(scenes.cbox())
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith(".lattice"):
            assert (a[k] is None) == (b[k] is None), k
            for kk in a[k] or {}:
                np.testing.assert_array_equal(a[k][kk], b[k][kk], err_msg=f"{k}.{kk}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    itp = JInterpreter()
    itp.run(bench.CBOX_PRL, "<bench:cbox>")
    jscene = itp.get_var("scene")
    jcs = jscene.compile()
    for k in ("g_type", "g_local", "g_mat"):
        np.testing.assert_array_equal(a[k], np.asarray(getattr(jcs, k)), err_msg=k)
    for tid, table in jcs.tables.items():
        np.testing.assert_array_equal(a[f"table.{tid}"], np.asarray(table), err_msg=str(tid))
    for i, m in enumerate(jcs.materials):
        assert int(a[f"mat.{i}.tag"]) == m.tag
        for name in ("albedo", "color"):
            if hasattr(m, name):
                np.testing.assert_array_equal(
                    a[f"mat.{i}.{name}"], np.broadcast_to(np.asarray(getattr(m, name).value,
                                                                     np.float32), (3,)))
    assert int(a["n_lights"]) == len(jcs.lights) == 1
    assert int(a["light.0.gidx"]) == jcs.lights[0].global_idx
    np.testing.assert_array_equal(a["cam.rot"], np.asarray(jscene.camera.params()["rot"]))
    ent = np.asarray(jcs.unified["ent_gidx"])
    assert int(a["n_groups"]) == len(jcs.unified["groups"]) == 3
    for i, g in enumerate(jcs.unified["groups"]):
        assert (int(a[f"group.{i}.tid"]), a[f"group.{i}.rows"].shape) == (
            g["tid"], g["rows_np"].shape)
        assert (a[f"group.{i}.lattice"] is None) == (g.get("lattice") is None)
        b0, n = g["base"], len(g["_prim_aabbs"])
        rows_of = lambda rows, e: {int(x): rows[k] for k, x in enumerate(e[b0:b0 + n])}  # noqa: E731
        jr, pr = rows_of(g["rows_np"], ent), rows_of(a[f"group.{i}.rows"], a["ent_gidx"])
        assert jr.keys() == pr.keys()
        for gid in jr:
            np.testing.assert_array_equal(pr[gid], jr[gid])


def test_cone_forest_script():
    """CONE_FOREST_PRL: the box's floor at twice the density, 1,600 cones in
    one lattice group of 1,604 rows that takes the lattice traversal."""
    from pine_tpu_torch.accel.dense_traverse import group_variant

    cs = scenes.prl_scene(scenes.CONE_FOREST_PRL).compile("cpu")
    groups = cs.unified["groups"]
    assert [(g["tid"], g["rows"].shape[0]) for g in groups] == [(1, 6), (5, 2), (7, 1604)]
    assert [group_variant(g) for g in groups] == ["dense", "dense", "lattice"]
    lat = groups[2]["lattice"]
    assert (lat["ni"], lat["nj"], groups[2]["lat"]["max_seg"]) == (40, 40, 21)


TINY = """
scene := Scene();
scene.add(Rect([0, 8, 0], [1, 0, 0], [0, 0, 1]), Emissive([8, 8, 8]));
scene.add(Sphere([0, 0, 0], 0.5), Diffuse([0.8, 0.8, 0.8]));
scene.set(ThinLenCamera(Film([16, 12]), [0, 0, -3], [0, 0, 1], 0.35));
PathIntegrator(BlueSampler(4), 3).render(scene);
scene.camera.film().save('{out}');
println("rendered");
"""


def cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "pine_tpu_torch", *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


def test_cli_renders_on_the_cpu(tmp_path):
    from PIL import Image

    out = tmp_path / "tiny.png"
    (tmp_path / "tiny.pine").write_text(TINY.format(out=out))
    proc = cli("tiny.pine", "--platform", "cpu", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rendered" in proc.stdout and "Finished in" in proc.stdout.splitlines()[-1]
    lib = tmp_path / "lib.png"
    scene = scenes.prl_scene(TINY.split("PathIntegrator")[0])
    from pine_tpu_torch.core.samplers import BlueSampler
    from pine_tpu_torch.integrators.path import PathIntegrator

    PathIntegrator(BlueSampler(4), 3).render(scene, device="cpu").save(str(lib))
    got, want = np.asarray(Image.open(out)), np.asarray(Image.open(lib))
    assert got.shape == (12, 16, 3) and got.max() > 0
    np.testing.assert_array_equal(got, want)


def test_cli_refuses_without_a_card(tmp_path):
    (tmp_path / "s.pine").write_text('println("ran");\n')
    for args in (("--progressive", "4"), ("--interactive",), ("--platform", "tpu")):
        proc = cli("s.pine", *args, cwd=tmp_path)
        assert proc.returncode != 0 and "ran" not in proc.stdout
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform is valid here")
    proc = cli("s.pine", cwd=tmp_path)
    assert proc.returncode != 0 and "ran" not in proc.stdout
    assert "no CUDA device is available" in proc.stdout
    # scenes.prl_scene renders, if its script does, on the card too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenes.prl_scene(TINY.split("scene.camera")[0])


def test_bench_refuses_without_a_card(capsys):
    """``python -m pine_tpu_torch.bench`` renders on the card only: without one
    it exits with status 1 before it builds anything."""
    from pine_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs there")
    assert bench.main([]) == 1
    assert "no CUDA device is available" in capsys.readouterr().out
