"""Script lambdas over lanes and their data-dependent control flow
(pine_tpu_torch/prl/trace_flow.py, the interpreter's bridges) against
pine_tpu.

1. The draw() scripts of tests/test_prl.py (a plain fragment, a loop with
   ``mat2``, the per-lane halving ``while``, a ``while`` against its host
   replay, the ``if``/``else if``/``else`` merge, every branch returning) run
   through both interpreters at 8x8 and 16x16: the port's image equals
   pine_tpu's to rtol 1e-6 (atol 1e-7), pine_tpu's jitted draw as written.
   The port's masked loop, with its compaction of finished lanes and its
   check every EXIT_CHECK iterations, equals the same loop checked and
   stepped on every lane each iteration, bit for bit.
2. The error cases: ``break`` in a traced loop and an early ``return`` in
   one branch of a traced ``if`` raise PRLRuntimeError with pine_tpu's
   text; so does a variable that changes type in a traced loop.
3. An SDF whose distance iterates data-dependently (tests/test_prl.py's
   convergence loop, a traced ``while`` and a traced ``if``) renders at
   16x16, UniformSampler(4), depth 2 on the CPU as pine_tpu's compiled
   scene carried across with the port's lambda (test_torch_render's rule).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

DRAW = {
    "plain": """
img := draw([8, 8], (u: vec2): vec3 {
    return [u.x, u.y, 0.5];
});
""",
    "loop_mat2": """
img := draw([16, 16], (u: vec2): vec3 {
    acc = 0.0;
    for i in 0..3 {
        m = mat2([0.0, 1.0], [-1.0, 0.0]);
        u = m * u;
        acc += u.x;
    }
    return vec3(acc);
});
""",
    "while_per_lane": """
img := draw([8, 8], (u: vec2): vec3 {
    x := u.x + 0.01;
    n := 0.0;
    while x > 0.1 {
        x = x / 2.0;
        n += 1.0;
    }
    return [n / 8.0, x, 0.0];
});
""",
    "while_replay": """
img := draw([16, 16], (u: vec2): vec3 {
    t := 0.0;
    i := 0.0;
    while t < 1.0 {
        t += 0.3 * (u.x + 0.2);
        i += 1.0;
    }
    return [t, i, 0.0];
});
""",
    "if_merge": """
img := draw([8, 8], (u: vec2): vec3 {
    c := 0.0;
    if u.x < 0.5 {
        c = 1.0;
    } else if u.y < 0.5 {
        c = 2.0;
    } else {
        c = 3.0;
    }
    return vec3(c / 3.0);
});
""",
    "all_return": """
img := draw([16, 16], (u: vec2): vec3 {
    if u.x < 0.5 {
        return [1.0, 0.0, 0.0];
    } else {
        return [0.0, 1.0, 0.0];
    }
});
""",
}

ERRORS = {
    "mixed_return": """
img := draw([4, 4], (u: vec2): vec3 {
    if u.x < 0.5 {
        return [1.0, 0.0, 0.0];
    }
    return [0.0, 1.0, 0.0];
});
""",
    "break": """
img := draw([4, 4], (u: vec2): vec3 {
    x := u.x;
    while x < 4.0 {
        x += 1.0;
        if x > 2.0 {
            break;
        }
    }
    return vec3(x);
});
""",
    "type_change": """
img := draw([4, 4], (u: vec2): vec3 {
    n := 0;
    x := u.x;
    while x < 1.0 {
        x += 0.25;
        n += 0.5;
    }
    return vec3(x);
});
""",
}


def port_image(src):
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device="cpu")
    itp.run(src)
    return np.asarray(itp.get_var("img").host())


def jax_image(src):
    from pine_tpu.prl.interp import Interpreter as JInterp

    itp = JInterp(out=lambda s: None)
    itp.run(src)
    return np.asarray(itp.get_var("img").data)


@pytest.mark.parametrize("name", list(DRAW))
def test_draw_matches_pine_tpu(name):
    got, want = port_image(DRAW[name]), jax_image(DRAW[name])
    assert got.shape == want.shape and got.shape[:2] in ((8, 8), (16, 16))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["while_per_lane", "while_replay"])
def test_masked_loop_compaction_and_checks_are_exact(name, monkeypatch):
    from pine_tpu_torch.prl import trace_flow

    base = port_image(DRAW[name])
    monkeypatch.setattr(trace_flow, "COMPACT", False)
    monkeypatch.setattr(trace_flow, "EXIT_CHECK", 1)
    assert np.array_equal(port_image(DRAW[name]), base)


@pytest.mark.parametrize("name", list(ERRORS))
def test_traced_errors_match_pine_tpu(name):
    from pine_tpu.prl.interp import Interpreter as JInterp
    from pine_tpu.prl.interp import PRLRuntimeError as JErr

    from pine_tpu_torch.prl.interp import Interpreter, PRLRuntimeError

    with pytest.raises(JErr) as je:
        JInterp(out=lambda s: None).run(ERRORS[name])
    with pytest.raises(PRLRuntimeError) as pe:
        Interpreter(device="cpu").run(ERRORS[name])
    key = {"mixed_return": "every branch", "break": "not supported",
           "type_change": "changed shape/dtype"}[name]
    assert key in str(pe.value) and key in str(je.value)
    # the same text, but for the dtype names of the two libraries
    strip = lambda s: s.split("(")[0]  # noqa: E731
    assert strip(str(pe.value)) == strip(str(je.value))


SDF_SCENE = """
scene := Scene();
scene.add(Rect([0, 3, 0], [2, 0, 0], [0, 0, 2]), Emissive([8, 8, 8]));
scene.add(SDF([0, 0, 0], [1, 1, 1], (p: vec3): f32 {
    # start from a sphere estimate and sharpen it iteratively
    d := length(p) - 0.6;
    k := 0.0;
    while k < 3.0 {
        d = d * 0.5 + (length(p) - 0.6) * 0.5;
        k += 1.0;
    }
    if d > 0.5 {
        d = d * 0.75 + 0.125;
    }
    return d;
}), Diffuse([0.8, 0.4, 0.3]));
scene.set(ThinLenCamera(Film([16, 16]), [0, 0.4, -3], [0, 0, 0], 0.5));
"""


def test_sdf_with_traced_loop_renders_as_pine_tpu():
    from pine_tpu.core.samplers import UniformSampler as JUniform
    from pine_tpu.integrators.path import render_wavefront as jax_render
    from pine_tpu.prl.interp import Interpreter as JInterp
    from test_torch_csg import carried_arrays
    from test_torch_render import assert_renders_agree

    from pine_tpu_torch.convert import compiled_scene_from_arrays
    from pine_tpu_torch.core.samplers import UniformSampler
    from pine_tpu_torch.integrators.path import render_wavefront
    from pine_tpu_torch.prl.interp import Interpreter

    jitp = JInterp(out=lambda s: None)
    jitp.run(SDF_SCENE)
    scene = jitp.get_var("scene")
    jcs = scene.compile()
    pitp = Interpreter(device="cpu")
    pitp.run(SDF_SCENE)
    a = carried_arrays(jcs, scene.camera)
    a["sdf.0"].fn = pitp.get_var("scene").geometries[1][0].fn  # the port's lambda
    pcs = compiled_scene_from_arrays(a, "cpu")
    want, jst = jax_render(jcs, scene.camera, 16, 16, JUniform(4), 4, 2, return_stats=True)
    got, pst = render_wavefront(pcs, None, 16, 16, UniformSampler(4), 4, 2, return_stats=True)
    assert (np.asarray(want) > 0).any()
    assert_renders_agree(got.numpy(), np.asarray(want), pst["traced_rays"],
                         float(jst["traced_rays"]))
