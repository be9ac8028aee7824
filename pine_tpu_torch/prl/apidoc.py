"""Generate the PRL language reference from the port's live builtin
registry.  Counterpart of pine_tpu/prl/apidoc.py: the analogue of the
reference's hand-maintained API.pine (API.pine:1-131), kept truthful by
construction: every entry is introspected from the callables
`make_registry` actually registers, so the doc can never drift from the
language.  A builtin that is not ported yet says so (its ROADMAP.md item).

Run:  python -m pine_tpu_torch.prl.apidoc [> API.md]
"""
from __future__ import annotations

import inspect

# Grouping: name -> section.  Names absent here land in "Other utilities".
SECTIONS = [
    ("Math", """min max abs clamp lerp sqr sqrt floor ceil fract powi pow
     log2 log log10 exp sin cos tan acos asin atan2 tanh""".split()),
    ("Vectors & matrices", """normalize length distance dot cross
     coordinate_system rotate_x rotate_y rotate_z rotate translate scale
     lookat look_at identity3x3 identity4x4 transpose inverse determinant
     vec2 vec3 vec4 vec2i vec3i mat2 mat3 mat4""".split()),
    ("Random numbers", "RNG srand randf rand2f rand3f".split()),
    ("Arrays & images", """Array2df Array2d2f Array2d3f Array2d4f Array2d3u8
     Array2d4u8 draw save load_image mse rmse Image""".split()),
    ("Shapes", """AABB OBB Box Sphere Plane Disk Line Rect Cone Cylinder
     Triangle SDF Mesh heightmap Instancing""".split()),
    ("Materials", "Emissive Diffuse Metal Glossy Glass Subsurface Uber".split()),
    ("Texture nodes", """Position Normal UV Checkerboard Noisef Noise3f
     Texture Function pnoise pnoise2d pnoise3d fbm fbm2d fbm3d""".split()),
    ("Lights", """PointLight SpotLight DirectionalLight Sky Atmosphere
     ImageSky""".split()),
    ("Media", "HgPF Hg2PF CloudPF HomoMedium VDBMedium".split()),
    ("Camera & film", "ThinLenCamera Film Uncharted2 ACES film".split()),
    ("Samplers", "UniformSampler HaltonSampler SobolSampler BlueSampler".split()),
    ("Integrators", """AOIntegrator VolIntegrator RandomWalkIntegrator
     PathIntegrator CachedPathIntegrator GuidedPathIntegrator MltIntegrator
     RestirIntegrator MicroRenderGI denoise quick_render""".split()),
    ("Scene", "Scene load".split()),
    ("Runtime", "print println parallel_for parallel_for2d set_progress".split()),
]

LANGUAGE = """\
# PRL — Pine Rendering Language reference

A `.pine` file is a program: run it with `python -m pine_tpu_torch
file.pine` (on the CUDA card; `--platform cpu` for the CPU).
Scene-building code executes eagerly; lambdas passed to `draw`, `SDF`,
`Function` and `heightmap` run over a batch of lanes (tensors) on the
device the script renders on.

## Fundamental types

`bool` (`true`/`false`), integers (`-5`, `120`), floats (`3.14`),
strings (`'hello'` or `"hello"`), vectors (`[1.0, 2.0, 3.0]` builds a
vec3; `.x/.y/.z/.w` access components), matrices (`mat3`/`mat4` from
column vectors).  `#` starts a comment.

## Declarations and assignment

```
x := 5;          # declare
x = 6;           # assign (declares if new)
r &= other;      # reference-bind (alias)
```

## Control flow

```
for i = 0; i < 10; i++ { ... }   # C-style
for i in 0..10 { ... }           # range (inclusive)
for i in 0~3~10 { ... }          # from 0 to 10 step 3
while x < 4 { ... }
if x < 4 { ... } else if x < 10 { ... } else { ... }
```

Inside lambdas run over lanes these lower to masked loops and merged
branches, so data-dependent loops are allowed in SDFs and `draw`
fragments.  Hot host loops (`for` over 4,096 or more iterations, `while`
past 20,000) run as lanes or as a compiled Python function where the body
is pure.

## Functions, classes, lambdas

```
fn add(a: f32, b: f32): f32 { return a + b; }
class Agent {
    ctor Agent(x: f32) { self.x = x; }
    fn step(self): f32 { return self.x * 2; }
    x: f32;
}
f := (p: vec2): vec3 { return [p.x, p.y, 0.0]; };
```

## Operators

Arithmetic `+ - * / ^`, comparison `== != < <= > >=`, logical `&& ||
!`, compound `+= -= *= /= ++ --`.  `mat * vec` is matrix-vector
multiply; `vec * vec` is per-component.  CSG composes shapes: `a + b`
(union), `a * b` (intersection), `a - b` (difference).

## Constants

`Pi`, `E`, and the axis vectors `X`, `Y`, `Z`.

## Builtins
"""


def _sig(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return "(...)"
    parts = []
    for p in sig.parameters.values():
        if p.name in ("self", "interp"):
            continue
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            parts.append("*" + p.name)
        elif p.default is not inspect.Parameter.empty:
            parts.append(f"{p.name}={p.default!r}")
        else:
            parts.append(p.name)
    return "(" + ", ".join(parts) + ")"


def _one_liner(name, fn):
    from pine_tpu_torch.prl.builtins import UNPORTED

    if name in UNPORTED:
        return f"not ported yet (ROADMAP.md, modules item {UNPORTED[name]})"
    doc = inspect.getdoc(fn)
    if not doc:
        return ""
    return doc.strip().splitlines()[0].strip()


def generate():
    from pine_tpu_torch.prl.interp import Interpreter

    interp = Interpreter(out=lambda s: None, device="cpu")
    reg = dict(interp.builtins)
    out = [LANGUAGE]
    seen = set()
    for title, names in SECTIONS:
        rows = []
        for name in names:
            fn = reg.get(name)
            if fn is None:
                continue
            seen.add(name)
            desc = _one_liner(name, fn)
            rows.append(f"| `{name}{_sig(fn)}` | {desc} |")
        if rows:
            out.append(f"\n### {title}\n")
            out.append("| signature | |\n|---|---|")
            out.extend(rows)
    rest = sorted(set(reg) - seen)
    if rest:
        out.append("\n### Other utilities\n")
        out.append("| signature | |\n|---|---|")
        for name in rest:
            out.append(f"| `{name}{_sig(reg[name])}` | {_one_liner(name, reg[name])} |")
    out.append(
        "\n---\nGenerated by `python -m pine_tpu_torch.prl.apidoc` from the live"
        " builtin registry (pine_tpu_torch/prl/builtins.py)."
    )
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    print(generate(), end="")
