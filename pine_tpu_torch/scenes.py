"""Scenes built through the port's Scene API.

``instanced`` is the instancing benchmark of the repository's
``bench_instanced.py``: an n_side x n_side field of instances (1,024 at the
benchmark's 32) of one bumpy-ellipsoid rock of (rock_grid-1)^2 * 2 triangles
(4,802 at its 50), on a ground plane, under one emissive rect.  The rock's
vertices and indices and the instance transforms are the benchmark's to the
bit.  The benchmark's field realizes 4.9 M triangles, so it stays lazy
(scene.FLATTEN_LIMIT); smaller fields flatten unless that limit is lowered.

``terrain`` is the mesh benchmark of the repository's ``bench_mesh.py``: a
seeded fbm heightfield of (grid-1)^2 * 2 triangles (99,458 at the benchmark's
grid of 224), one emissive rect above it, a low camera in the valley.  Its
vertices and indices are bench_mesh's to the bit.

``cbox`` is the benchmark Cornell box of the repository's ``bench.py``
(``CBOX_PRL``): five walls, a floor field of cones, a diffuse box, a metal box
and one small emissive rect, seen by a ThinLenCamera.  The cone loops follow
the script's ``for x in a ~ step ~ b`` semantics (double-precision
accumulation, the bound inclusive), so the shapes match the script's to the
bit.

``CBOX_PRL`` is that script itself, character for character, and
``CONE_FOREST_PRL`` the same box with its cone floor at twice the density
(``cone_forest_prl``): 40 x 40 = 1,600 cones of half the size over the same
extent, one lattice group of more than 512 prims, so it takes the lattice
traversal.  ``prl_scene`` runs such a script through the port's PRL
interpreter and returns its ``scene``.

``GARDEN_PRL`` is an outdoor scene that runs the rest of the scene model: a
640x640 film under an ``Atmosphere`` with ``SobolSampler(16)``, depth 5;
a large ground rect whose albedo is a ``Checkerboard`` of ``Position()``;
the bench box's 420 cones (one 424-row group, the dense kernel) whose
albedo is ``Noise3f`` of the position; a ``Subsurface`` sphere (the
random walk), a ``Glass`` sphere and a ``Metal`` sphere whose roughness is
built from ``Noisef``, ``Vec3``, ``Comp`` and ``lerp``; a fence of 24
``Line``s of thickness 0.02 (the "plain" route); a ``SpotLight``.  It
renders and saves ``garden.png`` in the working directory.
``garden_prl`` gives it with the sky, sampler, film, spp and depth a caller
asks: garden-imagesky (``garden_prl("imagesky", "HaltonSampler")``: an
``ImageSky`` of the repository's images/cbox0.png, by absolute path) and
the ``Sky`` variant, and their reduced sizes (``REDUCED_GARDEN``: the film,
spp and depth cut, as chip_smoke.py's phase 3 renders them).

``house`` is the repository's ``scenes/house.pine``: ``assets/house.glb``
(ten mesh primitives, 4,020 triangles in one triangle group, textured and
factor-only Uber materials, an emissive window) under one DirectionalLight,
rendered by ``CachedPathIntegrator(BlueSampler(128), 5, 128)`` at 640x640.
``house_prl`` gives that script with the asset's path made absolute and the
film size, the render line and the save cut as a caller asks.
"""
from __future__ import annotations

import os

import numpy as np

from pine_tpu_torch.core.camera import ThinLenCamera
from pine_tpu_torch.core.film import Film
from pine_tpu_torch.core.vecmath import rotate_y, scale, translate
from pine_tpu_torch.scene import materials as M
from pine_tpu_torch.scene import shapes as S
from pine_tpu_torch.scene.scene import Scene

# the benchmark's cone field, as (begin, step, end) of its two loops
CONES_X = (-1.0, 0.1, 1.0)
CONES_Z = (0.0, 0.1, 2.0)

CBOX_PRL = """
scene := Scene();
image_size := [640, 640];

scene.add("floor", Diffuse([0.9, 0.9, 0.9]));
scene.add("red", Diffuse([0.9, 0.1, 0.05]));
scene.add("green", Diffuse([0.2, 0.9, 0.05]));
scene.add("metal", Metal([1, 1, 1], 0.0));
scene.add("glossy", Glossy([1, 1, 1] / 4.0, 0.05));
scene.add("skin", Subsurface([1, 1, 1], 0.0, 40.0));

scene.add(Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor");
scene.add(Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red");
scene.add(Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green");
scene.add(Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor");

for x in -1.0 ~ 0.1 ~ 1.0 {
    for z in 0.0 ~ 0.1 ~ 2.0 {
        scene.add(Cone([x, 0, z], Y, 0.05, 0.05), "floor");
    }
}
scene.add(Box(AABB([0, 0, 0], [1, 1, 1]), translate([0.0, 0.0, 0.6]) * rotate_y(0.4) * scale([0.6, 0.6, 0.6])), "floor");
scene.add(Box(AABB([0, 0, 0], [1, 1, 1]), translate([-0.6, 0.0, 1.0]) * rotate_y(-0.4) * scale([0.6, 1.3, 0.6])), "metal");

scene.add(Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]), Emissive(600 * [1.0, 0.64, 0.185]));

scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 1, -4], [0, 1, 0], 0.25));
"""

# the cone forest: the benchmark box's floor at twice the density
FOREST_X = (-1.0, 0.05, 1.0)
FOREST_Z = (0.0, 0.05, 2.0)
# cut to 24 x 24 = 576 cones in the middle of the floor (as the reduced box's
# field): still over 512, so still the lattice traversal
REDUCED_FOREST = ((-0.6, 0.05, 0.56), (0.5, 0.05, 1.66))


def cone_forest_prl(forest_x=FOREST_X, forest_z=FOREST_Z, size=640):
    """CBOX_PRL with the cone loops over ``forest_x`` and ``forest_z``
    (begin, step, end), cones of radius 0.025 and height 0.05, and the film
    ``size`` pixels square."""
    (x0, dx, x1), (z0, dz, z1) = forest_x, forest_z
    src = CBOX_PRL
    for old, new in (("-1.0 ~ 0.1 ~ 1.0", f"{x0} ~ {dx} ~ {x1}"),
                     ("0.0 ~ 0.1 ~ 2.0", f"{z0} ~ {dz} ~ {z1}"),
                     ("Cone([x, 0, z], Y, 0.05, 0.05)", "Cone([x, 0, z], Y, 0.025, 0.05)"),
                     ("image_size := [640, 640];", f"image_size := [{size}, {size}];")):
        assert old in src, old
        src = src.replace(old, new)
    return src


CONE_FOREST_PRL = cone_forest_prl()


def prl_scene(src, name="<script>", device=None):
    """The ``scene`` a PRL scene script builds, through the port's interpreter.
    Building runs on the host; a script that also renders does so on
    ``device``, or where ``core.options.device`` says, the card unless the
    caller set "cpu"."""
    from pine_tpu_torch.prl.interp import Interpreter

    itp = Interpreter(device=device)
    itp.run(src, name)
    return itp.get_var("scene")


def prl_range(begin, step, end):
    """Values of ``for v in begin ~ step ~ end``: ``v += step`` in double
    precision while ``v <= end``."""
    out = []
    v = float(begin)
    while v <= end:
        out.append(v)
        v += step
    return out


def cbox(size=(640, 640), cones_x=CONES_X, cones_z=CONES_Z):
    """The benchmark Cornell box at film ``size`` (width, height)."""
    scene = Scene()
    scene.add("floor", M.Diffuse([0.9, 0.9, 0.9]))
    scene.add("red", M.Diffuse([0.9, 0.1, 0.05]))
    scene.add("green", M.Diffuse([0.2, 0.9, 0.05]))
    scene.add("metal", M.Metal([1, 1, 1], 0.0))
    scene.add("glossy", M.Glossy(np.float32([1, 1, 1]) / np.float32(4.0), 0.05))
    scene.add("skin", M.Subsurface([1, 1, 1], 0.0, 40.0))  # declared, unused

    scene.add(S.Rect([0, 0, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([0, 2, 1], [2, 0, 0], [0, 0, 2]), "floor")
    scene.add(S.Rect([-1, 1, 1], [0, 0, 2], [0, 2, 0]), "red")
    scene.add(S.Rect([1, 1, 1], [0, 0, 2], [0, 2, 0]), "green")
    scene.add(S.Rect([0, 1, 2], [2, 0, 0], [0, 2, 0]), "floor")

    for x in prl_range(*cones_x):
        for z in prl_range(*cones_z):
            scene.add(S.Cone([x, 0, z], [0, 1, 0], 0.05, 0.05), "floor")
    unit = S.BoxAABB([0, 0, 0], [1, 1, 1])
    scene.add(S.BoxOBB(unit, translate([0.0, 0.0, 0.6]) @ rotate_y(0.4) @ scale([0.6, 0.6, 0.6])),
              "floor")
    scene.add(S.BoxOBB(unit, translate([-0.6, 0.0, 1.0]) @ rotate_y(-0.4) @ scale([0.6, 1.3, 0.6])),
              "metal")
    scene.add(S.Rect([0.0, 1.9, 0.5], [0.1, 0, 0], [0, 0, 0.1]),
              M.Emissive(np.float32(600) * np.float32([1.0, 0.64, 0.185])))
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0, 1, -4], [0, 1, 0], 0.25))
    return scene


TERRAIN_GRID = 224  # bench_mesh.py's GRID: 99,458 triangles


def make_terrain(grid=TERRAIN_GRID, size=8.0, amp=1.2, seed=7):
    """Deterministic fbm heightfield mesh -> (vertices (grid^2,3), indices)."""
    xs = np.linspace(-size / 2, size / 2, grid, dtype=np.float32)
    zs = np.linspace(0.0, size, grid, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="xy")
    rng = np.random.default_rng(seed)
    Y = np.zeros_like(X)
    for octave in range(5):
        f = 2.0 ** octave
        ph = rng.uniform(0, 2 * np.pi, 4)
        Y += (amp / f) * (
            np.sin(f * X * 1.3 + ph[0]) * np.cos(f * Z * 0.9 + ph[1])
            + 0.5 * np.sin(f * (X + Z) * 0.7 + ph[2]) * np.cos(f * (X - Z) * 1.1 + ph[3])
        )
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid, dtype=np.uint32).reshape(grid, grid)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).astype(np.uint32)
    return V, F


ROCK_GRID = 50  # bench_instanced.py's GRID: 4,802 triangles per rock
ROCK_SIDE = 32  # bench_instanced.py's N_SIDE: 1,024 instances


def make_rock(grid=ROCK_GRID):
    """Bumpy ellipsoid mesh -> (vertices (grid^2, 3), indices)."""
    th = np.linspace(0, np.pi, grid, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, grid, dtype=np.float32)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.25 * (np.sin(3 * T + 1.3) * np.cos(4 * P)
                      + 0.5 * np.sin(7 * T) * np.sin(5 * P + 0.7))
    V = np.stack([r * np.sin(T) * np.cos(P), 0.8 * r * np.cos(T), r * np.sin(T) * np.sin(P)],
                 axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(grid * grid, dtype=np.uint32).reshape(grid, grid)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).astype(np.uint32)
    return V, F


def rock_transforms(n_side=ROCK_SIDE, seed=11):
    """The field's instance transforms, row-major over (i, j): a random
    scale in [0.35, 0.6), resting on the ground, on a jittered 1.6 grid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_side):
        for j in range(n_side):
            m = np.eye(4, dtype=np.float32)
            s = 0.35 + 0.25 * rng.random()
            m[:3, :3] *= s
            m[0, 3] = (i - n_side / 2) * 1.6 + rng.uniform(-0.3, 0.3)
            m[1, 3] = 0.8 * s
            m[2, 3] = j * 1.6 + 2.0 + rng.uniform(-0.3, 0.3)
            out.append(m)
    return out


def instanced(size=(512, 512), n_side=ROCK_SIDE, rock_grid=ROCK_GRID):
    """The instancing benchmark's scene at film ``size``; ``n_side`` and
    ``rock_grid`` cut the field and the rock."""
    V, F = make_rock(rock_grid)
    scene = Scene()
    scene.add(S.Plane([0, -0.1, 0], [0, 1, 0]), M.Diffuse([0.55, 0.5, 0.45]))
    inst = S.InstancedShape(S.Mesh(V, F))
    mat = M.Diffuse([0.6, 0.55, 0.5])
    for m in rock_transforms(n_side):
        inst.add(m, mat)
    scene.add(inst)
    scene.add(S.Rect([0, 30, 20], [6, 0, 0], [0, 0, 6]),
              M.Emissive(np.asarray([400.0, 390.0, 360.0], np.float32)))
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0.0, 6.0, -6.0], [0.0, 0.5, 14.0], 0.7))
    return scene


def terrain(size=(640, 640), grid=TERRAIN_GRID):
    """The mesh benchmark's scene at film ``size``; ``grid`` cuts the mesh."""
    V, F = make_terrain(grid)
    scene = Scene()
    scene.add("ground", M.Diffuse([0.75, 0.7, 0.6]))
    scene.add(S.Mesh(V, F), "ground")
    scene.add(S.Rect([0.0, 6.0, 4.0], [1.5, 0, 0], [0, 0, 1.5]),
              M.Emissive(np.asarray([300.0, 290.0, 260.0], np.float32)))
    # the camera sits low in the valley, so the mesh fills the frame
    hmax = float(V[:, 1].max())
    scene.set(ThinLenCamera(Film(size, "uncharted2"), [0.0, hmax * 0.55, 0.8],
                            [0.5, 0.2, 5.5], 0.7))
    return scene


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOUSE_PINE = os.path.join(ROOT, "scenes", "house.pine")
HOUSE_GLB = os.path.join(ROOT, "assets", "house.glb")
HOUSE_INTEGRATOR = "CachedPathIntegrator(BlueSampler(128), 5, 128)"


def house_prl(size=640, integrator=HOUSE_INTEGRATOR, save=None):
    """``scenes/house.pine`` with its GLB read from the checkout by absolute
    path, the film ``size`` pixels square, ``integrator`` (a PRL expression)
    rendering the scene, or no render for None, and the film saved to
    ``save``, or not saved for None (the script saves to
    images/house3.png)."""
    with open(HOUSE_PINE) as f:
        src = f.read()
    render = "" if integrator is None else f"{integrator}.render(scene);"
    save_line = "" if save is None else f"scene.camera.film().save({save!r});"
    for old, new in (('scene.load("assets/house.glb")', f"scene.load({HOUSE_GLB!r})"),
                     ("image_size := [640, 640]", f"image_size := [{size}, {size}]"),
                     (f"{HOUSE_INTEGRATOR}.render(scene);", render),
                     ('scene.camera.film().save("images/house3.png");', save_line)):
        assert old in src, old
        src = src.replace(old, new)
    return src


def house(size=640, integrator=None, device=None):
    """The house scene built (and, with ``integrator``, rendered into its
    film on ``device``, default the card) through the port's interpreter."""
    return prl_scene(house_prl(size, integrator), "<house>", device)


GARDEN_PRL = """
scene := Scene();
image_size := [640, 640];

scene.add("ground", Diffuse(lerp(Checkerboard(Position() * 2.0 + [0.0, 0.25, 0.0]), [0.3, 0.42, 0.18], [0.55, 0.6, 0.35])));
scene.add("floor", Diffuse(Noise3f(Position() * 4.0, 4)));
scene.add("skin", Subsurface([0.9, 0.6, 0.5], 0.0, 40.0));
scene.add("glass", Glass([1, 1, 1], 0.0, 1.5));
scene.add("metal", Metal([0.95, 0.8, 0.55], lerp(Comp(Vec3(Noisef(Position() * 3.0, 3)), 0), 0.05, 0.5)));
scene.add("wood", Diffuse([0.45, 0.3, 0.18]));

scene.add(Rect([0, 0, 4], [40, 0, 0], [0, 0, 40]), "ground");
for x in -1.0 ~ 0.1 ~ 1.0 {
    for z in 0.0 ~ 0.1 ~ 2.0 {
        scene.add(Cone([x, 0, z], Y, 0.05, 0.05), "floor");
    }
}
scene.add(Sphere([-0.7, 0.35, 2.6], 0.35), "skin");
scene.add(Sphere([0.0, 0.3, 2.9], 0.3), "glass");
scene.add(Sphere([0.75, 0.4, 2.7], 0.4), "metal");
for i in 0..12 {
    x := -2.2 + 0.4 * i;
    scene.add(Line([x, 0, 3.6], [x, 0.8, 3.6], 0.02), "wood");
    scene.add(Line([x, 0.55, 3.6], [x + 0.4, 0.55, 3.6], 0.02), "wood");
}

scene.set(Atmosphere([0.4, 0.5, -0.6], [1, 1, 1]));
scene.add(SpotLight([0.0, 3.0, 0.5], [0.0, -1.0, 0.6], [12, 11, 9], 0.35, 0.1));
scene.set(ThinLenCamera(Film(image_size, Uncharted2()), [0, 2.4, -1.2], [0, 0.2, 2.0], 0.4));

PathIntegrator(SobolSampler(16), 5).render(scene);
scene.camera.film().save("garden.png");
"""

IMAGESKY_PNG = os.path.join(ROOT, "images", "cbox0.png")
ATMOSPHERE = "Atmosphere([0.4, 0.5, -0.6], [1, 1, 1])"
SKIES = {"atmosphere": ATMOSPHERE,
         "imagesky": f"ImageSky(load_image({IMAGESKY_PNG!r}))",
         "sky": "Sky([1, 1, 1])"}
# the reduced garden of the tests and phase 3: film, spp and depth cut
REDUCED_GARDEN = dict(size=32, spp=4, depth=3)


def garden_prl(sky="atmosphere", sampler="SobolSampler", size=640, spp=16, depth=5,
               integrator="PathIntegrator", save="garden.png"):
    """GARDEN_PRL under ``sky`` (a key of SKIES), rendered by ``integrator``
    (a PRL name taking (sampler, depth), or None for no render) with
    ``sampler`` (a PRL sampler name) at ``spp`` and ``depth`` on a film
    ``size`` pixels square, saved to ``save`` (None: not saved)."""
    render = "" if integrator is None else f"{integrator}({sampler}({spp}), {depth}).render(scene);"
    save_line = "" if save is None else f"scene.camera.film().save({save!r});"
    src = GARDEN_PRL
    for old, new in (("image_size := [640, 640];", f"image_size := [{size}, {size}];"),
                     (f"scene.set({ATMOSPHERE});", f"scene.set({SKIES[sky]});"),
                     ("PathIntegrator(SobolSampler(16), 5).render(scene);", render),
                     ('scene.camera.film().save("garden.png");', save_line)):
        assert old in src, old
        src = src.replace(old, new)
    return src



def garden(sky="atmosphere", size=640):
    """The garden's scene under ``sky`` (a key of SKIES) on a film ``size``
    pixels square, built (not rendered) through the port's interpreter."""
    return prl_scene(garden_prl(sky, size=size, integrator=None, save=None), "<garden>")
